"""The per-layer readers of the program's own counters and spans: each
gives a planted value on a hand-made run and None where the run has nothing
to read (another driver, no trace, a program without the counters or the
ring, a ring that no longer reaches back to the traced stretch)."""

from __future__ import annotations

import json
from collections import deque

import pytest

from portbench import program_spans
from portbench.harness import registry
from portbench.harness.registry import ROOT, module
from portbench.harness.trace import WINDOW, Trace

NEW = ("serve.queue_wait_s", "serve.decode_device_s_per_batch", "serve.collect_idle_share",
       "sampler.idle_ms_per_step.batch")


def reader(name):
    return module(ROOT / "metrics" / f"{name}.py")


class Run:
    def __init__(self, spans, trace=None):
        self.spans = spans
        self.trace = trace


@pytest.fixture
def ring(monkeypatch):
    """The program's ring, empty, for planted spans."""
    from jen1_tpu_torch.utils import profiling

    planted = deque(maxlen=profiling.RING_SPANS)
    monkeypatch.setattr(profiling, "_ring", planted)
    return planted


def test_the_new_readers_are_found_and_declared():
    found = {m.NAME: m for m in registry.metrics()}
    entries = {e["name"]: e for e in json.loads((ROOT.parent / "BENCHMARK.json")
                                                .read_text())["per_layer"]}
    for name in NEW:
        m, e = found[name], entries[name]
        assert (m.UNIT, m.LAYER, m.SOURCE, m.MOVES) == (e["unit"], e["layer"], e["source"],
                                                       e["moves"])
    assert entries["sampler.idle_ms_per_step.batch"]["workloads"] == ["flagship-batch"]


def serve_counters(**after):
    stats0 = {"batches": 10, "batched_requests": 30}
    phases0 = {"queue_wait": 12.0, "decode_device": 0.5}
    stats1 = {"batches": 14, "batched_requests": 38, **after.pop("stats", {})}
    phases1 = {"queue_wait": 28.0, "decode_device": 0.7, **after}
    return dict(driver="serve", stats=(stats0, stats1), phases=(phases0, phases1))


def test_queue_wait_and_decode_device_over_the_window():
    run = Run(serve_counters())
    assert reader("serve.queue_wait_s").read(run) == pytest.approx(16.0 / 8)
    assert reader("serve.decode_device_s_per_batch").read(run) == pytest.approx(0.2 / 4)


@pytest.mark.parametrize("name", NEW[:2])
def test_counter_readers_read_nothing_without_the_counters(name):
    r = reader(name)
    parent = dict(driver="serve", stats=({"batches": 1}, {"batches": 3}),
                  phases=({"fetch": 0.1}, {"fetch": 0.3}))
    assert r.read(Run(parent)) is None
    assert r.read(Run(dict(driver="generate", batches=[{}], steps=3))) is None
    idle = serve_counters(stats={"batches": 10, "batched_requests": 30})
    assert r.read(Run(idle)) is None


def serve_trace():
    tr = Trace()
    tr.host = [(1_000, 11_000, WINDOW), (0, 12_000, "other")]
    tr.device = [(500, 2_500, "k"), (1_500, 2_500, "k"), (4_000, 5_000, "k"),
                 (5_500, 6_000, "k"), (10_200, 10_700, "k"), (10_500, 12_500, "k")]
    tr._clip()  # as Trace.of keeps it: the operations wholly inside the window
    return tr


def test_collect_idle_share_planted(ring):
    # collect spans, cut to the window [1000, 11000): [1000, 3000) busy
    # 1500-2500, idle 1000; [3000, 7000) busy 1500, idle 2500; [10000,
    # 11000) busy 10200-10700, idle 500
    for s, e in ((0, 3_000), (3_000, 7_000), (10_000, 12_000)):
        ring.append(("serve.collect", s, e, 1, 0))
    ring.append(("serve.dispatch", 7_000, 10_000, 1, 0))
    share = reader("serve.collect_idle_share").read(Run(dict(driver="serve"), serve_trace()))
    assert share == pytest.approx(4_000 / 10_000)


def test_collect_idle_share_reads_nothing_without_a_ring(ring, monkeypatch):
    from jen1_tpu_torch.utils import profiling

    r = reader("serve.collect_idle_share")
    assert r.read(Run(dict(driver="serve"), None)) is None
    # a full ring whose oldest span is after the stretch began
    ring.extend(("serve.collect", 5_000 + i, 5_001 + i, 1, 0) for i in range(ring.maxlen))
    assert r.read(Run(dict(driver="serve"), serve_trace())) is None
    # its oldest span began before the stretch but ended in it: a shorter
    # span of the stretch, which ended earlier, may have been dropped
    ring.append(("serve.request", 0, 1_500, 1, 0))
    ring.rotate(1)
    assert r.read(Run(dict(driver="serve"), serve_trace())) is None
    # one that ended before the stretch: nothing of the stretch was dropped
    ring[0] = ("serve.request", 0, 900, 1, 0)
    assert r.read(Run(dict(driver="serve"), serve_trace())) is not None
    monkeypatch.delattr(profiling, "spans")
    assert r.read(Run(dict(driver="serve"), serve_trace())) is None


def batch_trace():
    tr = Trace()
    tr.host = [(0, 20_000, "aten::op"), (19_000, 21_000, "cudaDeviceSynchronize")]
    tr.device = [(1_000, 4_000, "k"), (4_500, 7_000, "k"), (7_200, 9_500, "k"),
                 (12_000, 13_000, "k")]
    tr.window_s = 21_000 / 1e9
    return tr


def test_sampler_idle_per_step_planted(ring):
    # the sampler phase 2000-10000 on thread 7, steps at 2000, 4000, 7000:
    # idle in [2000, 4000) 0, in [4000, 7000) 500, in [7000, 10000) 200 + 500
    ring.append(("gen.conditioner", 0, 2_000, 7, None))
    for i, s in enumerate((2_000, 4_000, 7_000)):
        ring.append(("sampler.step", s, s + 100, 7, i))
    ring.append(("sampler.step", 3_000, 3_100, 8, 0))  # another thread's sampler
    ring.append(("gen.sampler", 2_000, 10_000, 7, None))
    value = reader("sampler.idle_ms_per_step.batch").read(
        Run(dict(driver="generate"), batch_trace()))
    assert value == pytest.approx(1_200 / 1e6 / 3)


def test_sampler_idle_reads_nothing_without_steps(ring):
    r = reader("sampler.idle_ms_per_step.batch")
    run = Run(dict(driver="generate"), batch_trace())
    assert r.read(run) is None  # an empty ring: no sampler phase
    ring.append(("gen.sampler", 2_000, 10_000, 7, None))
    assert r.read(run) is None  # a phase without steps (an eager sampler of old)
    assert r.read(Run(dict(driver="serve"), batch_trace())) is None
    assert r.read(Run(dict(driver="generate"), None)) is None


def test_idle_of_overlapping_intervals_and_operations():
    device = [(0, 10, "a"), (5, 20, "b"), (30, 40, "c")]
    assert program_spans.idle_ns([(0, 50)], device) == 20
    assert program_spans.idle_ns([(15, 35), (25, 45)], device) == 30 - 5 - 10
    assert program_spans.clip([(0, 5), (8, 20)], 6, 12) == [(8, 12)]


def test_a_tiny_served_run_reads_its_queue_wait(tmp_path):
    """The whole serve driver at test widths on the CPU: the queue wait is
    read from the program's counters; the decode's device time and the
    trace readers have nothing to read there."""
    import time

    from portbench.harness import core
    from portbench.harness.registry import Cell
    from portbench.tests.portbench_tiny import tiny_root

    cell = Cell("tiny", tiny_root(tmp_path, limit=0.035, driver="serve"))
    run = cell.driver.run(cell, 2**33 + 7, 2.0, False, "cpu", time.perf_counter())
    out = core.result(run, cell, True, {"platform": "cpu"}, cell.driver.UNITS)
    assert out["metrics"]["serve.queue_wait_s"]["value"] > 0
    assert not set(NEW[1:]) & set(out["metrics"])
