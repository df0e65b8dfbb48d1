"""The port's span ring (jen1_tpu_torch/utils/profiling.py) and the spans
the program keeps in it: bounded, stamped on the profiler's clock, one
span per `annotate` with its thread and key; a tiny CPU `generate()`
leaves one `sampler.step` per step and one `gen.<phase>` per
`last_timings` phase over the interval that phase's timing covers; the
loader's wait for its prefetch thread is a `data.wait` span per batch.
"""

import sys
import threading
import time

import pytest
import torch

from jen1_tpu_torch.utils import profiling
from test_torch_serve import SR, tiny_config
from torch_port_util import one_torch_thread

PHASES = ("prep", "encode", "conditioner", "assemble", "sampler", "decode", "fetch")
STEPS = 3


def named(spans, name):
    return [s for s in spans if s[0] == name]


# ---------------------------------------------------------------- the ring


def test_ring_is_bounded_and_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(profiling, "_ring", type(profiling._ring)(maxlen=profiling.RING_SPANS))
    for i in range(profiling.RING_SPANS + 10):
        with profiling.annotate("fill", key=i):
            pass
    spans = profiling.spans()
    assert len(spans) == profiling.RING_SPANS == 65_536
    assert spans[0][4] == 10 and spans[-1][4] == profiling.RING_SPANS + 9


def test_annotate_records_name_key_thread_and_nesting():
    t0 = time.time_ns()
    with profiling.annotate("outer", key="batch-7"):
        with profiling.annotate("inner", key=3):
            time.sleep(0.002)
    t1 = time.time_ns()
    (outer,), (inner,) = named(profiling.spans(t0), "outer"), named(profiling.spans(t0), "inner")
    assert outer[3] == inner[3] == threading.get_ident()
    assert (outer[4], inner[4]) == ("batch-7", 3)
    # the parent is the span of the same thread that encloses it
    assert t0 <= outer[1] <= inner[1] < inner[2] <= outer[2] <= t1
    assert inner[2] - inner[1] >= 2_000_000


def test_annotate_records_a_span_that_raised():
    t0 = time.time_ns()
    with pytest.raises(ValueError):
        with profiling.annotate("raises"):
            raise ValueError("x")
    assert len(named(profiling.spans(t0), "raises")) == 1


def test_spans_since_keeps_the_later_ones():
    with profiling.annotate("early"):
        pass
    t0 = time.time_ns()
    with profiling.annotate("late"):
        pass
    later = profiling.spans(since_ns=t0)
    assert named(later, "late") and not named(later, "early")


def test_ring_and_profiler_share_a_clock():
    """A span's ring stamp and the profiler's event for the same annotate
    start within 1 ms: the ring joins a trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        with profiling.annotate("clocked"):
            torch.ones(16).sum()
    (ring,) = named(profiling.spans(t0), "clocked")
    (event,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "clocked"]
    assert abs(event.start_ns() - ring[1]) < 1_000_000


def test_annotate_enters_a_region_only_while_a_profiler_records(monkeypatch):
    """With no profiler recording, a span makes no call into torch; under
    one it is a `record_function` region, as before the ring."""
    from torch.profiler import ProfilerActivity, profile

    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with profiling.annotate("unrecorded"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("recorded"):
            pass
    assert entered == ["recorded"]


def test_no_span_lost_across_threads():
    """Appends from eight threads at the shortest switch interval: each of
    their spans is in the ring once."""
    t0 = time.time_ns()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(i):
            for j in range(500):
                with profiling.annotate("stress", key=(i, j)):
                    pass

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    keys = [s[4] for s in named(profiling.spans(t0), "stress")]
    assert sorted(keys) == [(i, j) for i in range(8) for j in range(500)]


# ------------------------------------------------------------ generate()


@pytest.fixture(scope="module")
def tiny_jen1():
    from jen1_tpu_torch.api.generation import Jen1
    from jen1_tpu_torch.codec.model import EncodecConfig, EncodecModel

    cfg = tiny_config()
    codec = EncodecModel(EncodecConfig(sample_rate=SR, channels=2,
                                       dimension=cfg.model_config.in_channels, n_filters=2,
                                       ratios=(5, 4, 2), n_q=4, bins=16), device="cpu")
    with one_torch_thread():
        yield Jen1(sample_rate=SR, config=cfg, codec=codec, device="cpu")


def generate_spans(jen1, **kw):
    t0 = time.time_ns()
    jen1.generate("a tune", seed=3, steps=STEPS, seconds=1.0, **kw)
    return profiling.spans(t0)


@pytest.fixture(scope="module")
def host_request(tiny_jen1):
    spans = generate_spans(tiny_jen1)
    return spans, dict(tiny_jen1.last_timings)


@pytest.mark.parametrize("kw", [dict(), dict(use_gdm=True),
                                dict(use_gdm=True, sampler_mode="stepwise")],
                         ids=["vdm-scan", "ddim-scan", "ddim-stepwise"])
def test_one_sampler_step_span_per_step(tiny_jen1, kw):
    spans = generate_spans(tiny_jen1, **kw)
    steps = named(spans, "sampler.step")
    (sampler,) = named(spans, "gen.sampler")
    assert [s[4] for s in steps] == list(range(STEPS))
    assert all(s[3] == sampler[3] for s in steps)
    assert all(sampler[1] <= s[1] <= s[2] <= sampler[2] for s in steps)
    assert all(a[2] <= b[1] for a, b in zip(steps, steps[1:]))


@pytest.mark.parametrize("phase", PHASES)
def test_phase_span_covers_its_timing(host_request, phase):
    """One `gen.<phase>` span per phase, lasting its last_timings entry
    (within 1 ms), the phases back to back in order."""
    spans, timings = host_request
    (span,) = named(spans, f"gen.{phase}")
    assert abs((span[2] - span[1]) / 1e9 - timings[phase]) < 1e-3
    i = PHASES.index(phase)
    if i:
        (prev,) = named(spans, f"gen.{PHASES[i - 1]}")
        assert abs(span[1] - prev[2]) < 1_000_000


def test_phase_spans_are_regions_of_a_profilers_trace(tiny_jen1):
    """Under a profiler each phase is also a named region of its trace (an
    operator's `start_trace`), starting where its ring span starts."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spans = generate_spans(tiny_jen1)
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("gen.")]
    assert sorted(e.name() for e in events) == sorted(f"gen.{p}" for p in PHASES)
    for event in events:
        (ring,) = named(spans, event.name())
        assert abs(event.start_ns() - ring[1]) < 1_000_000


@pytest.mark.parametrize("transport", ["host", "device"])
def test_phase_spans_are_the_timings_keys(tiny_jen1, transport):
    """A span per last_timings key and no other (device transport ends at
    the decode); no decode events on the CPU."""
    spans = generate_spans(tiny_jen1, output_transport=transport)
    phases = sorted(s[0][len("gen."):] for s in spans if s[0].startswith("gen."))
    assert phases == sorted(tiny_jen1.last_timings)
    assert ("fetch" in phases) == (transport == "host")
    assert tiny_jen1.last_decode_events is None


# ---------------------------------------------------------------- loader


@pytest.mark.parametrize("prefetch", [2, 0])
def test_loader_wait_is_a_span_per_batch(prefetch):
    """With a prefetch thread, the wait for each of its batches (and for
    its end) is a `data.wait` span; without one, nothing is waited for."""
    import numpy as np

    from jen1_tpu_torch.data.dataset import make_dataloader

    data = [(np.full((4, 2), i, np.float32), {"prompt": str(i)}) for i in range(6)]
    t0 = time.time_ns()
    batches = list(make_dataloader(data, 2, shuffle=False, prefetch=prefetch))
    waits = named(profiling.spans(t0), "data.wait")
    assert len(batches) == 3
    assert len(waits) == (4 if prefetch else 0)
    assert all(s[3] == threading.get_ident() for s in waits)
