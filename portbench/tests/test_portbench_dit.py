"""The Stable Audio Open cell on the CPU at test widths
(portbench_tiny_dit.py): the DiT's FLOP count against a hand count, a
whole `generate_dit` run, sound and with the timed path broken underneath
(`correct` true, then false for each fault), the new per-layer readers on
hand-made runs, the old readers on this driver's run, and the refusal of
a program without the DiT. On the card, the program's first batch passes
the cell's limit and the fp8 control fails it."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

from portbench import flops, flops_dit
from portbench.harness import core, registry
from portbench.harness.registry import ROOT, Cell, module
from portbench.harness.trace import Trace
from portbench.tests.portbench_tiny_dit import tiny_dit_root

LIMIT = json.loads((ROOT / "workloads" / "sao-batch.json").read_text())["limits"][
    "audio_rel_err"]
NEW = ("mfu.sao", "sampler.ms_per_step.sao", "dit.gemm_roofline.sao", "attn_fwd_roofline.sao",
       "dit.flash_share.sao", "gen.decode_s.sao", "idle_share.sao")
TINY = dict(io_channels=4, embed_dim=8, depth=2, num_heads=2, cond_token_dim=6,
            global_cond_dim=8)
PUBLISHED = json.loads((ROOT / "configs" / "stable-audio-open.json").read_text())["config"]


def reader(name):
    return module(ROOT / "metrics" / f"{name}.py")


class Run:
    def __init__(self, spans, trace=None):
        self.spans = spans
        self.trace = trace


def test_dit_flops_by_hand():
    """One row, 3 frames (4 tokens with the prepended one), 5 context
    tokens; widths 8, heads of 4, a 6-wide context, FF inner 32."""
    f = 2 * (256 * 8 + 8 * 8) + 2 * (8 * 8 + 8 * 8) + 2 * 5 * (6 * 6 + 6 * 6)  # embeddings
    f += 2 * 3 * 4 * 4 * 2 + 2 * 3 * 4 * 8 + 2 * 4 * 8 * 4  # pre/post, in, out
    layer = (2 * 4 * 8 * 24 + 2 * 4 * 8 * 8  # self: qkv, out
             + 2 * 4 * 8 * 8 + 2 * 5 * 6 * 12 + 2 * 4 * 8 * 8  # cross: q, kv, out
             + 2 * 4 * 8 * 64 + 2 * 4 * 32 * 8)  # GLU
    assert flops_dit.dit_linear_flops(TINY, 1, 3, 5) == f + 2 * layer
    assert flops_dit.dit_cross_attention_flops(TINY, 1, 3, 5) == 2 * 4 * 4 * 5 * 8
    assert flops_dit.dit_self_attention_flops(TINY, 1, 3) == 2 * 4 * 4 * 4 * 8
    assert flops_dit.dit_forward_flops(TINY, 2, 3, 5) == 2 * (
        f + 2 * layer + 2 * 4 * 4 * 5 * 8 + 2 * 4 * 4 * 4 * 8)
    assert flops_dit.k1_shape(TINY, 2, 3) == (4, 4, 4)
    assert flops_dit.k1_work(TINY, 2, 3) == flops.attn_fwd(4, 4, 4)


def test_published_counts():
    """At the published widths: 87.4 GFLOP of linears a block and 7.3 of
    attention products a row at 1025 tokens and 130 context tokens, 2.271
    TFLOP a row-forward, 36.3 TFLOP a CFG step of 8 clips; K1 at B*H 384,
    N 1025, D 64."""
    dc = PUBLISHED["dit_config"]
    per_layer = (flops_dit.dit_linear_flops(dict(dc, depth=1), 1, 1024, 130)
                 - flops_dit.dit_linear_flops(dict(dc, depth=0), 1, 1024, 130))
    assert round(per_layer / 1e9, 1) == 87.4
    attn = (flops_dit.dit_cross_attention_flops(dc, 1, 1024, 130)
            + flops_dit.dit_self_attention_flops(dc, 1, 1024)) / dc["depth"]
    assert round(attn / 1e9, 1) == 7.3
    # 2.2719 with the embedding heads and the 1x1 convs, which the round
    # figure of 2.271 leaves out
    assert flops_dit.dit_forward_flops(dc, 1, 1024, 130) == pytest.approx(2.271e12, rel=1e-3)
    assert flops_dit.dit_forward_flops(dc, 16, 1024, 130) == pytest.approx(36.3e12, rel=2e-3)
    assert flops_dit.k1_shape(dc, 16, 1024) == (384, 1025, 64)


def _run(tmp_path, seed=2**40 + 11, **kw):
    cell = Cell("tiny", tiny_dit_root(tmp_path, limit=LIMIT, **kw))
    run = cell.driver.run(cell, seed, 1.0, False, "cpu", time.perf_counter())
    return cell, run


def test_sound_run_is_correct(tmp_path):
    cell, run = _run(tmp_path)
    assert run.correct, run.checks
    assert run.checks["audio_rel_err"][0] < 1e-4
    out = core.result(run, cell, False, {"platform": "cpu"}, cell.driver.UNITS)
    assert set(out["metrics"]) == {"gen_audio_s_per_s", "setup_s"}
    assert list(out)[-1] == "checks" and out["attempted"] >= 2 and out["failed"] == 0
    c = run.spans["counters"]
    batches = len(run.spans["batches"])
    assert c["FORWARDS"] == 3 * batches and c["SELF_ATTN_FLASH"] == 2 * 3 * batches
    assert c["SELF_ATTN_PLAIN"] == 0 and c["K1_MMA"] == 0  # the CPU runs K1's plain version
    traced = core.result(run, cell, True, {"platform": "cpu"}, cell.driver.UNITS)
    assert set(traced["metrics"]) == {"mfu.sao", "sampler.ms_per_step.sao",
                                      "dit.flash_share.sao", "gen.decode_s.sao"}


def _half_batch(orig):
    def generate(self, prompt, *a, batch_size=1, **kw):
        half = orig(self, list(prompt)[: batch_size // 2], *a,
                    batch_size=batch_size // 2, **kw)
        return np.concatenate([half, half])
    return generate


def _altered(orig):
    def generate(self, *a, **kw):
        out = orig(self, *a, **kw)
        out[0] *= 1.0 + 2 * LIMIT
        return out
    return generate


@pytest.mark.parametrize("fault", ["step_unchanged", "half_batch", "answer_altered"])
def test_fault_is_not_correct(tmp_path, monkeypatch, fault):
    from jen1_tpu_torch.api.generation import Jen1
    from jen1_tpu_torch.diffusion.vdm import VDMSampler

    if fault == "step_unchanged":
        monkeypatch.setattr(VDMSampler, "_step", lambda self: self.advance())
    elif fault == "half_batch":
        monkeypatch.setattr(Jen1, "generate", _half_batch(Jen1.generate))
    else:
        monkeypatch.setattr(Jen1, "generate", _altered(Jen1.generate))
    _, run = _run(tmp_path)
    assert not run.correct, run.checks


def test_a_program_without_the_dit_fails_before_set_up(tmp_path, monkeypatch):
    cell = Cell("tiny", tiny_dit_root(tmp_path))
    monkeypatch.setattr(cell.driver, "has_dit", lambda: False)
    monkeypatch.setattr(cell.driver, "program", lambda *a: pytest.fail("set-up ran"))
    with pytest.raises(RuntimeError, match="no DiT"):
        cell.driver.run(cell, 1, 1.0, False, "cpu", time.perf_counter())


def test_the_new_readers_are_found_and_declared():
    found = {m.NAME: m for m in registry.metrics()}
    entries = {e["name"]: e for e in json.loads((ROOT.parent / "BENCHMARK.json")
                                                .read_text())["per_layer"]}
    for name in NEW:
        m, e = found[name], entries[name]
        assert (m.UNIT, m.LAYER, m.SOURCE, m.MOVES) == (e["unit"], e["layer"], e["source"],
                                                       e["moves"])
        assert e["workloads"] == ["sao-batch"] and m.MOVES == "gen_audio_s_per_s"


def _trace():
    """A traced batch: the sampler's phase from 100 to 1100 ns holding two
    GEMMs of 200 ns and two K1 calls of 100 ns, a decode conv after it."""
    tr = Trace()
    tr.host = [(100, 1100, "gen.sampler"), (1200, 1500, "gen.decode")]
    tr.device = [(150, 350, "nvjet_tst_192x208_64x4_2x1_v_bz_coopB_bias_TNT"),
                 (360, 460, "void (anonymous namespace)::flash_fwd_mma_kernel<64>"),
                 (500, 700, "sm90_xmma_gemm_bf16bf16_bf16f32"),
                 (710, 810, "void (anonymous namespace)::flash_fwd_mma_kernel<64>"),
                 (1250, 1450, "sm80_xmma_fprop_implicit_gemm_f32f32")]
    tr.window_s = 2000e-9
    return tr


def _spans(**kw):
    return dict(driver="generate_dit", window_s=2.0, steps=4,
                batches=[{"sampler": 0.4, "decode": 0.1}, {"sampler": 0.6, "decode": 0.3}],
                dit_flops_per_batch=989e12 * 0.25, dit_gemm_flops_per_step=989e12 * 1e-7,
                k1_shape=(384, 1025, 64),
                counters={"FORWARDS": 200, "SELF_ATTN_FLASH": 4800, "SELF_ATTN_PLAIN": 0,
                          "K1_MMA": 4800}, **kw)


def test_new_readers_on_a_planted_run():
    run = Run(_spans(), _trace())
    assert reader("mfu.sao").read(run) == pytest.approx(25.0)  # 2 x 0.25 peak-s / 2 s
    assert reader("sampler.ms_per_step.sao").read(run) == pytest.approx(125.0)
    assert reader("gen.decode_s.sao").read(run) == pytest.approx(0.2)
    assert reader("dit.flash_share.sao").read(run) == 1.0
    assert reader("idle_share.sao").read(run) == pytest.approx(1 - 800 / 2000)
    # 4 steps x 1e-7 s of peak work over the 400 ns of GEMMs inside the sampler
    assert reader("dit.gemm_roofline.sao").read(run) == pytest.approx(100.0)
    k1 = flops.bound_s(*flops.attn_fwd(384, 1025, 64))
    assert reader("attn_fwd_roofline.sao").read(run) == pytest.approx(
        100.0 * 2 * k1 / 200e-9)
    plain = _spans()
    plain["counters"].update(SELF_ATTN_FLASH=1200, SELF_ATTN_PLAIN=3600)
    assert reader("dit.flash_share.sao").read(Run(plain)) == 0.25


@pytest.mark.parametrize("name", NEW)
def test_new_readers_read_nothing_elsewhere(name):
    """None on other drivers' runs, and the trace readers on a run without
    a trace."""
    other = dict(_spans(), driver="generate")
    assert reader(name).read(Run(other, _trace())) is None
    if reader(name).SOURCE == "device_trace":
        assert reader(name).read(Run(_spans())) is None


def test_old_readers_read_nothing_on_this_driver():
    for m in registry.metrics():
        if m.NAME not in NEW:
            assert m.read(Run(_spans(), _trace())) is None, m.NAME


@pytest.mark.cuda
def test_control_fails_the_limit(card):
    """On the card at the cell's size: a clip of the program's first batch
    within the limit of the fp32 reference's, the fp8 control beyond it."""
    from portbench.checks import control_dit  # noqa: F401  (the control's own script)
    from portbench.harness import traffic
    from portbench.reference import stable_audio_open as ref

    cell = Cell("sao-batch")
    drv, cfg, mix = cell.driver, cell.config["config"], cell.traffic
    seed = 2**35 + 23
    jen1 = drv.program(cfg, seed, card)
    caps, s = traffic.closed_batch(seed, mix, 0)
    rate = cfg["oobleck_config"]["sample_rate"]
    got = jen1.generate(caps, seed=s, batch_size=mix["batch"], seconds=mix["samples"] / rate,
                        steps=mix["steps"], seconds_start=mix["seconds_start"],
                        seconds_total=mix["seconds_total"])[5]
    del jen1
    models = drv.reference_models(cfg, seed, card)
    want = drv.reference_clip(models, cfg, caps[5], s, 5, mix, card)
    assert drv.rel_err(got, want) < LIMIT
    with ref.lower_precision():
        assert drv.rel_err(drv.reference_clip(models, cfg, caps[5], s, 5, mix, card),
                           want) > LIMIT
