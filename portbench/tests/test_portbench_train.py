"""A whole training run on the CPU at test widths: seeded latent files,
the program's loader and trainer, the first gradient and the first
update's parameter change against the reference, sound and with the step
broken."""

from __future__ import annotations

import json
import time

import pytest

from portbench.harness import core
from portbench.harness.registry import ROOT, Cell
from portbench.tests.portbench_tiny import tiny_root

LIMITS = json.loads((ROOT / "workloads" / "longform-train.json").read_text())["limits"]


def _run(tmp_path, seed=2**36 + 3):
    cell = Cell("tiny", tiny_root(tmp_path, limit=LIMITS, driver="train"))
    return cell, cell.driver.run(cell, seed, 1.0, False, "cpu", time.perf_counter())


def test_sound_run_is_correct(tmp_path):
    cell, run = _run(tmp_path)
    assert run.correct, run.checks
    assert set(run.checks) == {"grad_leaf_gap", "update_leaf_gap"}
    assert run.checks["grad_leaf_gap"][0] < 1e-3 and run.checks["update_leaf_gap"][0] < 1e-2
    out = core.result(run, cell, True, {"platform": "cpu"}, cell.driver.UNITS)
    assert "mfu.train" in out["metrics"] and run.spans["steps"] >= 1


def _half_batch(orig):
    def training_losses(self, *a, **kw):
        per_ex = orig(self, *a, **kw)
        return per_ex[: max(1, len(per_ex) // 2)].mean().expand(len(per_ex))
    return training_losses


def _double(orig):
    def apply(self, grads, state, params, shard_groups):
        orig(self, grads, state, params, shard_groups)
        orig(self, grads, state, params, shard_groups)
    return apply


@pytest.mark.parametrize("fault", ["step_unchanged", "half_batch", "update_twice"])
def test_fault_is_not_correct(tmp_path, monkeypatch, fault):
    from jen1_tpu_torch.diffusion.gdm import GaussianDiffusion
    from jen1_tpu_torch.train.optim import AdamWChain

    if fault == "step_unchanged":
        monkeypatch.setattr(AdamWChain, "update", lambda self, grads, state, *a: state)
    elif fault == "update_twice":
        monkeypatch.setattr(AdamWChain, "_clip_adamw", _double(AdamWChain._clip_adamw))
    else:
        monkeypatch.setattr(GaussianDiffusion, "training_losses",
                            _half_batch(GaussianDiffusion.training_losses))
    _, run = _run(tmp_path)
    assert not run.correct, run.checks
