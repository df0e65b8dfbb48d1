"""A whole generate run on the CPU at test widths (the look for a card
skipped), sound and with the timed path broken underneath: `correct` has
to come out true, then false for each fault the cell can have."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

from portbench.harness import core
from portbench.harness.registry import ROOT, Cell
from portbench.tests.portbench_tiny import tiny_root

LIMIT = json.loads((ROOT / "workloads" / "flagship-batch.json").read_text())["limits"][
    "audio_rel_err"]


def _run(tmp_path, seed=2**40 + 11):
    cell = Cell("tiny", tiny_root(tmp_path, limit=LIMIT))
    run = cell.driver.run(cell, seed, 1.0, False, "cpu", time.perf_counter())
    return cell, run


def test_sound_run_is_correct(tmp_path):
    cell, run = _run(tmp_path)
    assert run.correct, run.checks
    assert run.checks["audio_rel_err"][0] < 1e-4
    out = core.result(run, cell, False, {"platform": "cpu"}, cell.driver.UNITS)
    assert set(out["metrics"]) == {"gen_audio_s_per_s", "setup_s"}
    assert list(out)[-1] == "checks" and out["attempted"] >= 2 and out["failed"] == 0


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
