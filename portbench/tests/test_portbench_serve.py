"""A whole serve run on the CPU at test widths: open-loop arrivals into
the service, the p90 over every request due, and the comparison of a
sample of the answers (one of the longest among them) with the reference,
sound and with the timed path broken underneath."""

from __future__ import annotations

import json
import time

import pytest

from portbench.harness import core
from portbench.harness.registry import ROOT, Cell
from portbench.tests.portbench_tiny import tiny_root

LIMIT = json.loads((ROOT / "workloads" / "longform-serve.json").read_text())["limits"][
    "audio_rel_err"]


def _run(tmp_path, seed=2**33 + 5):
    cell = Cell("tiny", tiny_root(tmp_path, limit=LIMIT, driver="serve"))
    return cell, cell.driver.run(cell, seed, 2.0, False, "cpu", time.perf_counter())


def test_sound_run_is_correct(tmp_path):
    cell, run = _run(tmp_path)
    assert run.correct, run.checks
    assert run.checks["audio_rel_err"][0] < 1e-4
    assert run.attempted >= 3 and run.failed == 0
    out = core.result(run, cell, True, {"platform": "cpu"}, cell.driver.UNITS)
    assert {"serve.batch_fill", "serve.fetch_s_per_batch", "sampler.ms_per_step.serve",
            "mfu.serve"} <= set(out["metrics"])
    assert 0 < out["metrics"]["serve.batch_fill"]["value"] <= 1


@pytest.mark.parametrize("fault", ["step_unchanged", "answer_altered"])
def test_fault_is_not_correct(tmp_path, monkeypatch, fault):
    from jen1_tpu_torch.diffusion.gdm import DDIMSampler
    from jen1_tpu_torch.serve import GenerationService

    if fault == "step_unchanged":
        monkeypatch.setattr(DDIMSampler, "_step", lambda self, whole: self.advance())
    else:
        orig = GenerationService._dispatch_batch

        def altered(self, batch):
            return orig(self, batch) * (1.0 + 2 * LIMIT)
        monkeypatch.setattr(GenerationService, "_dispatch_batch", altered)
    _, run = _run(tmp_path)
    assert not run.correct, run.checks
