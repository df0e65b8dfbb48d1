"""A new cell, configuration, traffic mix and per-layer metric are picked
up from dropped-in files alone: no file of the benchmark changes."""

from __future__ import annotations

import hashlib
import json
import shutil

from portbench.harness import core, registry
from portbench.harness.core import Run
from portbench.harness.registry import ROOT, Cell

NEW_METRIC = '''
NAME = "new.metric"
UNIT = "ms"
LAYER = "serving"
SOURCE = "program_span"
MOVES = "gen_audio_s_per_s"


def read(run):
    return run.spans.get("new_value")
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "portbench"
    for d in ("drivers", "metrics", "configs", "traffic", "workloads"):
        shutil.copytree(ROOT / d, root / d)
    before = _digests(root)
    cfg = json.loads((root / "configs" / "flagship.json").read_text())
    cfg["name"] = "new-config"
    (root / "configs" / "new-config.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "closed-b4-30s-vdm100.json").read_text())
    mix["batch"] = 2
    (root / "traffic" / "new-mix.json").write_text(json.dumps(mix))
    (root / "workloads" / "new-cell.json").write_text(json.dumps(dict(
        config="new-config", traffic="new-mix", chips=1, why="a dropped-in cell",
        limits={"audio_rel_err": 0.02})))
    (root / "metrics" / "new.metric.py").write_text(NEW_METRIC)

    cell = Cell("new-cell", root)
    assert cell.config["name"] == "new-config" and cell.traffic["batch"] == 2
    assert cell.driver.__name__ == "portbench_generate" and cell.chips == 1
    assert "new-cell" in registry.names("workloads", root)
    assert "new.metric" in [m.NAME for m in cell.metrics()]
    run = Run(setup_s=1.0, attempted=2, failed=0, end_to_end={"gen_audio_s_per_s": 3.0},
              spans={"new_value": 7.5}, checks={"audio_rel_err": [0.001, 0.02]},
              memory_peak_bytes=1)
    out = core.result(run, cell, True, {"platform": "gpu"}, cell.driver.UNITS)
    assert out["metrics"] == {"new.metric": {"value": 7.5, "unit": "ms"}}
    assert out["correct"] and list(out)[-1] == "checks"
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_every_metric_file_declares_itself():
    for reader in registry.metrics():
        assert reader.NAME == reader.__file__.rsplit("/", 1)[-1][:-3]
        assert reader.SOURCE in ("device_trace", "program_span", "program_counter",
                                 "host_clock")
        assert reader.UNIT and reader.LAYER and reader.MOVES


def test_every_cell_names_files_that_exist():
    for name in registry.names("workloads"):
        cell = Cell(name)
        assert cell.chips in (1, 4) and len(cell.why) <= 200 and cell.limits
