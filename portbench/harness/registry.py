"""Everything of one cell, configuration, traffic mix or per-layer metric
lives in files of its own, found by name:

    configs/<config>.json     the configuration as run (`config`: the
                              program's Config as a dict) and its source
    traffic/<mix>.json        a traffic mix's parameters and its `driver`
    drivers/<driver>.py       how a kind of traffic drives the program:
                              run(cell, seed, seconds, trace, device) -> Run
    workloads/<cell>.json     {config, traffic, chips, why, limits}: limits
                              of the numbers compared, with their readings
    metrics/<metric>.py       NAME, UNIT, LAYER, SOURCE, MOVES and
                              read(run) -> value or None

A new cell, configuration, mix or metric is a new file; no file here
changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]


def _json(kind: str, name: str, root: Path) -> Dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def module(path: Path) -> ModuleType:
    """Import a file of the benchmark by its path."""
    name = "portbench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload: its configuration, traffic mix and driver."""

    def __init__(self, name: str, root: Path = ROOT):
        self.name = name
        self.root = root
        spec = _json("workloads", name, root)
        self.chips = int(spec["chips"])
        self.why = spec["why"]
        self.limits = spec["limits"]
        self.config_name = spec["config"]
        self.traffic_name = spec["traffic"]
        self.config = _json("configs", self.config_name, root)
        self.traffic = _json("traffic", self.traffic_name, root)
        self.driver = module(root / "drivers" / f"{self.traffic['driver']}.py")

    def metrics(self) -> List[ModuleType]:
        return metrics(self.root)


def names(kind: str, root: Path = ROOT) -> List[str]:
    suffix = ".py" if kind in ("metrics", "drivers") else ".json"
    return sorted(p.name[: -len(suffix)] for p in (root / kind).glob(f"*{suffix}"))


def metrics(root: Path = ROOT) -> List[ModuleType]:
    """Every per-layer metric reader, in name order."""
    return [module(root / "metrics" / f"{n}.py") for n in names("metrics", root)]
