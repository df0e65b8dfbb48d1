"""What every run shares: the run's record (`Run`), the environment
(caches inside the checkout), the check that neither JAX nor the JAX
package was loaded, and the result line."""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

CHECKOUT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "jen1_tpu")


@dataclasses.dataclass
class Run:
    """What a driver measured and checked in one run.

    `end_to_end` maps a metric to its value (the unit comes from the
    metric's entry); `spans` holds the host-clock spans and the program's
    counters that per-layer readers read; `trace` the device trace of a
    `--trace 1` run; `checks` maps each compared number to (value, limit),
    each passing when value <= limit."""

    setup_s: float
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    spans: Dict[str, Any]
    checks: Dict[str, List[float]]
    memory_peak_bytes: int
    trace: Optional[Any] = None

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for v, lim in self.checks.values())


def prepare_environment() -> None:
    """Fixed cache directories inside the checkout (the program's nvcc
    build already lies in its `build/`), and no JAX through a library."""
    build = CHECKOUT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))
    for key, value in (("USE_FLAX", "0"), ("USE_TF", "0"), ("USE_JAX", "0"),
                       ("HF_HUB_OFFLINE", "1"), ("TRANSFORMERS_OFFLINE", "1")):
        os.environ[key] = value
    if str(CHECKOUT) not in sys.path:
        sys.path.insert(0, str(CHECKOUT))


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name is JAX's, a JAX library's or the
    JAX package's, compared whole (`jen1_tpu_torch` is not `jen1_tpu`)."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def result(run: Run, cell, trace: bool, device: Dict[str, Any],
           units: Dict[str, str]) -> Dict[str, Any]:
    """The result line: the cell's end-to-end metrics (trace 0) or its
    per-layer metrics (trace 1), the device, the breakdown, and the
    compared numbers last."""
    metrics: Dict[str, Dict[str, Any]] = {}
    if not trace:
        values = dict(run.end_to_end, setup_s=run.setup_s)
        for name, value in values.items():
            metrics[name] = {"value": value, "unit": units[name]}
    else:
        for reader in cell.metrics():
            value = reader.read(run)
            if value is not None:
                metrics[reader.NAME] = {"value": value, "unit": reader.UNIT}
    out: Dict[str, Any] = {
        "correct": run.correct,
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": metrics,
        "device": dict(device, memory_peak_bytes=run.memory_peak_bytes),
    }
    if trace and run.trace is not None:
        out["device"]["busy_s"] = run.trace.busy_s()
        out["device"]["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(10),
                            "idle_gaps": run.trace.idle_gaps(10)}
    out["checks"] = {name: {"value": _finite(v), "limit": lim}
                     for name, (v, lim) in run.checks.items()}
    return out


def _finite(v: float) -> float:
    """A number JSON can hold: a reading that never came reads 1e300."""
    return v if math.isfinite(v) else 1e300


def print_result(out: Dict[str, Any]) -> None:
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
