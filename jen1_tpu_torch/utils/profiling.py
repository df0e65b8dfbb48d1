"""Profiling and tracing (port of jen1_tpu/utils/profiling.py) over
`torch.profiler`.

`trace(log_dir)` (or `start_trace` / `stop_trace` around a span of loop
iterations) records the host's operators and, when a card is present, its
kernels, and writes a Chrome-trace JSON, `<log_dir>/trace_<pid>_<n>.json`,
that chrome://tracing or Perfetto opens with no TensorBoard plugin.
`annotate(name)` names a region (`record_function`); the names show in
the trace. `StepTimer` keeps wall-time statistics of a hot loop, and on a
CUDA device synchronizes before it reads the clock, so each time covers
the device's work.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, Optional

import torch

_active: Optional[torch.profiler.profile] = None
_log_dir: Optional[str] = None
_count = 0


def start_trace(log_dir: str) -> None:
    """Start recording (pair with stop_trace)."""
    global _active, _log_dir
    if _active is not None:
        raise RuntimeError("a trace is already being recorded")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    _active = torch.profiler.profile(activities=activities)
    _active.__enter__()
    _log_dir = log_dir


def stop_trace() -> str:
    """Stop recording and write the trace; returns its path."""
    global _active, _count
    if _active is None:
        raise RuntimeError("no trace is being recorded")
    prof, _active = _active, None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    os.makedirs(_log_dir, exist_ok=True)
    _count += 1
    path = os.path.join(_log_dir, f"trace_{os.getpid()}_{_count}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Record the block: `with trace("logs/profile"): step(...)`."""
    start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region of the trace."""
    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """Wall-time statistics of the steps timed with `with timer:`, after
    `warmup` untimed ones. On a CUDA `device` the clock is read after a
    synchronize at both ends."""

    def __init__(self, warmup: int = 1, device=None):
        self.warmup = warmup
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.times: List[float] = []
        self._count = 0
        self._t0: Optional[float] = None

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)

    def stats(self) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        n = len(ts)
        return {"steps": n, "mean_s": sum(ts) / n, "p50_s": ts[n // 2], "min_s": ts[0],
                "max_s": ts[-1]}
