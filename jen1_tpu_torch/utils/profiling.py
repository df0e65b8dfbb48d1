"""Profiling and tracing (port of jen1_tpu/utils/profiling.py) over
`torch.profiler`.

`trace(log_dir)` (or `start_trace` / `stop_trace` around a span of loop
iterations) records the host's operators on every thread and, when a card
is present, its kernels, and writes a Chrome-trace JSON,
`<log_dir>/trace_<pid>_<n>.json`, that chrome://tracing or Perfetto opens
with no TensorBoard plugin.

`annotate(name, key=None)` is the one span primitive. While a profiler
records, it names a region of its trace (`record_function`); always, it
appends the span `(name, start_ns, end_ns, thread_id, key)` to a bounded
in-memory ring that keeps the newest RING_SPANS spans; `spans()` copies
it out. The stamps are `time.time_ns()`, the clock the profiler stamps its
host and device events with, so the ring joins a trace. `key` names the
request or batch the span belongs to; a span's parent is the span of the
same thread that encloses it.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import Any, Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as autograd_profiler

RING_SPANS = 65_536

Span = Tuple[str, int, int, int, Any]  # (name, start_ns, end_ns, thread_id, key)

# deque.append is atomic under the interpreter lock: no lock of our own
_ring: "deque[Span]" = deque(maxlen=RING_SPANS)

_active: Optional[torch.profiler.profile] = None
_log_dir: Optional[str] = None
_count = 0


def spans(since_ns: int = 0) -> List[Span]:
    """A copy of the ring, oldest first: the spans that start at or after
    `since_ns`."""
    return [s for s in list(_ring) if s[1] >= since_ns]


class annotate:
    """`with annotate(name, key=None):` a span of the ring and a named
    region of the profiler's trace."""

    __slots__ = ("name", "key", "_start", "_region")

    def __init__(self, name: str, key: Any = None):
        self.name = name
        self.key = key

    def __enter__(self) -> "annotate":
        self._start = time.time_ns()
        # the region only while a profiler records (the flag is process-wide,
        # set by torch.profiler.profile): otherwise no call into torch's
        # operator dispatch at every span
        self._region = None
        if getattr(autograd_profiler, "_is_profiler_enabled", True):
            self._region = torch.profiler.record_function(self.name)
            self._region.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._region is not None:
            self._region.__exit__(*exc)
        _ring.append((self.name, self._start, time.time_ns(), threading.get_ident(), self.key))


def start_trace(log_dir: str) -> None:
    """Start recording (pair with stop_trace). Every thread is recorded,
    those started before the trace too (a service's dispatcher and
    completers, a loader's worker)."""
    global _active, _log_dir
    if _active is not None:
        raise RuntimeError("a trace is already being recorded")
    from torch._C._profiler import _ExperimentalConfig

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    _active = torch.profiler.profile(
        activities=activities,
        experimental_config=_ExperimentalConfig(profile_all_threads=True))
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
