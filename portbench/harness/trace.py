"""A device trace of part of a run, reduced to what the per-layer readers
and the result's `device` and `breakdown` need.

`Trace` runs `torch.profiler` (CPU and CUDA activities) around a call,
started and stopped with the device idle, and keeps, of its events, the
device intervals (kernels, copies, sets) with their names, and the host
events, to say what the host was doing in each gap of the device's
timeline. Where the call marks a stretch of itself with a `WINDOW` span
(`window()`), only that stretch is kept.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

WINDOW = "portbench.trace_window"  # the host span that bounds what a trace keeps


def window():
    """The span that marks, inside a traced call, the stretch to keep."""
    from torch.profiler import record_function

    return record_function(WINDOW)


class Trace:
    """Device and host intervals (ns, one clock) of one traced window."""

    def __init__(self):
        self.device: List[Tuple[int, int, str]] = []  # (start, end, name)
        self.host: List[Tuple[int, int, str]] = []
        self.window_s = 0.0
        self.device_spans: List[Tuple[int, int, str]] = []

    @classmethod
    def of(cls, fn: Callable[[], None]) -> "Trace":
        import torch
        from torch.profiler import ProfilerActivity, profile

        tr = cls()
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            tr.window_s = time.perf_counter() - t0
        tr._read(prof)
        if any(name == WINDOW for _, _, name in tr.host):
            tr._clip()
        return tr

    def _read(self, prof) -> None:
        import torch

        for ev in prof.profiler.kineto_results.events():
            start = ev.start_ns()
            item = (start, start + ev.duration_ns(), ev.name())
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                self.host.append(item)
            elif _annotation(ev):  # a host span's extent on the device
                self.device_spans.append(item)
            else:
                self.device.append(item)
        self.device.sort()

    def _clip(self) -> None:
        """Keep the device operations wholly inside the WINDOW span, whose
        length is the window's."""
        (s, e), = [(s, e) for s, e, name in self.host if name == WINDOW]
        self.device = [d for d in self.device if s <= d[0] and d[1] <= e]
        self.window_s = (e - s) / 1e9

    def seconds_in_span(self, span: str) -> Tuple[float, int]:
        """(device seconds, spans) of the operations that ran inside the
        device-side extent of the host spans named `span` (a
        `record_function` range: the device runs one stream, so what runs
        inside its extent is what it launched)."""
        ranges = sorted((s, e) for s, e, name in self.device_spans if name == span)
        sec = 0
        for s, e in ranges:
            for ds, de, _ in self._within(s, e):
                sec += max(0, min(de, e) - max(ds, s))
        return sec / 1e9, len(ranges)

    def seconds_between(self, first: str, then: str) -> Tuple[float, int]:
        """(device seconds, count) from the device-side start of each span
        named `first` to that of the next span named `then`: on one stream,
        the work of `first` and of the threads it waits for (autograd runs
        the backward on its own thread, outside the span's own extent)."""
        begins = sorted(s for s, _, name in self.device_spans if name == first)
        ends = sorted(s for s, _, name in self.device_spans if name == then)
        sec, count = 0, 0
        for s in begins:
            j = bisect.bisect_right(ends, s)
            if j == len(ends):
                continue
            e = ends[j]
            for ds, de, _ in self._within(s, e):
                sec += max(0, min(de, e) - max(ds, s))
            count += 1
        return sec / 1e9, count

    def _within(self, s: int, e: int):
        starts = [d[0] for d in self.device]
        i = max(0, bisect.bisect_left(starts, s) - 1)
        return self.device[i:bisect.bisect_right(starts, e)]

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of
        the device intervals)."""
        busy, end = 0, None
        for s, e, _ in self.device:
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e9

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for s, e, name in self.device:
            out[name] += (e - s) / 1e9
        return dict(out)

    def seconds_matching(self, names) -> Tuple[float, int]:
        """(device seconds, calls) of the operations whose name contains
        one of `names`."""
        sec, calls = 0.0, 0
        for s, e, name in self.device:
            if any(n in name for n in names):
                sec += (e - s) / 1e9
                calls += 1
        return sec, calls

    def top_ops(self, k: int = 10) -> List[List]:
        by = sorted(self.seconds_by_name().items(), key=lambda kv: -kv[1])
        return [[_short(name), sec] for name, sec in by[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The k longest gaps between device operations, each named by the
        innermost host event that spans its middle."""
        gaps, end = [], None
        for s, e, _ in self.device:
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        out = []
        for length, s, e in gaps[:k]:
            mid = (s + e) // 2
            spans = [(he - hs, name) for hs, he, name in self.host
                     if hs <= mid <= he and name != WINDOW]
            name = min(spans)[1] if spans else "host: no event"
            out.append([_short(name), length / 1e9])
        return out


def _annotation(ev) -> bool:
    """Whether a device event is a user annotation (a span), not work."""
    flag = getattr(ev, "is_user_annotation", None)
    if flag is not None:
        return bool(flag())
    return "annotation" in str(ev.activity_type())


def _short(name: str, width: int = 160) -> str:
    """A kernel's name cut to `width` characters (template arguments make
    some thousands long)."""
    return name if len(name) <= width else name[: width - 3] + "..."
