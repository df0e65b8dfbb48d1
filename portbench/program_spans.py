"""The program's own spans (`jen1_tpu_torch.utils.profiling`'s ring) joined
with a device trace. The ring is stamped on `time.time_ns()`, the clock the
profiler stamps its host and device events with, so a span's interval
selects the device operations that ran in it.

A program without the ring (one older than it) has nothing to read:
`ring_since` returns None for it, as for a trace with no host events
`stretch` does."""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

from portbench.harness.trace import WINDOW

Interval = Tuple[int, int]


def stretch(trace) -> Optional[Interval]:
    """(start, end) ns of what the trace kept: its WINDOW span where the
    traced call marked one, else the extent of its host events."""
    marked = [(s, e) for s, e, name in trace.host if name == WINDOW]
    if marked:
        return marked[0]
    if not trace.host:
        return None
    return min(s for s, _, _ in trace.host), max(e for _, e, _ in trace.host)


def ring_since(start_ns: int) -> Optional[List[tuple]]:
    """The ring's spans, in the order they ended, or None where the
    program keeps no ring or the ring no longer reaches back to `start_ns`:
    it is full and its oldest span ended after `start_ns`, so a span of the
    stretch may have been dropped (a span joins the ring when it ends)."""
    try:
        from jen1_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans"):
        return None
    spans = profiling.spans()
    if len(spans) >= profiling.RING_SPANS and spans[0][2] > start_ns:
        return None
    return spans


def clip(intervals: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    """The intervals cut to [lo, hi], the empty ones left out."""
    out = [(max(s, lo), min(e, hi)) for s, e in intervals]
    return [(s, e) for s, e in out if e > s]


def idle_ns(intervals: Sequence[Interval], device: Sequence[tuple]) -> int:
    """Nanoseconds of the union of `intervals` in which no device operation
    ((start, end, name)) ran."""
    busy = _union([(s, e) for s, e, _ in device])
    ends = [e for _, e in busy]
    total = 0
    for s, e in _union(intervals):
        total += e - s
        j = bisect.bisect_right(ends, s)  # the first busy stretch ending after s
        while j < len(busy) and busy[j][0] < e:
            total -= min(busy[j][1], e) - max(busy[j][0], s)
            j += 1
    return total


def _union(intervals: Sequence[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out
