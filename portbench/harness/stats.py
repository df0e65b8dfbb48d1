"""Statistics of a run: latency percentiles over every request due, rates,
quartile spreads."""

from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Optional, Sequence


def latency_percentile(due: Sequence[float], done: Sequence[Optional[float]], q: float) -> float:
    """The q-th percentile (0 < q < 100, nearest rank) of the latencies of
    every request due, each timed from its due time to its answer. A
    request that failed, was refused or never answered (`done` None)
    counts as missing any limit: +inf."""
    if len(due) != len(done) or not due:
        raise ValueError("one answer time per due request, and at least one request")
    lat = sorted(math.inf if d is None else d - s for s, d in zip(due, done))
    rank = max(1, math.ceil(q / 100.0 * len(lat)))
    return lat[rank - 1]


def rate(amount: float, seconds: float) -> float:
    """Work per second over a window; the window must be positive."""
    if seconds <= 0:
        raise ValueError("a rate needs a window longer than 0 s")
    return amount / seconds


def spread(values: Iterable[float]) -> float:
    """Quartile distance over the median, as statistics.quantiles(n=4)
    gives the quartiles."""
    vals: List[float] = list(values)
    q1, med, q3 = statistics.quantiles(vals, n=4)
    return (q3 - q1) / med
