"""The benchmark's arithmetic: the tail over every due request, rates,
spreads, and traffic that repeats exactly for a seed."""

from __future__ import annotations

import math
import statistics

import numpy as np

import pytest

from portbench.harness import stats, traffic


def test_percentile_is_over_every_due_request_from_its_due_time():
    due = [0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0]
    done = [d + 1.0 + 0.1 * i for i, d in enumerate(due)]
    # latencies 1.0 .. 1.9: the 90th of ten is the ninth
    assert stats.latency_percentile(due, done, 90) == pytest.approx(1.8)
    assert stats.latency_percentile(due, done, 50) == pytest.approx(1.4)


def test_a_failed_request_counts_as_missing():
    due = [0.0] * 10
    done = [1.0] * 9 + [None]
    assert stats.latency_percentile(due, done, 90) == 1.0
    done = [1.0] * 8 + [None, None]
    assert stats.latency_percentile(due, done, 90) == math.inf


def test_percentile_needs_an_answer_slot_per_request():
    with pytest.raises(ValueError):
        stats.latency_percentile([0.0, 1.0], [1.0], 90)


def test_rate_and_spread():
    assert stats.rate(120.0, 2.0) == 60.0
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)
    vals = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / med)


def test_traffic_repeats_exactly_for_a_seed():
    mix = dict(batch=4, caption_words=[5, 60], rate_per_s=2.0, clip_seconds=[10, 20, 30])
    big = 2**40 + 12345
    assert traffic.closed_batch(big, mix, 3) == traffic.closed_batch(big, mix, 3)
    assert traffic.closed_batch(big, mix, 3) != traffic.closed_batch(big + 1, mix, 3)
    a = traffic.poisson_schedule(big, mix, 45.0)
    assert a == traffic.poisson_schedule(big, mix, 45.0)
    assert a != traffic.poisson_schedule(big + 1, mix, 45.0)
    assert all(0 <= r["due"] < 45.0 for r in a)
    assert [r["due"] for r in a] == sorted(r["due"] for r in a)
    caps, seed = traffic.closed_batch(big, mix, 0)
    assert len(caps) == 4 and all(5 <= len(c.split()) <= 60 for c in caps)
    assert 0 <= seed < 2**31 - 1


@pytest.mark.parametrize("on_off", [None, (5.0, 10.0)])
def test_open_loop_arrivals_are_poisson(on_off):
    """Gaps i.i.d. exponential at the mix's rate (in the "on" stretches of
    a burst mix, none in the "off" ones), lengths drawn evenly and
    independently: the count, the lengths and the gaps vary with the seed
    as such a process's do."""
    mix = dict(caption_words=[5, 60], rate_per_s=1.6, clip_seconds=[10, 20, 30])
    if on_off:
        mix["on_off_s"] = list(on_off)
    runs = [traffic.poisson_schedule(seed, mix, 45.0) for seed in range(400)]
    counts = np.array([len(s) for s in runs])
    assert counts.mean() == pytest.approx(1.6 * 45.0, rel=0.02)  # whole on/off periods
    assert counts.var() == pytest.approx(counts.mean(), rel=0.2)  # Poisson: var = mean
    lengths = np.array([r["seconds"] for s in runs for r in s])
    for clip in (10, 20, 30):
        assert (lengths == clip).mean() == pytest.approx(1 / 3, abs=0.01)
    assert len({tuple(r["seconds"] for r in s[:12]) for s in runs}) > 300
    due = [np.array([r["due"] for r in s]) for s in runs]
    if on_off:
        on, off = on_off
        assert all(((d % (on + off)) < on).all() for d in due)
        due = [d - (d // (on + off)) * off for d in due]  # "on" time alone
    gaps = np.concatenate([np.diff(d) for d in due])
    rate = 1.6 * (sum(on_off) / on_off[0] if on_off else 1.0)
    assert gaps.mean() == pytest.approx(1 / rate, rel=0.03)
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, abs=0.05)  # exponential
    assert (gaps < 0.1 / rate).mean() == pytest.approx(1 - np.exp(-0.1), abs=0.01)
