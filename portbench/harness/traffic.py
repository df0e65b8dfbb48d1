"""The one traffic generator: everything a driver hands the program is
drawn here from the run's seed and a mix's parameters (`traffic/<mix>.json`).

A closed loop's sizes are the same for every seed; its captions and
per-request seeds change with it. An open loop's arrivals and clip
lengths are drawn from the seed as a Poisson process would send them.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

WORDS = (Path(__file__).with_name("words.txt")).read_text().split()


def rng(seed: int, *stream: int) -> np.random.Generator:
    """An independent stream of the run's seed (any non-negative integer)."""
    return np.random.default_rng([int(seed) % (2**64), *stream])


def caption(r: np.random.Generator, words: Tuple[int, int]) -> str:
    n = int(r.integers(words[0], words[1] + 1))
    return " ".join(WORDS[i] for i in r.integers(0, len(WORDS), n))


def closed_batch(seed: int, mix: Dict, index: int) -> Tuple[List[str], int]:
    """Batch `index` of a closed loop: `batch` captions and the request's
    seed (index -1 is the warm-up's)."""
    r = rng(seed, 1, index + 1)
    caps = [caption(r, tuple(mix["caption_words"])) for _ in range(mix["batch"])]
    return caps, int(r.integers(0, 2**31 - 1))


def poisson_schedule(seed: int, mix: Dict, seconds: float) -> List[Dict]:
    """Open-loop arrivals over `seconds` at a mean of `rate_per_s`: the
    gaps i.i.d. exponential and each clip length drawn evenly from
    `clip_seconds`, independently, all from the seed. With `on_off_s`
    [on, off], arrivals come only in the first `on` seconds of every
    `on + off` (bursts), at rate_per_s x (on + off) / on, so the mean
    rate is the same."""
    r = rng(seed, 2)
    on, off = mix.get("on_off_s", (seconds, 0.0))
    rate = mix["rate_per_s"] * (on + off) / on
    out, busy = [], 0.0  # busy: seconds of "on" time elapsed
    while True:
        busy += float(r.exponential(1.0 / rate))
        due = (busy // on) * (on + off) + busy % on
        if due >= seconds:
            return out
        out.append(dict(due=due, seconds=float(r.choice(mix["clip_seconds"])),
                        prompt=caption(r, tuple(mix["caption_words"]))))
