"""The knee of a serve cell: its mix at each offered rate for a stretch of
open-loop load, one service kept up between them. Per rate: requests due,
failed, latency median and p90, the median latency of the first and last
third of the requests (a backlog that grows makes the last third slower),
batches and their fill. The knee is the highest rate whose backlog does
not grow; a serve cell is set at about four fifths of it.

    python3 portbench/checks/sweep.py --workload longform-serve --seconds 40 --rates 1 2 3
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.harness import core, stats, traffic  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=40.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seed", type=int, default=4242)
    args = p.parse_args(argv)
    core.prepare_environment()
    from jen1_tpu_torch.serve import GenerationService

    from portbench.harness.registry import Cell

    cell = Cell(args.workload)
    drv = cell.driver
    cfg, mix = cell.config["config"], dict(cell.traffic)
    jen1 = drv.SeedingJen1(drv.gen.program(cfg, args.seed, "cuda"), traffic.rng(args.seed, 5))
    service = GenerationService(jen1, max_batch=mix["max_batch"],
                                max_wait_ms=mix["max_wait_ms"])
    try:
        for clip in mix["clip_seconds"]:
            service.submit("warm-up", seconds=clip, steps=mix["steps"])
        for rate in args.rates:
            mix["rate_per_s"] = rate
            schedule = traffic.poisson_schedule(args.seed + int(rate * 1000), mix, args.seconds)
            s0 = dict(service.stats)
            t0 = time.perf_counter()
            _, done, _, lag = drv.open_loop(service, schedule, mix["steps"], args.seconds)
            wall = time.perf_counter() - t0
            s1 = dict(service.stats)
            lat = [d - r["due"] for r, d in zip(schedule, done) if d is not None]
            third = max(1, len(lat) // 3)
            batches = s1["batches"] - s0["batches"]
            due = [r["due"] for r in schedule]
            print(json.dumps({
                "rate": rate, "due": len(schedule), "failed": sum(d is None for d in done),
                "p50": statistics.median(lat) if lat else None,
                "p90": stats.latency_percentile(due, done, 90),
                "first_third_median": statistics.median(lat[:third]) if lat else None,
                "last_third_median": statistics.median(lat[-third:]) if lat else None,
                "batches": batches, "send_lag": lag, "wall": wall,
                "fill": (1 - (s1["padded_lanes"] - s0["padded_lanes"])
                         / max(1, batches * mix["max_batch"])),
            }), flush=True)
    finally:
        service.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
