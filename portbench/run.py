"""Run one cell of the port's benchmark once, from the checkout's root:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights from the seed, the program's build, every shape the cell
uses warmed up), then a measured window of `--seconds`, then, with
`--trace 1`, one traced unit of the cell's work, then the comparison with
the plain reference. The last line of standard output is the result (JSON);
the numbers compared are the last lines of standard error. No card, fewer
cards than the cell asks for, or JAX loaded: no result and a non-zero exit.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import core  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be a non-negative integer")
    core.prepare_environment()
    from portbench.harness.registry import Cell

    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    run = cell.driver.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = core.forbidden_modules(list(sys.modules))
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips}
    core.print_result(core.result(run, cell, bool(args.trace), device, cell.driver.UNITS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
