"""Readings that set a `generate_dit` cell's limit: for each seed, the
first batch of the cell from the program, and clips of it from the plain
reference in fp32 and with every product's operands rounded to float8
e4m3 (the control); the relative L2 distance of the program's clip and of
the control's to the fp32 reference's. The clips are those the driver
would check (the i-th from the i-th slice of the batch's rows).

    python3 portbench/checks/control_dit.py --workload sao-batch --seeds 1 2 3

One JSON line per seed. The program and the reference stay loaded and take
each seed's weights in place.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.harness import core, traffic  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--clips", type=int, default=1, help="clips compared per seed")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    core.prepare_environment()
    from portbench.harness.registry import Cell
    from portbench.reference import stable_audio_open as ref

    cell = Cell(args.workload)
    drv = cell.driver
    cfg, mix = cell.config["config"], cell.traffic
    rate = cfg["oobleck_config"]["sample_rate"]
    kw = dict(batch_size=mix["batch"], seconds=mix["samples"] / rate, steps=mix["steps"],
              seconds_start=mix["seconds_start"], seconds_total=mix["seconds_total"])
    jen1 = drv.program(cfg, args.seeds[0], args.device)
    models = drv.reference_models(cfg, args.seeds[0], args.device)
    per = mix["batch"] // args.clips
    for seed in args.seeds:
        t0 = time.perf_counter()
        drv.load_program_weights(jen1, cfg, seed, args.device)
        sd = drv.run_weights(cfg, seed, args.device)
        for key, mod in models.items():
            mod.load_state_dict(sd[key], strict=True)
        del sd
        caps, s = traffic.closed_batch(seed, mix, 0)
        audio = jen1.generate(caps, seed=s, **kw)
        row = {"seed": seed, "program": [], "reference_fp8": []}
        for i in range(args.clips):
            r = i * per + int(traffic.rng(seed, 9, i).integers(0, per))
            want = drv.reference_clip(models, cfg, caps[r], s, r, mix, args.device)
            row["program"].append(drv.rel_err(audio[r], want))
            with ref.lower_precision():
                fp8 = drv.reference_clip(models, cfg, caps[r], s, r, mix, args.device)
            row["reference_fp8"].append(drv.rel_err(fp8, want))
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
