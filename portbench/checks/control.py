"""Readings that set a cell's limit: for each seed, one unit of the cell's
work from the program and from the plain reference in fp32 and with every
product's operands rounded to float8 e4m3 (the control); the relative L2
distance of each to the fp32 reference's audio. A
generate cell's unit is its first batch (the largest distance over its
clips); a serve cell's, a batch of its longest clips as the service pads
it, one request in lane 0, compared there.

    python3 portbench/checks/control.py --workload flagship-batch --seeds 1 2 3

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


class _Unit:
    def __init__(self, program, reference, distance):
        self.program, self.reference, self.distance = program, reference, distance


def _unit(drv, cfg, mix, seed, device) -> _Unit:
    """How one seed's unit of work runs on each side, and its distance."""
    if "batch" in mix:  # a closed loop of generate() batches
        caps, s = traffic.closed_batch(seed, mix, 0)
        kw = dict(batch_size=mix["batch"], seconds=mix["seconds"], steps=mix["steps"])
        return _Unit(lambda jen1: jen1.generate(caps, seed=s, **kw),
                     lambda models: drv.reference_audio(models, cfg, caps, s, mix, device),
                     drv.rel_err)
    r = traffic.rng(seed, 8)
    seconds = max(mix["clip_seconds"])
    prompts = [traffic.caption(r, tuple(mix["caption_words"]))] + [""] * (mix["max_batch"] - 1)
    batch = dict(prompts=prompts, seed=int(r.integers(0, 2**31 - 1)), seconds=seconds,
                 steps=mix["steps"])

    def program(jen1):
        out = jen1.generate(prompts, seed=batch["seed"], steps=mix["steps"],
                            batch_size=mix["max_batch"], seconds=seconds, use_gdm=True,
                            output_transport="device")
        return out[0].cpu().numpy()

    return _Unit(program, lambda models: drv.reference_clip(models, cfg, batch, 0, device),
                 lambda a, b: drv.gen.rel_err(a[None], b[None]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    core.prepare_environment()
    from portbench.harness.registry import Cell
    from portbench.reference import model as ref

    cell = Cell(args.workload)
    drv = cell.driver
    cfg, mix = cell.config["config"], cell.traffic
    gen = drv if hasattr(drv, "program") else drv.gen
    jen1 = gen.program(cfg, args.seeds[0], args.device)
    models = gen.reference_weights(cfg, args.seeds[0], args.device)
    for seed in args.seeds:
        t0 = time.perf_counter()
        gen.load_program_weights(jen1, cfg, seed, args.device)
        sd = gen.run_weights(cfg, seed, args.device)
        for mod, key in zip(models, ("t5", "unet", "decoder")):
            mod.load_state_dict(sd[key], strict=True)
        del sd
        unit = _unit(drv, cfg, mix, seed, args.device)
        want = unit.reference(models)
        row = {"seed": seed, "program": unit.distance(unit.program(jen1), want)}
        with ref.lower_precision():
            row["reference_fp8"] = unit.distance(unit.reference(models), want)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
