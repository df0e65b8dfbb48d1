"""Readings that set a training cell's limits: for each seed, the first
update's grad_accum_every steps of the program's trainer (weights,
latents, captions and draws of that seed), and the plain reference on the
same rows, in fp32, with every product's operands rounded to float8 e4m3
(the control) and with a fault planted in it (the first half of the
batch's rows in place of the rest: half of the batch left out); the last
two on the first `--fault-seeds` seeds. Each side's numbers against the
fp32 reference's: the largest relative gap of the first `check_steps`
losses, the worst leaf's gap of the first gradient's norm (program: its
optimizer's accumulator after step one) and of the first update's
parameter change.

    python3 portbench/checks/train_control.py --workload longform-train --seeds 1 2 3

One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.harness import core, weights  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fault-seeds", type=int, default=4)
    args = p.parse_args(argv)
    core.prepare_environment()
    from portbench.harness.registry import Cell

    for row in readings(Cell(args.workload), args.seeds, args.device, args.fault_seeds):
        print(json.dumps(row), flush=True)
    return 0


def readings(cell, seeds, device, fault_seeds: int = 1):
    """One row of readings per seed (module docstring)."""
    import torch

    from jen1_tpu_torch.data.dataset import LatentDataset, make_dataloader, train_test_split
    from jen1_tpu_torch.train.trainer import step_generator

    from portbench.reference import model as ref
    from portbench.reference import train as ref_train

    drv = cell.driver
    cfg, mix = cell.config["config"], cell.traffic
    trainer, config = drv.program(cfg, seeds[0], device)
    for k, seed in enumerate(seeds):
        t0 = time.perf_counter()
        data_dir = drv.write_latents(seed, mix, cfg["model_config"]["in_channels"])
        try:
            sd = drv.gen.run_weights(cfg, seed, device)
            t5_id = cfg["conditioner_config"]["t5_config"]["id"]
            trainer.conditioner.conditioners[t5_id].load_state_dict(sd["t5"], strict=True)
            trainer.model.load_state_dict(sd["unet"], strict=True)
            del sd
            draw_seed = weights.weight_seed(seed) % (2**31)
            config.seed = draw_seed
            dc = config.dataset_config
            train_ds, _ = train_test_split(LatentDataset(data_dir), dc.train_test_split,
                                           draw_seed)
            loader = make_dataloader(train_ds, dc.batch_size, shuffle=True, seed=draw_seed,
                                     epochs=None, prefetch=0)
            state = trainer.init_state()
            losses, rows, acc_norms = [], [], None
            before = [p.detach().to("cpu", copy=True) for p in trainer.model.parameters()]
            for g in range(max(1, config.grad_accum_every)):
                latents, metadata = next(loader)
                b = trainer.prepare_batch(latents, metadata)
                state, m = trainer.train_step(state, b,
                                              step_generator(trainer.device, draw_seed, g),
                                              np.random.default_rng((draw_seed, g)))
                if g < mix["check_steps"]:
                    losses.append(float(m["loss/train"]))
                rows.append(metadata)
                if g == 0:
                    acc_norms = torch.stack(torch._foreach_norm(state.opt_state.acc)).tolist()
            names = [n for n, _ in trainer.model.named_parameters()]
            moved = dict(zip(names, [float((p.detach().cpu() - q).norm()) for p, q in
                                     zip(trainer.model.parameters(), before)]))
            loader.close()
            del state, b, before
            got = dict(zip(names, acc_norms))
            for prm in trainer.model.parameters():
                prm.grad = None
            torch.cuda.empty_cache()
            want = drv.reference_readings(cfg, seed, rows, draw_seed, data_dir, device)

            def gaps(loss_list, grad_norms, update_norms):
                return [max(abs(a - r) / abs(r) for a, r in zip(loss_list, want["losses"])),
                        ref_train.leaf_gap(grad_norms, want["grads"]),
                        ref_train.leaf_gap(update_norms, want["update"])]

            row = {"seed": seed, "program": gaps(losses, got, moved)}
            if k >= fault_seeds:
                row["seconds"] = time.perf_counter() - t0
                yield row
                continue
            with ref.lower_precision():
                low = drv.reference_readings(cfg, seed, rows, draw_seed, data_dir, device)
            row["reference_fp8"] = gaps(low["losses"], low["grads"], low["update"])
            orig = ref_train.multitask_loss

            def half(unet_, lat, emb, mask, d, tables):
                sub = lat.shape[0] // 2 or 1
                _, per = orig(unet_, lat[:sub].repeat(lat.shape[0] // sub + 1, 1, 1)[
                    : lat.shape[0]], emb, mask, d, tables)
                return sum(per.values()), per

            ref_train.multitask_loss = half
            try:
                fault = drv.reference_readings(cfg, seed, rows, draw_seed, data_dir, device)
            finally:
                ref_train.multitask_loss = orig
            row["half_batch"] = gaps(fault["losses"], fault["grads"], fault["update"])
            row["seconds"] = time.perf_counter() - t0
            yield row
        finally:
            shutil.rmtree(data_dir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
