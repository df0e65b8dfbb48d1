"""The training loop of `train/train.py::run`, driven step by step:
`LatentDataset` over seeded .npy latents and .json captions that set-up
writes under TMPDIR, `make_dataloader`, `prepare_batch` (the frozen T5 on
the batch's captions), `UnifiedMultiTaskTrainer.train_step` (multi-task
GDM, forward and backward, the optimizer chain with its gradient
accumulation).

Mix parameters: files, clip_seconds, caption_words, check_steps,
trace_steps; the batch, the accumulation and the tasks are the
configuration's. Set-up runs the first grad_accum_every steps, the first
optimizer update included, on the one trainer the window then drives.
End to end: train_audio_s_per_s, every step's audio seconds over the
window (ended by a synchronize). Correctness, by the worst leaf, against
the plain reference on the same rows, captions, draws and weights: the
first gradient, read from the optimizer's accumulator after step one, and
the parameters' change that the first update (after grad_accum_every
steps) makes.
The first `check_steps` losses are printed beside it, not compared: no
control or fault moves them three times past sound runs (PERF.md).
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np

from portbench import flops
from portbench.drivers import generate as gen
from portbench.harness import traffic, weights
from portbench.harness.core import Run
from portbench.harness.trace import Trace
from portbench.reference import model as ref
from portbench.reference import train as ref_train

UNITS = {"train_audio_s_per_s": "audio-s/s", "setup_s": "s"}


def write_latents(seed: int, mix: Dict, channels: int) -> str:
    """`files` seeded latents (clip frames x channels, N(0, 1)) and their
    captions in a new directory under TMPDIR."""
    out = tempfile.mkdtemp(prefix="portbench-latents-")
    r = traffic.rng(seed, 9)
    frames = gen.latent_frames(int(mix["clip_seconds"] * 48_000))
    for i in range(mix["files"]):
        np.save(os.path.join(out, f"clip{i:04d}.npy"),
                r.standard_normal((frames, channels), dtype=np.float32))
        with open(os.path.join(out, f"clip{i:04d}.json"), "w") as f:
            json.dump({"prompt": traffic.caption(r, tuple(mix["caption_words"])),
                       "file": f"clip{i:04d}"}, f)
    return out


def step_flops(cfg: Dict, batch: int, frames: int, coin: bool) -> int:
    """UNet FLOPs of one training step: forward and backward (x3) of each
    causal group's CFG-doubled rows."""
    mc = cfg["model_config"]
    tokens = cfg["conditioner_config"]["t5_config"]["max_length"] + 1
    sub = batch // 3
    rows = {False: sub * (1 + (not coin)), True: sub * (1 + coin)}
    return sum(3 * flops.unet_forward_flops(mc, 2 * n, frames, tokens, causal=c)
               for c, n in rows.items())


def attention_work(cfg: Dict, batch: int, frames: int, coin: bool):
    """[(kind, FLOPs, bytes)] of every flash call of one step: the forward
    (K1) and the backward's dQ (K2) and dK/dV (K3) of each flash level's
    down and up transformer, per causal group."""
    mc = cfg["model_config"]
    sub = batch // 3
    calls = []
    for causal, n_rows in ((False, sub * (1 + (not coin))), (True, sub * (1 + coin))):
        for level, n in flops.flash_calls(mc, frames):
            c = mc["channels"] * mc["multipliers"][level + 1]
            d, bh = c // mc["attention_heads"], 2 * n_rows * mc["attention_heads"]
            for _ in range(2 * mc["attentions"][level]):
                calls.append(("attn_fwd", *flops.attn_fwd(bh, n, d, causal)))
                calls.append(("attn_bwd", *flops.attn_bwd_dq(bh, n, d, causal)))
                calls.append(("attn_bwd", *flops.attn_bwd_dkv(bh, n, d, causal)))
    return calls


def program(cfg: Dict, seed: int, device):
    """The program's trainer at the configuration, with the run's weights."""
    from jen1_tpu_torch.config import Config
    from jen1_tpu_torch.train.train import build_trainer

    config = Config.from_dict(cfg)
    config.seed = weights.weight_seed(seed) % (2**31)
    trainer = build_trainer(config, device=device)
    sd = gen.run_weights(cfg, seed, device)
    t5_id = cfg["conditioner_config"]["t5_config"]["id"]
    trainer.conditioner.conditioners[t5_id].load_state_dict(sd["t5"], strict=True)
    trainer.model.load_state_dict(sd["unet"], strict=True)
    return trainer, config


def reference_readings(cfg: Dict, seed: int, rows: List, draw_seed: int, data_dir: str,
                       device) -> Dict:
    """From the plain fp32 reference over the rows of the first update's
    steps: their losses, per-leaf norms of step one's gradient and of the
    parameters' change that the update makes."""
    import torch

    t5, unet, _ = gen.reference_weights(cfg, seed, device)
    unet.train()
    tables = ref_train.gdm_tables(cfg["diffusion_config"]["gaussian_diffusion"]["steps"], device)
    p_drop = cfg["diffusion_config"]["gaussian_diffusion"]["cfg_dropout_proba"]
    losses, grads = [], {}
    with ref.fp32():
        for step, metadata in enumerate(rows):
            lat = torch.as_tensor(np.stack([
                np.load(os.path.join(data_dir, f"{m['file']}.npy")) for m in metadata]),
                device=device)
            with torch.no_grad():
                emb, mask = t5([m["prompt"] for m in metadata])
            d = ref_train.draws(draw_seed, step, lat.shape[0], lat.shape[1], lat.shape[2],
                                tables[0].shape[0], p_drop, device)
            total, _ = ref_train.multitask_loss(unet, lat, emb, mask, d, tables)
            losses.append(float(total.detach()))
            total.backward()  # .grad sums over the steps
            if step == 0:
                grads = {n: float(p.grad.norm()) for n, p in unet.named_parameters()
                         if p.grad is not None}
            del total, d
        params = dict(unet.named_parameters())
        mean = {n: p.grad / len(rows) for n, p in params.items() if p.grad is not None}
        update = ref_train.first_update({n: p.detach() for n, p in params.items()}, mean,
                                        cfg["optimizer_config"])
    return {"losses": losses, "grads": grads, "update": update}


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> Run:
    import torch

    from jen1_tpu_torch.data.dataset import LatentDataset, make_dataloader, train_test_split
    from jen1_tpu_torch.train.trainer import step_generator

    cfg, mix = cell.config["config"], cell.traffic
    on_card = torch.device(device).type == "cuda"
    data_dir = write_latents(seed, mix, cfg["model_config"]["in_channels"])
    try:
        trainer, config = program(cfg, seed, device)
        dc = config.dataset_config
        batch, accum = dc.batch_size, max(1, config.grad_accum_every)
        train_ds, _ = train_test_split(LatentDataset(data_dir), dc.train_test_split, config.seed)
        loader = make_dataloader(train_ds, batch, shuffle=True, seed=config.seed, epochs=None)
        state = trainer.init_state()
        names = [n for n, _ in trainer.model.named_parameters()]
        frames = gen.latent_frames(int(mix["clip_seconds"] * 48_000))

        host = dict(data_wait=0.0, prepare_batch=0.0, train_step=0.0)

        def step(g: int):
            nonlocal state
            t = time.perf_counter()
            latents, metadata = next(loader)
            t1 = time.perf_counter()
            b = trainer.prepare_batch(latents, metadata)
            t2 = time.perf_counter()
            state, m = trainer.train_step(state, b, step_generator(trainer.device, config.seed, g),
                                          np.random.default_rng((config.seed, g)))
            t3 = time.perf_counter()
            for k, dt in zip(host, (t1 - t, t2 - t1, t3 - t2)):
                host[k] += dt
            return m, metadata

        losses, rows, acc_norms = [], [], None
        before = [p.detach().to("cpu", copy=True) for p in trainer.model.parameters()]
        for g in range(accum):  # the first update's steps
            m, metadata = step(g)
            rows.append(metadata)
            if g < mix["check_steps"]:
                losses.append(m["loss/train"].detach().clone())
            if g == 0:
                acc = state.opt_state.acc if state.opt_state.acc is not None else [
                    p.grad for p in trainer.model.parameters()]
                acc_norms = torch.stack(torch._foreach_norm(acc)).cpu()
        moved = [float((p.detach().cpu() - q).norm())
                 for p, q in zip(trainer.model.parameters(), before)]
        del before
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0

        g = accum
        host0 = dict(host)
        start = time.perf_counter()
        deadline = start + seconds
        while time.perf_counter() < deadline:
            step(g)
            g += 1
        if on_card:
            torch.cuda.synchronize()
        window = time.perf_counter() - start
        done = g - accum
        coins = [bool(np.random.default_rng((config.seed, i)).integers(0, 2))
                 for i in range(accum, g)]
        spans = dict(driver="train", window_s=window, steps=done,
                     flops=sum(step_flops(cfg, batch, frames, c) for c in coins))
        print("train: host seconds per window step: " + ", ".join(
            f"{k} {(host[k] - host0[k]) / done:.4f}" for k in host)
            + f"; step {window / done:.4f}", flush=True)
        tr = None
        if trace and on_card:
            first = g
            tr = Trace.of(lambda: [step(i) for i in range(first, first + mix["trace_steps"])])
            spans["traced_steps"] = mix["trace_steps"]
            print(f"train: traced step {tr.window_s / mix['trace_steps']:.4f} s, device busy "
                  f"{tr.busy_s() / mix['trace_steps']:.4f} s of it", flush=True)
            spans["traced_attention"] = [
                w for i in range(first, first + mix["trace_steps"])
                for w in attention_work(cfg, batch, frames, bool(
                    np.random.default_rng((config.seed, i)).integers(0, 2)))]
        peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
        program_losses = [float(x) for x in losses]
        draw_seed = config.seed
        del trainer, state, loader, acc, losses, step
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        want = reference_readings(cfg, seed, rows, draw_seed, data_dir, device)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    got = dict(zip(names, acc_norms.tolist()))
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(program_losses, want["losses"]))
    grad_gap = ref_train.leaf_gap(got, want["grads"])
    update_gap = ref_train.leaf_gap(dict(zip(names, moved)), want["update"])
    grad_gap, update_gap = (x if math.isfinite(x) else math.inf for x in (grad_gap, update_gap))
    print(f"train: loss gap of steps 1-{len(program_losses)} {loss_gap!r} (not compared)",
          flush=True)
    return Run(setup_s=setup_s, attempted=done * batch, failed=0,
               end_to_end={"train_audio_s_per_s": done * batch * mix["clip_seconds"] / window},
               spans=spans,
               checks={"grad_leaf_gap": [grad_gap, cell.limits["grad_leaf_gap"]],
                       "update_leaf_gap": [update_gap, cell.limits["update_leaf_gap"]]},
               memory_peak_bytes=peak, trace=tr)
