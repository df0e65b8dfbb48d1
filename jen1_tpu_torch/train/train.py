"""Training entry point (port of jen1_tpu/train/train.py).

    python -m jen1_tpu_torch.train.train --config cfg.json --latents-dir d \
        --max-steps N [--device cpu] [--log-dir logs]

Trains `UnifiedMultiTaskTrainer` on one device ("cuda" unless asked
otherwise) over precomputed latents (<dir>/<name>.npy, (frames, C)), with
weights random from `config.seed`. Step `i` draws its device randoms from
`step_generator(device, seed, i)` and text_guided's causal coin from
`np.random.default_rng((seed, i))`, the host stream of the JAX trainer.
Metrics go to <log_dir>/metrics.jsonl.

Options of the JAX CLI whose modules are not ported yet fail loudly, naming
the ROADMAP item: a mesh (dp/tp/sp/fsdp), LoRA, multi-host `--distributed`,
`--profile`, checkpointing (a non-empty save_dir) and wav input
(dataset_dir, which needs MusicDataset and audio I/O).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from jen1_tpu_torch.api.generation import resolve_device
from jen1_tpu_torch.conditioning.conditioners import create_multi_conditioner
from jen1_tpu_torch.config import (
    ROADMAP_MESH, ROADMAP_TRAINING, ROADMAP_WEIGHTS, Config, not_ported,
)
from jen1_tpu_torch.data.dataset import LatentDataset, make_dataloader, train_test_split
from jen1_tpu_torch.diffusion.gdm import create_gaussian_diffusion
from jen1_tpu_torch.diffusion.vdm import create_variational_diffusion
from jen1_tpu_torch.models.unet import unet_from_model_config
from jen1_tpu_torch.ops.initializers import init_module
from jen1_tpu_torch.train.optim import make_lr_schedule
from jen1_tpu_torch.train.trainer import UnifiedMultiTaskTrainer, step_generator
from jen1_tpu_torch.utils.logger import MetricLogger, get_logger


def check_ported(config: Config) -> None:
    """Refuse the settings whose modules the port does not have yet."""
    pc = config.parallel_config
    if pc.dp not in (-1, 1) or pc.tp != 1 or pc.sp != 1 or pc.fsdp:
        raise not_ported("a device mesh (dp/tp/sp/fsdp)", ROADMAP_MESH)
    if config.lora_config.rank > 0:
        raise not_ported("LoRA training", ROADMAP_TRAINING)
    if config.save_dir:
        raise not_ported("checkpointing (save_dir)", ROADMAP_WEIGHTS)


def build_trainer(config: Config, conditioner=None, *, device="cuda") -> UnifiedMultiTaskTrainer:
    """The UNet (weights from `config.seed`), the diffusion, the frozen
    conditioner and the trainer, all on `device`."""
    check_ported(config)
    dev = resolve_device(device)

    def gen(offset: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(config.seed + offset)

    with torch.device(dev):
        model = unet_from_model_config(config.model_config)
    init_module(model, gen(0))
    if config.diffusion_type == "gdm":
        diffusion = create_gaussian_diffusion(
            config.diffusion_config.gaussian_diffusion, device=dev)
    elif config.diffusion_type == "vdm":
        diffusion = create_variational_diffusion(config.diffusion_config.variational_diffusion)
    else:
        raise ValueError(f"unknown diffusion_type {config.diffusion_type!r}")
    if conditioner is None:
        conditioner = create_multi_conditioner(config.conditioner_config, device=dev,
                                               generator=gen(1))
    return UnifiedMultiTaskTrainer(config, model, diffusion, conditioner, device=dev)


def run(config: Config, max_steps: Optional[int] = None, *, device="cuda"):
    """Train over `config.dataset_config.latents_dir`; returns (trainer, state)."""
    check_ported(config)
    dc = config.dataset_config
    if not dc.latents_dir:
        raise not_ported("training from wav files (dataset_dir; needs MusicDataset and "
                          "audio I/O)", ROADMAP_TRAINING)
    logger = get_logger(config.log_dir)
    metrics_logger = MetricLogger(config.log_dir)
    dataset = LatentDataset(dc.latents_dir)
    train_ds, val_ds = train_test_split(dataset, dc.train_test_split, config.seed)
    logger.info(f"dataset: {len(train_ds)} train / {len(val_ds)} val windows")
    if len(train_ds) < dc.batch_size:
        raise ValueError(
            f"train split has {len(train_ds)} windows < batch_size {dc.batch_size}: "
            "with drop_last the loader would yield nothing"
        )

    trainer = build_trainer(config, device=device)
    state = trainer.init_state()
    lr_schedule = make_lr_schedule(config.optimizer_config)
    train_iter = make_dataloader(train_ds, dc.batch_size, shuffle=dc.shuffle,
                                 seed=config.seed, epochs=config.num_epoch)
    try:
        for step_idx, (latents, metadata) in enumerate(train_iter):
            batch = trainer.prepare_batch(latents, metadata)
            t0 = time.time()
            state, m = trainer.train_step(
                state, batch, step_generator(trainer.device, config.seed, step_idx),
                np.random.default_rng((config.seed, step_idx)),
            )
            step = state.step
            if step_idx % max(1, config.grad_accum_every) == 0:
                scalars = {k: float(v) for k, v in m.items()}
                scalars["step_time"] = time.time() - t0
                scalars["lr"] = float(lr_schedule(step // config.grad_accum_every))
                metrics_logger.log(step, scalars)
                logger.info(f"step {step} loss {scalars['loss/train']:.4f} "
                            f"({scalars['step_time']:.2f}s)")
            if config.eval_interval and step % config.eval_interval == 0 and len(val_ds):
                val_iter = make_dataloader(val_ds, dc.batch_size, shuffle=False,
                                           epochs=1, prefetch=0)
                metrics_logger.log(step, trainer.evaluate(state, val_iter, config.seed))
            if max_steps is not None and step_idx + 1 >= max_steps:
                break
    finally:
        train_iter.close()
        metrics_logger.close()
    return trainer, state


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=None, help="JSON config path")
    p.add_argument("--latents-dir", default=None)
    p.add_argument("--dataset-dir", default=None)
    p.add_argument("--save-dir", default=None)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--latents-upload-dtype", default=None, choices=("float32", "bfloat16"))
    # accepted so that they fail loudly, not as unknown arguments
    for flag in ("--dp", "--tp", "--sp"):
        p.add_argument(flag, type=int, default=None)
    for flag in ("--lora-rank", "--lora-alpha", "--lora-base-ckpt"):
        p.add_argument(flag, default=None)
    for flag in ("--fsdp", "--distributed", "--profile"):
        p.add_argument(flag, action="store_true")
    args = p.parse_args(argv)

    if args.distributed:
        raise not_ported("multi-host training (--distributed)", ROADMAP_MESH)
    if args.profile:
        raise not_ported("--profile", ROADMAP_TRAINING)
    if any(v is not None for v in (args.lora_rank, args.lora_alpha, args.lora_base_ckpt)):
        raise not_ported("LoRA training", ROADMAP_TRAINING)
    config = Config.from_json(args.config) if args.config else Config()
    dc, pc = config.dataset_config, config.parallel_config
    if args.latents_dir:
        dc.latents_dir = args.latents_dir
    if args.dataset_dir:
        dc.dataset_dir = args.dataset_dir
    if args.latents_upload_dtype:
        dc.latents_upload_dtype = args.latents_upload_dtype
    if args.save_dir:
        config.save_dir = args.save_dir
    if args.log_dir:
        config.log_dir = args.log_dir
    for name in ("dp", "tp", "sp"):
        if getattr(args, name) is not None:
            setattr(pc, name, getattr(args, name))
    if args.fsdp:
        pc.fsdp = True
    run(config, max_steps=args.max_steps, device=args.device)


if __name__ == "__main__":
    main()
