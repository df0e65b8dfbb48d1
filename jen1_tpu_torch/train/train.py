"""Training entry point (port of jen1_tpu/train/train.py).

    python -m jen1_tpu_torch.train.train --config cfg.json \
        (--latents-dir d | --dataset-dir d) --max-steps N [--device cpu] \
        [--log-dir logs] [--save-dir ckpts] [--profile] \
        [--lora-rank r [--lora-alpha a] [--lora-base-ckpt base]] \
        [--distributed [--dp N] [--sp N] [--tp N] [--fsdp]]

    torchrun --nproc_per_node N -m jen1_tpu_torch.train.train --distributed ...

Trains `UnifiedMultiTaskTrainer` on one device ("cuda" unless asked
otherwise), with weights random from `config.seed`, over precomputed
latents (<dir>/<name>.npy, (frames, C)) or, with a dataset_dir and no
latents_dir, over the audio files of <dataset_dir>/audios (`MusicDataset`):
each batch of windows is encoded on the trainer's device by one codec per
process (`config.codec_weights_path`; the segmented encoder with
`codec_segmented_latents`), and so is the validation set. With
`lora_config.rank > 0` (`--lora-rank`) it trains a LoRA adapter over a
frozen base (`train/lora.py::LoRATrainer`; `--lora-base-ckpt` names the
base, else it is random from the seed), and the checkpoints hold the
adapter alone: generate with `Jen1(ckpt_path=<base>, lora_path=<save_dir>)`.
`--profile` records steps 2-4 (after two warm-up steps, in which the
kernels build and cuDNN picks its algorithms) with `torch.profiler`, every
thread, into a Chrome-trace JSON in log_dir (`utils/profiling.py`); each
step is annotated `train_step` (and `encode`), its phases
`train.prepare_batch`, `train.draws`, `forward_backward`, `optimizer` and
`train.ema`, and the loader's wait `data.wait`.

Step `i` draws its device randoms from `step_generator(device, seed, i)`
and text_guided's causal coin from `np.random.default_rng((seed, i))`, the
host stream of the JAX trainer.
Metrics go to <log_dir>/metrics.jsonl.

With a save_dir, every `eval_interval` steps whose validation loss beats
the best so far save the whole train state (`ckpt/checkpoint.py`, the 3
lowest-loss steps kept, `best_val` in the metadata). A run whose save_dir
holds a checkpoint resumes from its latest step: the state and `best_val`
are restored and the loader skips the batches already taken, so, since
every draw is a function of (seed, step), the resumed run replays the
unbroken one. `max_steps` counts the steps of this invocation.

With `--distributed` the process group comes up from the torchrun
environment (NCCL on cuda:LOCAL_RANK, gloo with --device cpu), and the
trainer runs over the mesh of `parallel_config` (`--dp/--sp/--tp/--fsdp`;
dp -1 takes the rest of the world). Every rank loads the same global batch
(the loader's seed is the run's) and keeps its rows (`trainer.local_rows`)
and, under sp, its frames of the latents; in wav mode each rank encodes only
its own rows. Logs, metrics and checkpoint
files come from rank 0; every rank gathers the checkpoint's state and reads
it back on resume. A mesh needs the process group: without one, any dp, tp,
sp or fsdp setting raises.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from jen1_tpu_torch.api.generation import resolve_device
from jen1_tpu_torch.ckpt.checkpoint import CheckpointManager
from jen1_tpu_torch.conditioning.conditioners import create_multi_conditioner
from jen1_tpu_torch.config import Config
from jen1_tpu_torch.data.dataset import (
    LatentDataset,
    MusicDataset,
    make_dataloader,
    train_test_split,
)
from jen1_tpu_torch.diffusion.gdm import create_gaussian_diffusion
from jen1_tpu_torch.diffusion.vdm import create_variational_diffusion
from jen1_tpu_torch.models.unet import unet_from_model_config
from jen1_tpu_torch.ops.initializers import init_module
from jen1_tpu_torch.parallel.mesh import init_distributed, make_mesh
from jen1_tpu_torch.train.optim import make_lr_schedule
from jen1_tpu_torch.train.trainer import UnifiedMultiTaskTrainer, step_generator
from jen1_tpu_torch.utils.logger import MetricLogger, get_logger
from jen1_tpu_torch.utils.profiling import annotate, start_trace, stop_trace

PROFILE_STEPS = (2, 4)  # the first and last step --profile records

_CODEC = {}


def get_codec(config: Config, device):
    """The process-wide codec of wav -> latent training on `device`
    (jen1_tpu/train/train.py:43-54): `config.codec_weights_path`, or random
    with a warning."""
    key = (config.codec_weights_path, str(device))
    if key not in _CODEC:
        from jen1_tpu_torch.codec.model import make_codec

        _CODEC[key] = make_codec(config.codec_weights_path, device=device,
                                 warn_context="training (wav->latent)")
    return _CODEC[key]


def music_dataset(config: Config) -> MusicDataset:
    dc = config.dataset_config
    return MusicDataset(
        dataset_dir=dc.dataset_dir, sr=dc.sr, channels=dc.channels,
        min_duration=dc.min_duration, max_duration=dc.max_duration,
        sample_duration=dc.sample_duration, aug_shift=dc.aug_shift,
        durations_path=dc.durations_path, cumsum_path=dc.cumsum_path,
        audio_file_txt_path=dc.audio_file_txt_path)


def latent_encoder(config: Config, device):
    """batch (B, T, ch) numpy audio -> (B, frames, D) numpy latents on the
    trainer's device, or None when the dataset holds latents."""
    if config.dataset_config.latents_dir:
        return None
    codec = get_codec(config, device)
    encode = (codec.encode_latent_segmented if config.codec_segmented_latents
              else codec.encode_latent)

    def run(audio):
        return encode(torch.as_tensor(np.asarray(audio, np.float32), device=device)).cpu().numpy()

    return run


def run_mesh(config: Config):
    """The DeviceMesh of `config.parallel_config` over the process group that
    is up, or None without one."""
    pc = config.parallel_config
    return make_mesh(dp=pc.dp, tp=pc.tp, sp=pc.sp) if dist.is_initialized() else None


def build_trainer(config: Config, conditioner=None, *, device="cuda",
                  mesh=None) -> UnifiedMultiTaskTrainer:
    """The UNet (weights from `config.seed`), the diffusion, the frozen
    conditioner and the trainer, all on `device`: a `LoRATrainer` (adapter
    from seed + 0x10AA) when `config.lora_config.rank > 0`. With `mesh` the
    trainer shards the full weights over it; without one any dp, tp, sp or
    fsdp setting raises."""
    pc = config.parallel_config
    if mesh is None and (pc.dp not in (-1, 1) or pc.tp != 1 or pc.sp != 1 or pc.fsdp):
        raise ValueError("a device mesh (dp/tp/sp/fsdp) needs a process group: run under "
                         "torchrun with --distributed (or pass a make_mesh() mesh)")
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
    if config.lora_config.rank > 0:
        from jen1_tpu_torch.train.lora import LoRATrainer

        return LoRATrainer(config, model, diffusion, conditioner, device=dev,
                           generator=gen(0x10AA), mesh=mesh)
    return UnifiedMultiTaskTrainer(config, model, diffusion, conditioner, device=dev, mesh=mesh)


def run(config: Config, max_steps: Optional[int] = None, *, device="cuda",
        profile: bool = False, distributed: bool = False):
    """Train over `config.dataset_config.latents_dir`, or the audio of its
    dataset_dir; returns (trainer, state). `profile` records steps 2-4
    into a trace in log_dir (on rank 0). `distributed` brings up the process
    group from the torchrun environment; with a group up the trainer runs
    over `config.parallel_config`'s mesh."""
    dc = config.dataset_config
    if not dc.latents_dir and not dc.dataset_dir:
        raise ValueError("set dataset_config.latents_dir or dataset_config.dataset_dir")
    if distributed:
        device = init_distributed(device)
    mesh = run_mesh(config)
    rank0 = mesh is None or dist.get_rank() == 0
    log_dir = config.log_dir if rank0 else None
    logger = get_logger(log_dir)
    metrics_logger = MetricLogger(log_dir)
    if mesh is not None:
        logger.info(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
                    f"{dist.get_world_size()} ranks ({dist.get_backend()})")
    dataset = LatentDataset(dc.latents_dir) if dc.latents_dir else music_dataset(config)
    train_ds, val_ds = train_test_split(dataset, dc.train_test_split, config.seed)
    logger.info(f"dataset: {len(train_ds)} train / {len(val_ds)} val windows")
    if len(train_ds) < dc.batch_size:
        raise ValueError(
            f"train split has {len(train_ds)} windows < batch_size {dc.batch_size}: "
            "with drop_last the loader would yield nothing"
        )

    trainer = build_trainer(config, device=device, mesh=mesh)
    encode = latent_encoder(config, trainer.device)
    if encode is not None:
        # the probe batch: the codec is built and run once before the loop
        probe, _ = train_ds[0]
        logger.info(f"wav -> latent: {probe.shape} audio -> {encode(probe[None]).shape[1:]}")
    state = trainer.init_state()
    ckpt = CheckpointManager(config.save_dir) if config.save_dir else None
    start_step, best_val = 0, float("inf")
    if ckpt is not None and ckpt.latest_step() is not None:
        saved, meta = ckpt.restore(map_location=trainer.device)
        state = trainer.load_state_dict(saved)
        start_step = state.step
        best_val = float(meta.get("best_val", float("inf")))
        logger.info(f"resumed from step {start_step} (best_val {best_val:.4f})")
    lr_schedule = make_lr_schedule(config.optimizer_config)
    # one batch per train_step and state.step counts train_steps: skipping
    # start_step batches puts the loader where the saved run was
    train_iter = make_dataloader(train_ds, dc.batch_size, shuffle=dc.shuffle,
                                 seed=config.seed, epochs=config.num_epoch,
                                 skip_batches=start_step)
    tracing = False
    try:
        for step_idx, (latents, metadata) in enumerate(train_iter):
            gstep = start_step + step_idx
            latents, metadata = trainer.local_rows(latents, metadata)
            if profile and rank0 and step_idx == PROFILE_STEPS[0]:
                start_trace(config.log_dir or "profile")
                tracing = True
            with annotate("train_step"):
                t_enc = time.time()
                if encode is not None:
                    with annotate("encode"):
                        latents = encode(latents)
                batch = trainer.prepare_batch(latents, metadata)
                t0 = time.time()
                state, m = trainer.train_step(
                    state, batch, step_generator(trainer.device, config.seed, gstep),
                    np.random.default_rng((config.seed, gstep)),
                )
            step = state.step
            if gstep % max(1, config.grad_accum_every) == 0:
                scalars = {k: float(v) for k, v in m.items()}
                scalars["step_time"] = time.time() - t0
                if encode is not None:
                    scalars["encode_time"] = t0 - t_enc
                scalars["lr"] = float(lr_schedule(step // config.grad_accum_every))
                metrics_logger.log(step, scalars)
                logger.info(f"step {step} loss {scalars['loss/train']:.4f} "
                            f"({scalars['step_time']:.2f}s)")
            if tracing and step_idx == PROFILE_STEPS[1]:
                tracing = False
                logger.info(f"trace of steps {PROFILE_STEPS[0]}-{PROFILE_STEPS[1]}: "
                            f"{stop_trace()}")
            if config.eval_interval and step % config.eval_interval == 0 and len(val_ds):
                val_iter = (trainer.local_rows(lat, meta) for lat, meta in make_dataloader(
                    val_ds, dc.batch_size, shuffle=False, epochs=1, prefetch=0))
                if encode is not None:
                    val_iter = ((encode(lat), meta) for lat, meta in val_iter)
                val_metrics = trainer.evaluate(state, val_iter, config.seed)
                metrics_logger.log(step, val_metrics)
                val_loss = val_metrics.get("loss/val", float("inf"))
                if ckpt is not None and val_loss < best_val:
                    best_val = val_loss
                    ckpt.save(step, trainer.state_dict(state), loss=val_loss,
                              learning_rate=config.optimizer_config.lr,
                              extra_meta={"best_val": best_val})
                    logger.info(f"saved best checkpoint at step {step} (val {val_loss:.4f})")
            if max_steps is not None and step_idx + 1 >= max_steps:
                break
    finally:
        if tracing:
            logger.info(f"trace of steps {PROFILE_STEPS[0]}-{step_idx}: {stop_trace()}")
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
    p.add_argument("--lora-rank", type=int, default=None,
                   help="train a rank-r LoRA adapter instead of every parameter")
    p.add_argument("--lora-alpha", type=float, default=None,
                   help="LoRA scale numerator (scale = alpha / rank)")
    p.add_argument("--lora-base-ckpt", default=None,
                   help="frozen base: a checkpoint directory of this package or a "
                        "reference .pth")
    p.add_argument("--profile", action="store_true",
                   help="record steps 2-4 with torch.profiler into log_dir")
    p.add_argument("--dp", type=int, default=None, help="data-parallel size")
    p.add_argument("--tp", type=int, default=None, help="tensor-parallel size")
    p.add_argument("--sp", type=int, default=None,
                   help="sequence-parallel size (the latent's length)")
    p.add_argument("--fsdp", action="store_true",
                   help="FSDP2 parameter and optimizer sharding over dp")
    p.add_argument("--distributed", action="store_true",
                   help="bring up the process group from the torchrun environment")
    args = p.parse_args(argv)

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
    lc = config.lora_config
    if args.lora_rank is not None:
        lc.rank = args.lora_rank
    if args.lora_alpha is not None:
        lc.alpha = args.lora_alpha
    if args.lora_base_ckpt is not None:
        lc.base_ckpt = args.lora_base_ckpt
    was_up = dist.is_initialized()
    try:
        run(config, max_steps=args.max_steps, device=args.device, profile=args.profile,
            distributed=args.distributed)
    finally:
        if dist.is_initialized() and not was_up:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
