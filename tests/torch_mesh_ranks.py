"""Multi-process runs of jen1_tpu_torch over a gloo mesh on the CPU, for
tests/test_torch_mesh.py and tests/test_torch_mesh_entry.py; run as a
script under torchrun, the same train comparisons over NCCL on GPUs:

    PYTHONPATH=. torchrun --standalone --nproc_per_node 4 tests/torch_mesh_ranks.py [cpu]

`spawn(fn, world, tmp_path, *args)` starts `world` processes (the "spawn"
start method, so `fn` lives here, where a child can import it; this module
imports no JAX). Each runs at one torch thread, joins a gloo group through a
`FileStore` in `tmp_path` (no TCP port, so parallel test workers cannot
collide) with a timeout, calls `fn(rank, world, *args)` and saves what it
returns; the parent waits until a deadline, then kills what is left and
fails. The rank functions build every model from a seed and every batch from
numpy, so each rank and the single-process reference see the same weights,
batches and draws.
"""

from __future__ import annotations

import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

GROUP_TIMEOUT = timedelta(seconds=90)
SEED = 3
LENGTH = 48


# ------------------------------------------------------------- harness


def _entry(fn, rank: int, world: int, tmp: str, args) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = Path(tmp) / f"rank{rank}.pt"
    try:
        store = dist.FileStore(str(Path(tmp) / "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                                timeout=GROUP_TIMEOUT)
        result = fn(rank, world, *args)
        dist.barrier()
        dist.destroy_process_group()
        torch.save({"result": result}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise


def spawn(fn, world: int, tmp_path, *args, deadline: float = 240.0):
    """[fn's result on rank r for r in range(world)]; raises if a rank
    failed or the deadline passed."""
    import torch.multiprocessing as mp

    tmp = Path(tmp_path) / f"spawn-{fn.__name__}-{time.monotonic_ns()}"
    tmp.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, str(tmp), args))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    outs = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            if (tmp / f"rank{r}.pt").exists() else {"error": f"rank {r} wrote nothing"}
            for r in range(world)]
    errors = [f"rank {r}: {o['error']}" for r, o in enumerate(outs) if "error" in o]
    if hung or errors:
        raise AssertionError(f"ranks {hung} passed the {deadline:.0f} s deadline; "
                             + "\n".join(errors))
    return [o["result"] for o in outs]


# ------------------------------------------------------- trainer runs


def train_config(lora_rank: int = 0, fsdp: bool = False, remat: bool = False,
                 flatten: bool = False):
    """tiny_test_config (two heads, so tp=2 splits attention) with a batch
    of 6: the three tasks' sub-batches of 2 split over dp=2; with `remat`,
    also the recomputed blocks and an EMA; with `flatten`, the optax chain
    over one flat vector."""
    import dataclasses

    from jen1_tpu_torch.config import tiny_test_config

    cfg = tiny_test_config()
    cfg.dataset_config.batch_size = 6
    cfg.parallel_config.fsdp = fsdp
    cfg.model_config = dataclasses.replace(cfg.model_config, remat=remat)
    cfg.use_ema = remat
    cfg.optimizer_config.fused_adamw = not flatten
    cfg.optimizer_config.flatten_optimizer = flatten
    cfg.lora_config.rank = lora_rank
    cfg.lora_config.alpha = 8.0
    return cfg


def global_batch(cfg, step: int):
    """The step's global batch, from numpy."""
    mc = cfg.model_config
    g = np.random.default_rng((SEED, step))
    b, m = cfg.dataset_config.batch_size, mc.context_embedding_max_length
    mask = np.ones((b, m), bool)
    mask[::2, m // 2:] = False
    return {
        "latents": g.standard_normal((b, LENGTH, mc.in_channels)).astype(np.float32),
        "text_emb": g.standard_normal((b, m, mc.context_embedding_features)).astype(np.float32),
        "text_mask": mask,
    }


def build(cfg, mesh=None, device="cpu"):
    """The seeded tiny UNet and its (LoRA) trainer on `device`."""
    from jen1_tpu_torch.train.train import build_trainer

    class NoConditioner:  # the batches carry their text embeddings
        pass

    return build_trainer(cfg, NoConditioner(), device=device, mesh=mesh)


def run_steps(trainer, cfg, steps: int, state=None):
    """`steps` train steps over the global batches, each rank on its rows;
    (state, [loss per step], [gradient norm per step]). The norm is the one
    AdamW clips with: with grad_clip 0.7 clipping rescales every update, so
    only the norm shows a wrong scale of the averaged gradients."""
    from jen1_tpu_torch.train.trainer import step_generator

    state = state or trainer.init_state()
    losses, norms = [], []
    for i in range(steps):
        batch = global_batch(cfg, i)
        lat, _ = trainer.local_rows(batch["latents"], [None] * len(batch["latents"]))
        emb, mask = (trainer.local_rows(batch[k], [None] * len(batch[k]))[0]
                     for k in ("text_emb", "text_mask"))
        local = {"latents": trainer.local_frames(torch.from_numpy(lat)),
                 "text_emb": torch.from_numpy(emb), "text_mask": torch.from_numpy(mask)}
        local = {k: v.to(trainer.device) for k, v in local.items()}
        state, m = trainer.train_step(state, local, step_generator(trainer.device, cfg.seed, i),
                                      np.random.default_rng((cfg.seed, i)))
        losses.append(float(m["loss/train"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms


def full_state(trainer, state):
    """The gathered train state, as numpy-free CPU tensors."""
    return {k: v.detach().cpu().clone() for k, v in trainer.state_dict(state).items()}


def mesh_train(rank, world, dp, sp, tp, fsdp, steps, reference_path=None, remat=False,
               device="cpu"):
    """`steps` steps over a (dp, sp, tp) mesh. With `reference_path`, also
    the single-process reference's final state loaded into the mesh trainer
    and gathered back, `flatten_optimizer` under three meshes, and a LoRA
    trainer over the same mesh. Rank 0 returns everything."""
    from jen1_tpu_torch.parallel.mesh import make_mesh, sharded_axes

    mesh = make_mesh(dp=dp, tp=tp, sp=sp)
    cfg = train_config(fsdp=fsdp, remat=remat)
    trainer = build(cfg, mesh, device)
    state, losses, norms = run_steps(trainer, cfg, steps)
    out = {"losses": losses, "grad_norms": norms, "state": full_state(trainer, state),
           "sharded": {axis: sorted(n for n, p in trainer.model.named_parameters()
                                    if axis in sharded_axes(p)) for axis in ("dp", "tp")}}
    if reference_path is not None:
        out["flatten"] = flatten_under_meshes(world)
        ref = torch.load(reference_path, weights_only=True)
        out["reloaded"] = full_state(trainer, trainer.load_state_dict(ref))
        lcfg = train_config(lora_rank=4, fsdp=fsdp, remat=remat)
        lora = build(lcfg, mesh)
        lstate, out["lora_losses"], out["lora_grad_norms"] = run_steps(lora, lcfg, 2)
        out["lora_state"] = full_state(lora, lstate)
    return out if rank == 0 else None


def flatten_under_meshes(world):
    """`flatten_optimizer` as a chain trainer resolves it over a dp-only
    mesh, a tp mesh and an fsdp mesh, and the dp-only mesh's losses and
    state after two steps of the flat chain."""
    from jen1_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for key, tp, fsdp in (("dp4", 1, False), ("dp2_tp2", 2, False), ("dp4_fsdp", 1, True)):
        cfg = train_config(fsdp=fsdp, flatten=True)
        trainer = build(cfg, make_mesh(dp=world // tp, tp=tp))
        out[key] = trainer.optimizer.flatten
        if key == "dp4":
            cfg.dataset_config.batch_size = 12  # the tasks' sub-batches of 4 over dp=4
            state, losses, norms = run_steps(trainer, cfg, 2)
            out["dp4_run"] = (losses, norms, full_state(trainer, state))
    return out


def single_train(cfg_kw, steps, device="cpu"):
    """The single-process reference of `mesh_train`'s runs: (trainer,
    state, losses, gradient norms). fsdp needs a mesh and changes no value,
    so it is off here."""
    cfg = train_config(**{**cfg_kw, "fsdp": False})
    trainer = build(cfg, device=device)
    return (trainer, *run_steps(trainer, cfg, steps))


# ------------------------------------------------------- generation runs


def quantize(jen) -> None:
    """Every stride-1 conv of `jen`'s UNet on int8 weights (K4's path)."""
    from jen1_tpu_torch.ops.int8_matmul import attach_qweights, quantize_conv_params

    attach_qweights(jen.model, quantize_conv_params(jen.model, min_weight_bytes=0,
                                                    min_weight_bytes_k1=0))


def mesh_generate(rank, world, jen1_path, noise_path, kwargs, sp=1, refused_kwargs=None):
    """A saved port Jen1 over a (world / sp, sp, 1) mesh: its
    generate(**kwargs), the VDM's x_T replaced by the saved noise when there
    is one. Without sp, then the same request with int8 weights; with
    `refused_kwargs`, the error a generate(**those) raises and
    `int8_unet_forward`."""
    from jen1_tpu_torch.diffusion import vdm
    from jen1_tpu_torch.parallel.mesh import make_mesh

    if noise_path is not None:
        noise = torch.load(noise_path, weights_only=True)
        vdm.initial_noise = lambda shape, generator, device: noise
    jen = torch.load(jen1_path, weights_only=False)
    jen.mesh = make_mesh(dp=world // sp, sp=sp)
    out = jen.generate(**kwargs)
    if refused_kwargs is None:
        quantize(jen)
        return out, jen.generate(**kwargs)
    try:
        jen.generate(**refused_kwargs)
        refused = None
    except ValueError as e:
        refused = str(e)
    return out, refused, int8_unet_forward(jen)


def int8_unet_forward(jen, length: int = 64):
    """The UNet with every stride-1 conv on int8 weights, once over the
    whole length and once sequence-parallel over the mesh's sp axis (the
    output gathered), on one seeded input: (whole, sharded)."""
    from jen1_tpu_torch.parallel import sp as seq

    quantize(jen)
    model, mc = jen.model, jen.config.model_config
    g = torch.Generator().manual_seed(SEED)
    x = torch.randn((1, length, mc.in_channels), generator=g)
    ch = torch.randn((1, length, mc.context_channels[0]), generator=g)
    emb = torch.randn((1, mc.context_embedding_max_length, mc.context_embedding_features),
                      generator=g)
    t = torch.full((1,), 0.3)
    with torch.no_grad():
        whole = model(x, t, embedding=emb, channels_list=[ch])
        with seq.sequence_parallel(jen.mesh) as sp:
            frames = seq.length_slice(length, sp)
            sharded = seq.gather_length(model(x[:, frames], t, embedding=emb,
                                              channels_list=[ch[:, frames]]))
    return whole, sharded


def cli_main(rank, world, module: str, argv):
    """`python -m <module> <argv>` in each rank of the group that is up."""
    import importlib

    importlib.import_module(module).main(list(argv))



# (dp, sp, tp, fsdp, remat) over four ranks
LAYOUTS_4 = ((2, 1, 2, True, True), (1, 2, 2, False, False), (2, 2, 1, True, False))


def main(device_type: str = "cuda") -> int:
    """Under torchrun (four ranks: NCCL on cuda:LOCAL_RANK, or gloo with
    device_type "cpu"): each layout of
    LAYOUTS_4 trains 3 steps over its mesh, then rank 0 trains the
    single-process port on its card and prints, per layout, one JSON line
    with the largest relative differences of the losses and of the gradient
    norms and the parameters that miss the dryrun bars (rtol 1e-4 / atol
    5e-6; losses and norms rtol 5e-5). Exits 1 if any does."""
    import json

    import torch.distributed as dist

    from jen1_tpu_torch.parallel.mesh import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    if device_type == "cpu":
        torch.set_num_threads(1)
    device = init_distributed(device_type)
    rank, world = dist.get_rank(), dist.get_world_size()
    failed = False
    for dp, sp, tp, fsdp, remat in LAYOUTS_4:
        out = mesh_train(rank, world, dp, sp, tp, fsdp, 3, None, remat, device)
        if rank == 0:
            trainer, state, losses, norms = single_train({"remat": remat}, 3, device)
            ref = full_state(trainer, state)
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(out["losses"], losses))
            norm_rel = max(abs(a - b) / abs(b) for a, b in zip(out["grad_norms"], norms))
            missed = [k for k in ref if k.startswith(("params/", "ema_params/"))
                      and not torch.allclose(out["state"][k], ref[k], rtol=1e-4, atol=5e-6)]
            worst = max((float((out["state"][k] - ref[k]).abs().max()), k)
                        for k in ref if k.startswith("params/"))
            ok = loss_rel <= 5e-5 and norm_rel <= 5e-5 and not missed
            failed |= not ok
            print(json.dumps({"layout": {"dp": dp, "sp": sp, "tp": tp, "fsdp": fsdp,
                                         "remat": remat}, "backend": dist.get_backend(),
                              "device": (torch.cuda.get_device_name(device)
                                         if device.type == "cuda" else "cpu"),
                              "losses": out["losses"], "loss_rel_max": loss_rel,
                              "grad_norms": out["grad_norms"], "grad_norm_rel_max": norm_rel,
                              "params_missing_the_bars": missed[:5], "worst_param": worst,
                              "ok": ok}), flush=True)
        dist.barrier()
    dist.destroy_process_group()
    return int(failed)


if __name__ == "__main__":
    import sys

    raise SystemExit(main(*sys.argv[1:]))
