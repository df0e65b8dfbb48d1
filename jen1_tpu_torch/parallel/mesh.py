"""Device mesh and sharding rules on torch.distributed (port of
jen1_tpu/parallel/mesh.py).

The mesh is (dp, sp, tp), built with `init_device_mesh` over an initialized
process group (`init_distributed`: NCCL for "cuda", gloo for "cpu"; the
backend follows the device and never falls back to the other).

  * dp shards the batch. Each rank takes its rows of every task's
    sub-batch (`shard_batch`), so a per-task mean over its rows, averaged
    over dp, is the single-process mean; the trainer averages gradients
    over dp.
  * tp is the Megatron split of `_TP_RULES` (column-parallel to_q / to_kv /
    linear1, row-parallel to_out / linear2), applied with DTensor's
    `parallelize_module` where the dimension divides. The attention
    projections split only where `num_heads % tp == 0`: a split off the head
    boundaries could not feed a per-rank attention kernel (JAX splits on
    divisibility alone; the result is the same). Every module keeps plain
    local tensors at its boundary (`use_local_output`), so the attention
    core, the flash kernel included, sees `num_heads / tp` local heads.
    to_kv's rows are laid out per rank as [k_r; v_r] (`shard_params`), and
    the gathers for checkpoints (`full_tensor`) undo it.
  * fsdp shards every parameter that tp did not take over dp, on its
    largest divisible dimension in the flax layout (JAX's rule), with FSDP2
    `fully_shard`; the rest stay replicated.

`param_shardings` is the plan, one spec per parameter in torch layout: a
tuple with the mesh axis that shards each dimension, or None.
"""

from __future__ import annotations

import dataclasses
import os
import re
from datetime import timedelta
from typing import Any, Dict, Mapping, Optional, Sequence, Set, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

AXES = ("dp", "sp", "tp")
DEFAULT_TIMEOUT = timedelta(minutes=10)


def init_distributed(device="cuda", *, store=None, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout: timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Bring up the default process group and return this rank's device:
    cuda:LOCAL_RANK (made current) for "cuda", the CPU for "cpu". The group
    comes from `store` (with `rank` and `world_size`) or else from a torchrun
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT). A group that
    is already up is kept; its backend must be the device's."""
    dev = torch.device(device)
    backend = {"cuda": "nccl", "cpu": "gloo"}.get(dev.type)
    if backend is None:
        raise ValueError(f"no process-group backend for device {device!r}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed('cuda') needs a CUDA device; pass "
                               "device='cpu' for gloo on the CPU")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", dev.index or 0)))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, device "
                               f"{dev} needs {backend}")
        return dev
    if store is not None:
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                                timeout=timeout)
        return dev
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"init_distributed needs a torchrun environment ({', '.join(missing)} "
                           "unset) or an explicit store")
    dist.init_process_group(backend, init_method="env://", timeout=timeout)
    return dev


def mesh_shape(world: int, dp: int = -1, tp: int = 1, sp: int = 1) -> Tuple[int, int, int]:
    """(dp, sp, tp) over `world` ranks; dp=-1 takes world / (tp * sp). The
    JAX package's checks (jen1_tpu/parallel/mesh.py:37-42), and the mesh
    must use every rank of the process group."""
    if dp == -1:
        if world % (tp * sp):
            raise ValueError(f"{world} devices not divisible by tp*sp")
        dp = world // (tp * sp)
    used = dp * sp * tp
    if used > world:
        raise ValueError(f"dp*sp*tp({used}) > available devices({world})")
    if used < world:
        raise ValueError(f"dp*sp*tp({used}) < the process group's {world} ranks: a "
                         "torch.distributed mesh spans every rank")
    return dp, sp, tp


def make_mesh(dp: int = -1, tp: int = 1, sp: int = 1):
    """The ("dp", "sp", "tp") DeviceMesh over the initialized process group,
    on the backend's device type ("cuda" for NCCL, "cpu" for gloo)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group (init_distributed)")
    from torch.distributed.device_mesh import init_device_mesh

    shape = mesh_shape(dist.get_world_size(), dp, tp, sp)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=AXES)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a DeviceMesh or of a mapping such as {"dp": 2, "tp": 2}."""
    if isinstance(mesh, Mapping):
        sizes = dict(mesh)
    else:
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: int(sizes.get(a, 1)) for a in AXES}


def _placements(spec: Sequence[Optional[str]]):
    """DTensor placements over the mesh's axes for a spec of (B, L, ...)."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(spec.index(a)) if a in spec else Replicate() for a in AXES)


def replicated(mesh):
    return _placements(())


def batch_sharding(mesh):
    """Leading (batch) axis over dp, the rest replicated."""
    return _placements(("dp",))


def seq_sharding(mesh):
    """(B, L, C): batch over dp, length over sp."""
    return _placements(("dp", "sp"))


def local_rows(batch: int, dp: int, rank: int, n_tasks: int = 1) -> np.ndarray:
    """Indices of rank `rank`'s rows of a batch of `batch` rows made of
    `n_tasks` equal sub-batches: the rank's contiguous 1/dp of each."""
    if batch % n_tasks:
        raise ValueError(f"batch size {batch} is not divisible by the {n_tasks} tasks")
    sub = batch // n_tasks
    if sub % dp:
        raise ValueError(f"each task's sub-batch of {sub} rows is not divisible by dp={dp}")
    per = sub // dp
    return np.concatenate([np.arange(t * sub + rank * per, t * sub + (rank + 1) * per)
                           for t in range(n_tasks)])


def shard_batch(batch, mesh, n_tasks: int = 1):
    """This rank's rows of every leaf (a tensor, an array or a list of rows)
    of `batch`, a leaf or a dict or tuple of leaves; task-aware
    (`local_rows`)."""
    dp = axis_sizes(mesh)["dp"]
    rank = mesh.get_local_rank("dp") if dp > 1 else 0

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(take(v) for v in x)
        if dp == 1:
            return x
        idx = local_rows(len(x), dp, rank, n_tasks)
        if isinstance(x, torch.Tensor):
            return x[torch.as_tensor(idx, device=x.device)]
        if isinstance(x, np.ndarray):
            return x[idx]
        return [x[i] for i in idx]

    return take(batch)


def gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every dp rank's rows of `t`, concatenated in rank order (an
    all-gather over dp, which runs at dp = 1 too)."""
    group = mesh.get_group("dp")
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=0)


# Tensor-parallel rules over the "/"-joined flax parameter path, with the
# flax-layout spec (jen1_tpu/parallel/mesh.py:72-79).
_TP_RULES = (
    (re.compile(r"(to_q|to_kv)/kernel$"), (None, "tp")),
    (re.compile(r"attention/to_out/kernel$"), ("tp", None)),
    (re.compile(r"cross_attention/to_out/kernel$"), ("tp", None)),
    (re.compile(r"feed_forward/linear1/kernel$"), (None, "tp")),
    (re.compile(r"feed_forward/linear1/bias$"), ("tp",)),
    (re.compile(r"feed_forward/linear2/kernel$"), ("tp", None)),
)
# the attention projections, split only on head boundaries
_HEAD_SPLIT = re.compile(r"(to_q|to_kv|to_out)/kernel$")


def _flax_path_and_dims(module: nn.Module, name: str, ndim: int) -> Tuple[str, Tuple[int, ...]]:
    """The "/"-joined flax path of torch parameter `name` of `module`'s
    tree, and for each flax dimension the torch dimension it is (the
    layouts of ckpt/from_jax.py)."""
    from jen1_tpu_torch.codec.seanet import SConvTranspose1d
    from jen1_tpu_torch.ops.conv import Upsample1d  # the ops import this module's package

    mod, _, leaf = name.rpartition(".")
    dims = tuple(range(ndim))
    if leaf == "weight":
        leaf = "kernel" if ndim >= 2 else "scale"
        if ndim == 2:
            dims = (1, 0)  # (in, out) <- (out, in)
        elif ndim == 3:
            owner = module.get_submodule(mod) if mod else module
            transposed = isinstance(owner, SConvTranspose1d) or (
                isinstance(owner, Upsample1d) and owner.transposed)
            # (K, in, out) <- ConvT (in, out, K) or Conv (out, in, K)
            dims = (2, 0, 1) if transposed else (2, 1, 0)
    path = "/".join(mod.split(".") + [leaf]) if mod else leaf
    return path, dims


def _flax_spec(path: str, shape: Tuple[int, ...], tp: int, fsdp: int,
               heads_ok: bool) -> Tuple[Optional[str], ...]:
    """jen1_tpu/parallel/mesh.py::_spec_for_path over the flax shape, with the
    port's head-boundary rule; fsdp is the dp size, 0 without fsdp."""
    if tp > 1:
        for pattern, spec in _TP_RULES:
            if (pattern.search(path)
                    and all(name != "tp" or dim % tp == 0 for dim, name in zip(shape, spec))
                    and (heads_ok or not _HEAD_SPLIT.search(path))):
                return spec
    if fsdp:
        best = max((d for d, n in enumerate(shape) if n % fsdp == 0 and n > 1),
                   key=lambda d: shape[d], default=None)
        if best is not None:
            return tuple("dp" if d == best else None for d in range(len(shape)))
    return (None,) * len(shape)


def param_shardings(model: nn.Module, mesh, fsdp: bool = False
                    ) -> Dict[str, Tuple[Optional[str], ...]]:
    """{torch parameter name: spec in torch layout}: the Megatron tp rules
    on the attention / FFN projections and, with `fsdp`, every other
    parameter over dp on its largest divisible flax dimension. `mesh` is a
    DeviceMesh or a mapping of axis sizes; a dp of 1 under fsdp still gives
    the spec (a Shard over one rank, which FSDP2 wraps)."""
    from jen1_tpu_torch.ops.attention import Attention

    sizes = axis_sizes(mesh)
    tp, fsdp_size = sizes["tp"], (sizes["dp"] if fsdp else 0)
    plan = {}
    for name, p in model.named_parameters():
        path, dims = _flax_path_and_dims(model, name, p.ndim)
        flax_shape = tuple(p.shape[d] for d in dims)
        heads_ok = True
        if _HEAD_SPLIT.search(path) and name.count(".") >= 2:
            owner = model.get_submodule(name.rsplit(".", 2)[0])
            heads_ok = not isinstance(owner, Attention) or owner.num_heads % tp == 0
        fspec = _flax_spec(path, flax_shape, tp, fsdp_size, heads_ok)
        spec = [None] * p.ndim
        for j, axis in enumerate(fspec):
            spec[dims[j]] = axis
        plan[name] = tuple(spec)
    return plan


@dataclasses.dataclass
class MeshPlan:
    """What `shard_params` did that a gather must undo: the to_kv weights
    whose rows it interleaved as [k_0; v_0; k_1; v_1; ...]."""

    mesh: Any
    kv_interleaved: Set[str]

    @property
    def tp(self) -> int:
        return axis_sizes(self.mesh)["tp"]


def _kv_interleave(w: torch.Tensor, tp: int, inverse: bool = False) -> torch.Tensor:
    """to_kv's (2 * mid, in) rows [K; V] as [K_0; V_0; K_1; V_1; ...] (each
    K_r, V_r mid / tp rows), or back with `inverse`."""
    rest = w.shape[1:]
    if inverse:
        return w.reshape(tp, 2, -1, *rest).transpose(0, 1).reshape(w.shape)
    return w.reshape(2, tp, -1, *rest).transpose(0, 1).reshape(w.shape)


def shard_params(model: nn.Module, mesh, fsdp: bool = False) -> MeshPlan:
    """Shard `model`'s parameters in place by `param_shardings`: tp with
    `parallelize_module` (ColwiseParallel / RowwiseParallel, local tensors
    out), then, with `fsdp`, FSDP2 `fully_shard` over dp on every parameter
    the plan gives a dp axis (tp-taken weights are left out). Load the
    full weights first; shard after."""
    from torch.distributed.tensor import Shard

    specs = param_shardings(model, mesh, fsdp)
    tp = axis_sizes(mesh)["tp"]
    kv = set()
    if tp > 1:
        from torch.distributed.tensor.parallel import (
            ColwiseParallel,
            RowwiseParallel,
            parallelize_module,
        )

        styles = {}
        for name, spec in specs.items():
            mod, _, leaf = name.rpartition(".")
            if leaf != "weight" or "tp" not in spec:
                continue
            if mod.endswith("to_kv"):
                w = model.get_parameter(name)
                with torch.no_grad():
                    w.copy_(_kv_interleave(w, tp))
                kv.add(name)
            styles[mod] = ColwiseParallel() if spec[0] == "tp" else RowwiseParallel()
        parallelize_module(model, mesh["tp"], styles)
    if fsdp:
        from torch.distributed.fsdp import fully_shard

        params = dict(model.named_parameters())
        dims = {id(p): specs[n].index("dp") for n, p in params.items() if "dp" in specs[n]}
        if dims:
            ignored = {p for p in params.values() if id(p) not in dims}
            fully_shard(model, mesh=mesh["dp"], ignored_params=ignored or None,
                        shard_placement_fn=lambda p: Shard(dims[id(p)]))
    return MeshPlan(mesh, kv)


# ----------------------------------------------------------- local <-> full


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def to_local(t: torch.Tensor) -> torch.Tensor:
    """The local shard of a DTensor (a view that shares its storage), else
    `t`."""
    return t.to_local() if is_dtensor(t) else t


def sharded_axes(t: torch.Tensor) -> Tuple[str, ...]:
    """The mesh axes over which the DTensor `t` is split (none for a plain
    tensor)."""
    if not is_dtensor(t):
        return ()
    names = t.device_mesh.mesh_dim_names
    return tuple(n for n, p in zip(names, t.placements) if p.is_shard())


def full_tensor(local: torch.Tensor, ref: torch.Tensor, name: str = "",
                plan: Optional[MeshPlan] = None) -> torch.Tensor:
    """The whole tensor, in the single-process layout, whose shard on this
    rank is `local`, laid out as parameter `ref` (a collective over `ref`'s
    mesh: every rank calls it)."""
    if not is_dtensor(ref):
        return local
    from torch.distributed.tensor import DTensor

    full = DTensor.from_local(local, ref.device_mesh, ref.placements, run_check=False,
                              shape=ref.shape, stride=ref.stride()).full_tensor()
    if plan is not None and name in plan.kv_interleaved:
        full = _kv_interleave(full, plan.tp, inverse=True)
    return full


def local_shard(full: torch.Tensor, ref: torch.Tensor, name: str = "",
                plan: Optional[MeshPlan] = None) -> torch.Tensor:
    """This rank's shard of the single-process tensor `full`, laid out as
    parameter `ref` (no communication: DTensor's and FSDP2's chunking,
    torch.chunk with empty tails)."""
    if plan is not None and name in plan.kv_interleaved:
        full = _kv_interleave(full, plan.tp)
    if not is_dtensor(ref):
        return full
    coord = ref.device_mesh.get_coordinate()
    for i, placement in enumerate(ref.placements):
        if placement.is_shard():
            d, n = placement.dim, ref.device_mesh.size(i)
            pieces = list(torch.chunk(full, n, dim=d))
            pieces += [full.narrow(d, 0, 0)] * (n - len(pieces))
            full = pieces[coord[i]]
    return full
