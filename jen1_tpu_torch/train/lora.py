"""LoRA (low-rank adaptation) fine-tuning of the UNet (port of
jen1_tpu/train/lora.py:46-314).

The adapter is a flat dict {<flax path>: {"a": (fan_in, r), "b": (r,
fan_out)}} in the JAX package's layout: the keys are the "."-joined flax
parameter paths (`...attention.to_q.kernel`; the port's modules carry the
flax names, so a path names its module), and a, b factor the flax kernel
(*lead, fan_out), fan_in = prod(lead). The kernel's delta scale * (a @ b),
reshaped to the kernel, enters torch layout by `ckpt/from_jax.py`'s rule:
a Linear's transposed, a conv's (k, c_in, c_out) permuted to (c_out, c_in,
k), a transposed conv's to (c_in, c_out, k). A checkpoint of either package
therefore names the same leaves.

`merge_lora` folds an adapter into a model's weights once, in fp32, cast
back to each weight's dtype (inference: `Jen1(lora_path=...)`).
`LoRATrainer` trains the adapter with the base frozen: the base parameters
have requires_grad=False and get no gradient buffers and no optimizer
moments, and the train state (parameters, optimizer, EMA, `state_dict`) is
the adapter's alone, so its checkpoint is megabytes. During training each
target module merges on every call: a forward pre-hook puts W + scale *
delta(a, b) in the place of its weight and a forward hook puts the frozen
weight back. The merge thus runs inside each block, so under
`ModelConfig.remat` the recompute of a checkpointed block merges again from
the same a and b and the backward sees the merged weights; the modules'
parameter names stay as they are (a parametrization would rename them).
The hooks read the weight in place at each call, so they see what FSDP2
has gathered there.

Under a mesh (jen1_tpu/train/lora.py:211-214) the base is sharded as the
full model would be (tp, and fsdp with the config's flag) and the adapter
is replicated. A tp-split target merges its own shard of the delta into its
local weight; each tp rank then holds only its part of the adapter's
gradient, which the trainer sums over tp (`_tp_partial`).

`load_base_params` reads the frozen base from a checkpoint directory of
this package or a reference .pth, shape-checked against the model.
"""

from __future__ import annotations

import functools
import math
import re
from typing import Dict, List, Optional

import torch
from torch import nn

from jen1_tpu_torch.ckpt.checkpoint import (
    CheckpointManager,
    has_checkpoints,
    unreadable_checkpoint,
)
from jen1_tpu_torch.codec.seanet import SConvTranspose1d
from jen1_tpu_torch.ops.conv import Upsample1d
from jen1_tpu_torch.parallel.mesh import is_dtensor, local_shard, sharded_axes, to_local
from jen1_tpu_torch.train.trainer import UnifiedMultiTaskTrainer

# the attention (self and cross) projections and the transformer FFN
# (jen1_tpu/train/lora.py:46-53)
DEFAULT_TARGETS = (
    r"(attention|cross_attention)\.(to_q|to_kv|to_out)\.kernel$"
    r"|feed_forward\.linear[12]\.kernel$"
)
REFERENCE_SUFFIXES = (".pth", ".pt", ".bin")

Adapter = Dict[str, Dict[str, torch.Tensor]]


def flax_paths(model: nn.Module) -> Dict[str, str]:
    """{flax path: torch parameter name} of every parameter, in JAX's
    tree-flatten order (keys sorted at each level). A torch `weight` is a
    flax `kernel` (>= 2-D) or a norm's `scale` (1-D); other names are kept."""
    out = {}
    for name, p in model.named_parameters():
        mod, _, leaf = name.rpartition(".")
        if leaf == "weight":
            leaf = "kernel" if p.ndim >= 2 else "scale"
        out[f"{mod}.{leaf}" if mod else leaf] = name
    return dict(sorted(out.items(), key=lambda kv: kv[0].split(".")))


def _transposed(module: nn.Module) -> bool:
    return isinstance(module, SConvTranspose1d) or (
        isinstance(module, Upsample1d) and module.transposed)


def flax_shape(module: nn.Module, leaf: str, shape) -> tuple:
    """The flax shape of the torch parameter `leaf` of `module`."""
    shape = tuple(shape)
    if leaf != "weight" or len(shape) < 2:
        return shape
    if len(shape) == 2:
        return shape[::-1]
    if _transposed(module):  # (c_in, c_out, k)
        return (shape[2], shape[0], shape[1])
    return shape[::-1]  # (c_out, c_in, k)


def to_torch_layout(module: nn.Module, leaf: str, kernel: torch.Tensor) -> torch.Tensor:
    """A flax-layout kernel in the layout of the torch parameter `leaf`."""
    if leaf != "weight" or kernel.ndim < 2:
        return kernel
    if kernel.ndim == 2:
        return kernel.T
    return kernel.permute(1, 2, 0) if _transposed(module) else kernel.permute(2, 1, 0)


def lora_target_paths(model: nn.Module, pattern: str = DEFAULT_TARGETS) -> List[str]:
    """Flax paths of the >= 2-D parameters `pattern` selects, in tree-flatten
    order (jen1_tpu/train/lora.py:62-70)."""
    rx = re.compile(pattern)
    return [path for path, name in flax_paths(model).items()
            if model.get_parameter(name).ndim >= 2 and rx.search(path)]


def lora_targets(model: nn.Module, paths) -> Dict[str, tuple]:
    """{flax path: (module, torch leaf name, parameter)} of `paths`."""
    names = flax_paths(model)
    out = {}
    for path in paths:
        if path not in names:
            raise ValueError(f"adapter path {path!r} is no parameter of the model")
        mod, _, leaf = names[path].rpartition(".")
        module = model.get_submodule(mod)
        out[path] = (module, leaf, getattr(module, leaf))
    return out


def init_lora(model: nn.Module, rank: int, pattern: str = DEFAULT_TARGETS,
              generator: Optional[torch.Generator] = None) -> Adapter:
    """An adapter for every target kernel: a ~ N(0, 1 / fan_in), b = 0, so
    the merged model equals the base at the start (jen1_tpu/train/lora.py:
    73-108). fp32, on the model's device."""
    if rank < 1:
        raise ValueError(f"LoRA rank must be >= 1, got {rank}")
    paths = lora_target_paths(model, pattern)
    if not paths:
        kernels = [p for p, n in flax_paths(model).items() if model.get_parameter(n).ndim >= 2]
        raise ValueError(f"LoRA pattern {pattern!r} matched no >= 2-D kernels; available "
                         f"kernels include {kernels[:8]}")
    adapter: Adapter = {}
    for path, (module, leaf, w) in lora_targets(model, paths).items():
        shape = flax_shape(module, leaf, w.shape)
        fan_in, fan_out = math.prod(shape[:-1]), shape[-1]
        a = torch.randn((fan_in, rank), generator=generator, device=w.device)
        adapter[path] = {"a": a / math.sqrt(fan_in),
                         "b": torch.zeros((rank, fan_out), device=w.device)}
    return adapter


def lora_delta(module: nn.Module, leaf: str, w: torch.Tensor, ab, scale: float
               ) -> torch.Tensor:
    """scale * (a @ b) as the torch parameter `leaf` (fp32)."""
    a, b = (ab[k].to(w.device, torch.float32) for k in ("a", "b"))
    kernel = (a @ b).reshape(flax_shape(module, leaf, w.shape))
    return to_torch_layout(module, leaf, kernel) * scale


def merged_weight(module: nn.Module, leaf: str, w: torch.Tensor, ab, scale: float,
                  name: str = "", plan=None) -> torch.Tensor:
    """W + scale * delta, summed in fp32 and cast to W's dtype
    (jen1_tpu/train/lora.py:111-127). A DTensor W (tensor-parallel, `plan`
    from parallel/mesh.py, `name` its parameter name) gets its local shard
    of the delta and stays a DTensor of the same layout."""
    delta = lora_delta(module, leaf, w, ab, scale)
    if not is_dtensor(w):
        return (w.float() + delta).to(w.dtype)
    from torch.distributed.tensor import DTensor

    local = to_local(w)
    merged = (local.float() + local_shard(delta, w, name, plan)).to(local.dtype)
    return DTensor.from_local(merged, w.device_mesh, w.placements, run_check=False,
                              shape=w.shape, stride=w.stride())


@torch.no_grad()
def merge_lora(model: nn.Module, adapter: Adapter, scale: float) -> nn.Module:
    """Fold `adapter` into `model`'s weights in place; returns the model."""
    for path, (module, leaf, w) in lora_targets(model, adapter).items():
        w.copy_(merged_weight(module, leaf, w, adapter[path], scale))
    return model


def adapter_rank(adapter: Adapter) -> int:
    return int(next(iter(adapter.values()))["a"].shape[-1])


def lora_param_count(adapter: Adapter) -> int:
    return sum(t.numel() for ab in adapter.values() for t in ab.values())


def adapter_from_state(state: Dict[str, torch.Tensor], prefix: str = "params/") -> Adapter:
    """The adapter in a train-state dict (`<prefix><path>.a` / `.b`, as
    `LoRATrainer.state_dict` writes it)."""
    adapter: Adapter = {}
    for key, value in state.items():
        if key.startswith(prefix):
            path, _, leaf = key[len(prefix):].rpartition(".")
            if leaf not in ("a", "b"):
                raise ValueError(f"{key} is no LoRA adapter leaf (want <path>.a or <path>.b)")
            adapter.setdefault(path, {})[leaf] = value
    if not adapter or any(set(ab) != {"a", "b"} for ab in adapter.values()):
        raise ValueError(f"no complete LoRA adapter under {prefix!r} in the checkpoint")
    return adapter


@torch.no_grad()
def load_base_params(path: str, model: nn.Module, model_config) -> nn.Module:
    """The frozen base for fine-tuning, copied into `model`: the `params`
    of the latest step of a checkpoint directory of this package, or a
    reference .pth/.pt/.bin (`ckpt/torch_import.py`). The names and shapes
    must be the model's: LoRA adapts a fixed architecture
    (jen1_tpu/train/lora.py:136-179)."""
    if str(path).endswith(REFERENCE_SUFFIXES):
        from jen1_tpu_torch.ckpt.torch_import import load_reference_checkpoint

        load_reference_checkpoint(path, model, model_config)
        return model
    if not has_checkpoints(path):
        raise unreadable_checkpoint(path)
    state, _ = CheckpointManager(path).restore()
    got = {k[len("params/"):]: v for k, v in state.items() if k.startswith("params/")}
    want = dict(model.named_parameters())
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    mismatch = sorted(k for k in set(want) & set(got) if want[k].shape != got[k].shape)
    if missing or extra or mismatch:
        raise ValueError(f"base checkpoint {path} does not match the model: "
                         f"missing={missing[:5]} extra={extra[:5]} "
                         f"shape-mismatch={mismatch[:5]}")
    for name, p in want.items():
        p.copy_(got[name])
    return model


def _merge_in(leaf, ab, scale, name, plan, module, args):
    # straight into _parameters: the attribute stays a Parameter slot, its
    # name unchanged, holding the merged (differentiable) tensor; the weight
    # in place now (FSDP2 may have gathered it) is kept for the restore
    base = module._parameters[leaf]
    module.__dict__[f"_lora_base_{leaf}"] = base
    module._parameters[leaf] = merged_weight(module, leaf, base, ab, scale, name, plan)


def _restore(leaf, module, args, output):
    base = module.__dict__.pop(f"_lora_base_{leaf}", None)
    if base is not None:
        module._parameters[leaf] = base


def register_merge_hooks(model: nn.Module, adapter: Adapter, scale: float,
                         plan=None) -> None:
    """Make every target module of `adapter` run with its merged weight:
    a forward pre-hook merges, a forward hook (also on error) restores.
    `plan` is the model's parallel/mesh.py MeshPlan when it is sharded."""
    names = flax_paths(model)
    for path, (module, leaf, _) in lora_targets(model, adapter).items():
        module.register_forward_pre_hook(
            functools.partial(_merge_in, leaf, adapter[path], scale, names[path], plan))
        module.register_forward_hook(functools.partial(_restore, leaf), always_call=True)


class LoRATrainer(UnifiedMultiTaskTrainer):
    """UnifiedMultiTaskTrainer that trains a LoRA adapter over a frozen base
    (jen1_tpu/train/lora.py:182-314). The trainer's parameters are the
    adapter's leaves (`<path>.a`, `<path>.b`), so the optimizer, the EMA and
    the checkpoint hold the adapter alone. Built by `train.build_trainer`
    when `config.lora_config.rank > 0`; `adapter` replaces the seeded init
    (a ~ N(0, 1/fan_in) from `generator`, b = 0)."""

    def __init__(self, config, model, diffusion, conditioner=None, *, device="cuda",
                 adapter: Optional[Adapter] = None,
                 generator: Optional[torch.Generator] = None, **kw):
        lc = config.lora_config
        if lc.rank < 1:
            raise ValueError("LoRATrainer needs config.lora_config.rank >= 1")
        self.rank = int(lc.rank)
        self.scale = float(lc.alpha) / self.rank
        self.pattern = lc.targets or DEFAULT_TARGETS
        model.requires_grad_(False)
        if lc.base_ckpt:
            load_base_params(lc.base_ckpt, model, config.model_config)
        if adapter is None:
            adapter = init_lora(model, self.rank, self.pattern, generator)
        # the full base is in place: the trainer shards it over a mesh
        super().__init__(config, model, diffusion, conditioner, device=device, **kw)
        self.adapter: Adapter = {
            path: {k: torch.as_tensor(v).to(self.device, torch.float32).detach().clone()
                   .requires_grad_(True) for k, v in ab.items()}
            for path, ab in adapter.items()}
        register_merge_hooks(model, self.adapter, self.scale, self.mesh_plan)

    @property
    def params(self) -> List[torch.Tensor]:
        return [ab[k] for ab in self.adapter.values() for k in ("a", "b")]

    def _names(self) -> List[str]:
        return [f"{path}.{k}" for path in self.adapter for k in ("a", "b")]

    def _tp_partial(self) -> List[bool]:
        """An adapter of a tp-split target: each tp rank's gradient is its
        shard's part."""
        targets = lora_targets(self.model, self.adapter)
        return [is_dtensor(targets[path][2]) and "tp" in sharded_axes(targets[path][2])
                for path in self.adapter for _ in ("a", "b")]
