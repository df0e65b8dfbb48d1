"""Fused AdamW: clip, moments, bias correction, weight decay and the
parameter update in one pass per step (port of
jen1_tpu/train/fused_optim.py:56-131).

Same semantics as the JAX version, which is an XLA expression and not a
Pallas kernel: the global-norm clip scale min(1, clip / ||g||), Adam moments
with bias correction at count + 1, decoupled weight decay, lr at count, and
the non-finite skip folded into the clip: when ||g|| is not finite (a NaN
or inf gradient, or an overflow of the squared sum) the parameters, moments
and count keep their values and `notfinite_count` grows; a finite step
resets it. The global norm is returned for the trainer's metrics. Written
with `torch._foreach_*` over the parameter list (a few multi-tensor
launches per step) and updated in place; the skip decision reads the norm
on the host once per step. Over sharded parameters the lists hold local
shards and `shard_groups` makes the norm the single-process one
(`optim.global_norm`), so every rank clips and skips alike.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Union

import torch

from jen1_tpu_torch.train.optim import ShardGroups, global_norm


@dataclasses.dataclass
class FusedAdamWState:
    count: int  # applied updates
    notfinite_count: int  # consecutive skipped updates
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def fused_adamw_init(params: List[torch.Tensor]) -> FusedAdamWState:
    zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    return FusedAdamWState(0, 0, zeros, [torch.zeros_like(z) for z in zeros])


@torch.no_grad()
def fused_adamw_apply(
    grads: List[torch.Tensor],
    state: FusedAdamWState,
    params: List[torch.Tensor],
    *,
    lr: Union[float, Callable[[int], float]],
    b1: float,
    b2: float,
    eps: float,
    weight_decay: float,
    clip: float,
    shard_groups: ShardGroups = None,
):
    """One fused AdamW step on `params` in place. Returns (state, grad_norm);
    lr may be a float or a schedule evaluated at state.count."""
    grads = [g.float() for g in grads]
    gnorm = global_norm(grads, shard_groups)
    norm = float(gnorm)
    if not math.isfinite(norm):
        state.notfinite_count += 1
        return state, gnorm
    scale = min(1.0, clip / max(norm, 1e-30))
    lr_t = lr(state.count) if callable(lr) else lr
    t = state.count + 1
    torch._foreach_mul_(state.mu, b1)
    torch._foreach_add_(state.mu, grads, alpha=(1.0 - b1) * scale)
    torch._foreach_mul_(state.nu, b2)
    torch._foreach_addcmul_(state.nu, grads, grads, value=(1.0 - b2) * scale * scale)
    denom = torch._foreach_div(state.nu, 1.0 - b2**t)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    upd = torch._foreach_div(state.mu, 1.0 - b1**t)
    torch._foreach_div_(upd, denom)
    torch._foreach_add_(upd, params, alpha=weight_decay)
    torch._foreach_add_(params, upd, alpha=-lr_t)
    state.count = t
    state.notfinite_count = 0
    return state, gnorm
