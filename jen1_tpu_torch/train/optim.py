"""Optimizer: LinearLR warm-up, global-norm clip and AdamW with the JAX
package's optax semantics (port of jen1_tpu/train/optim.py:14-63).

`make_optimizer` returns the chain that the trainer uses when
`grad_accum_every > 1` (or the fused path is off):

    MultiSteps(apply_if_finite(chain(clip_by_global_norm, adamw)))

written as plain torch over a list of fp32 parameters, updated in place:
  * clip: g unchanged when ||g|| < clip, else g / ||g|| * clip;
  * AdamW (optax.adamw): eps 1e-8 outside the square root, bias correction
    at count + 1, decoupled weight decay added to the update, then times
    -lr(count);
  * apply_if_finite: a step whose (averaged) gradient holds a non-finite
    value changes no parameter and no moment; after more than
    `max_consecutive_errors` such steps in a row the update goes through;
  * MultiSteps (k = grad_accum_every > 1): each call folds the gradient
    into a running mean; every k-th call applies the chain to the mean and
    resets it by multiplying by zero, as optax does (a NaN in the mean
    therefore stays).
The optimizer's step counts are host integers; the finite check reads one
value from the device per applied step.

Sharded parameters (parallel/mesh.py). The optimizer works on each rank's
local shards; `shard_groups` gives, per leaf, the process groups over
which its shards are spread (none for a replicated leaf). The global norm
then sums each leaf's local squares, all-reduces the sums over those groups
and counts a replicated leaf once, so it is the single-process norm; the
finite check is agreed over every rank.

`flatten_optimizer` (optax.flatten around the whole chain, jen1_tpu/train/
optim.py:52-62): the moments and the accumulator are one fp32 vector each,
and every call copies the gradients and parameters into one vector, runs
the chain over it and copies the parameters back: the same math up to the
summation order of the global norm. The state then holds one-element lists,
so it is not interchangeable with the per-parameter layout (the trainer's
`load_state_dict` refuses a checkpoint of the other layout).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Schedule = Callable[[int], float]


def make_lr_schedule(opt_config) -> Schedule:
    """optax.join_schedules([linear_schedule(lr*start, lr*end, total),
    constant(lr*end)], [total]) as a function of the update count."""
    base = opt_config.lr
    start = base * opt_config.lr_start_factor
    end = base * opt_config.lr_end_factor
    total = opt_config.lr_total_iters

    def schedule(count: int) -> float:
        if count >= total:
            return end
        return (start - end) * (1.0 - max(count, 0) / total) + end

    return schedule


ShardGroups = Optional[Sequence[Tuple[Any, ...]]]


def global_norm(tensors: List[torch.Tensor], shard_groups: ShardGroups = None) -> torch.Tensor:
    """sqrt of the sum of squares over every element, fp32, on the device:
    the leaves' squared norms summed in one reduction. With `shard_groups`
    the tensors are local shards: the leaves spread over the same groups
    are summed together (one reduction each, in leaf order) and
    all-reduced over those groups, so where every group has one rank the
    norm is the single-process one, bit for bit."""
    squares = torch.stack(torch._foreach_norm([t.float() for t in tensors])).square()
    if shard_groups is None:
        return squares.sum().sqrt()
    keys: Dict[Tuple[Any, ...], List[int]] = {}
    for i, groups in enumerate(shard_groups):
        keys.setdefault(tuple(groups), []).append(i)
    total = None
    for groups, idx in keys.items():  # the same order on every rank
        s = squares[torch.as_tensor(idx, device=squares.device)].sum()
        for group in groups:
            dist.all_reduce(s, group=group)
        total = s if total is None else total + s
    return total.sqrt()


def all_finite(tensors: List[torch.Tensor], shard_groups: ShardGroups = None) -> bool:
    """True when no element is NaN or +-inf (one read from the device).
    The max-abs norm is finite exactly when every element is. With
    `shard_groups` the verdict is agreed over every rank."""
    bad = (~torch.isfinite(torch.stack(torch._foreach_norm(tensors, float("inf"))))).any()
    if shard_groups is not None:
        bad = bad.float()
        dist.all_reduce(bad, op=dist.ReduceOp.MAX)
    return not bool(bad)


@dataclasses.dataclass
class ChainState:
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: int = 0  # applied AdamW updates (also the schedule's count)
    notfinite_count: int = 0  # consecutive rejected updates
    total_notfinite: int = 0
    mini_step: int = 0  # MultiSteps: position inside the accumulation window
    gradient_step: int = 0  # MultiSteps: emitted updates
    acc: Optional[List[torch.Tensor]] = None  # MultiSteps running mean


class AdamWChain:
    """The optax chain of jen1_tpu/train/optim.py:27-63 over a parameter list."""

    def __init__(self, opt_config, grad_accum_every: int = 1,
                 max_consecutive_errors: int = 100, flatten_ok: bool = True):
        self.oc = opt_config
        # one flat vector cannot hold sharded leaves (jen1_tpu/train/optim.py)
        self.flatten = bool(opt_config.flatten_optimizer) and flatten_ok
        self.k = int(grad_accum_every)
        self.skip_nonfinite = opt_config.skip_nonfinite_updates
        self.max_consecutive_errors = max_consecutive_errors
        self.lr = make_lr_schedule(opt_config)

    def init(self, params: List[torch.Tensor]) -> ChainState:
        if self.flatten:
            params = [flat_fp32(params)]
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return ChainState(
            mu=zeros, nu=[torch.zeros_like(z) for z in zeros],
            acc=[torch.zeros_like(z) for z in zeros] if self.k > 1 else None,
        )

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: ChainState,
               params: List[torch.Tensor], shard_groups: ShardGroups = None) -> ChainState:
        """Apply one call's update to `params` in place; returns `state`.
        `shard_groups`: see `global_norm` (never with flatten, which holds
        no sharded leaf)."""
        if self.flatten:
            flat = [flat_fp32(params)]
            self._update([flat_fp32(grads)], state, flat, None)
            sizes = [p.numel() for p in params]
            torch._foreach_copy_(params, [c.view_as(p) for c, p in
                                          zip(flat[0].split(sizes), params)])
            return state
        return self._update([g.float() for g in grads], state, params, shard_groups)

    def _update(self, grads, state: ChainState, params, shard_groups) -> ChainState:
        if self.k == 1:
            self._apply_if_finite(grads, state, params, shard_groups)
            return state
        acc = state.acc
        # Welford running mean: acc + (g - acc) / (n + 1)
        diff = torch._foreach_sub(grads, acc)
        torch._foreach_add_(acc, diff, alpha=1.0 / (state.mini_step + 1))
        if state.mini_step == self.k - 1:
            self._apply_if_finite(acc, state, params, shard_groups)
            torch._foreach_mul_(acc, 0.0)
            state.gradient_step += 1
        state.mini_step = (state.mini_step + 1) % self.k
        return state

    def _apply_if_finite(self, grads, state: ChainState, params, shard_groups) -> None:
        if self.skip_nonfinite:
            finite = all_finite(grads, shard_groups)
            state.notfinite_count = 0 if finite else state.notfinite_count + 1
            if not finite:
                state.total_notfinite += 1
                if state.notfinite_count <= self.max_consecutive_errors:
                    return
        self._clip_adamw(grads, state, params, shard_groups)

    def _clip_adamw(self, grads, state: ChainState, params, shard_groups) -> None:
        oc = self.oc
        b1, b2, eps = oc.beta_1, oc.beta_2, 1e-8
        norm = global_norm(grads, shard_groups)
        # clip_by_global_norm: keep g where ||g|| < clip, else g / ||g|| * clip
        factor = torch.where(norm < oc.grad_clip, torch.ones_like(norm),
                             oc.grad_clip / norm)
        g = torch._foreach_mul(grads, factor)
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, g, g, value=1.0 - b2)
        count = state.count + 1
        denom = torch._foreach_div(state.nu, 1.0 - b2**count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(state.mu, 1.0 - b1**count)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, params, alpha=oc.weight_decay)
        torch._foreach_add_(params, upd, alpha=-self.lr(state.count))
        state.count = count


def flat_fp32(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The tensors' elements, in order, as one fp32 vector (a copy)."""
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def make_optimizer(opt_config, grad_accum_every: int = 1, flatten_ok: bool = True
                   ) -> AdamWChain:
    return AdamWChain(opt_config, grad_accum_every, flatten_ok=flatten_ok)
