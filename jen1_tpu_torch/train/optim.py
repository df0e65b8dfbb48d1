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
from typing import Callable, List, Optional

import torch

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


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element, fp32, on the device."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def all_finite(tensors: List[torch.Tensor]) -> bool:
    """True when no element is NaN or +-inf (one read from the device).
    The max-abs norm is finite exactly when every element is."""
    return bool(torch.isfinite(torch.stack(torch._foreach_norm(tensors, float("inf")))).all())


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
                 max_consecutive_errors: int = 100):
        self.oc = opt_config
        self.flatten = bool(opt_config.flatten_optimizer)
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
               params: List[torch.Tensor]) -> ChainState:
        """Apply one call's update to `params` in place; returns `state`."""
        if self.flatten:
            flat = [flat_fp32(params)]
            self._update([flat_fp32(grads)], state, flat)
            sizes = [p.numel() for p in params]
            torch._foreach_copy_(params, [c.view_as(p) for c, p in
                                          zip(flat[0].split(sizes), params)])
            return state
        return self._update([g.float() for g in grads], state, params)

    def _update(self, grads, state: ChainState, params) -> ChainState:
        if self.k == 1:
            self._apply_if_finite(grads, state, params)
            return state
        acc = state.acc
        # Welford running mean: acc + (g - acc) / (n + 1)
        diff = torch._foreach_sub(grads, acc)
        torch._foreach_add_(acc, diff, alpha=1.0 / (state.mini_step + 1))
        if state.mini_step == self.k - 1:
            self._apply_if_finite(acc, state, params)
            torch._foreach_mul_(acc, 0.0)
            state.gradient_step += 1
        state.mini_step = (state.mini_step + 1) % self.k
        return state

    def _apply_if_finite(self, grads, state: ChainState, params) -> None:
        if self.skip_nonfinite:
            finite = all_finite(grads)
            state.notfinite_count = 0 if finite else state.notfinite_count + 1
            if not finite:
                state.total_notfinite += 1
                if state.notfinite_count <= self.max_consecutive_errors:
                    return
        self._clip_adamw(grads, state, params)

    def _clip_adamw(self, grads, state: ChainState, params) -> None:
        oc = self.oc
        b1, b2, eps = oc.beta_1, oc.beta_2, 1e-8
        norm = global_norm(grads)
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


def make_optimizer(opt_config, grad_accum_every: int = 1) -> AdamWChain:
    return AdamWChain(opt_config, grad_accum_every)
