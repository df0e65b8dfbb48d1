"""Sequence parallelism: the UNet over a latent whose length is sharded over
the mesh's sp axis (the port of what GSPMD does for jen1_tpu's sp axis,
jen1_tpu/parallel/mesh.py:33-36).

DTensor's conv rules shard batch and channels, not length, so the length
split is written here by hand, and the modules consult it while
`sequence_parallel(mesh)` is active:

  * every conv first takes from its neighbours the frames its padding
    implies (`halo`: zeros at the global ends only), then runs without
    padding, so each rank computes its own outputs (ops/conv.py);
  * GroupNorm takes its statistics over the whole length: the sums for the
    mean, then the sums of squared deviations, all-reduced over sp
    (`group_norm`, the two-pass formula);
  * Transformer1d gathers the length before its GroupNorm and attention
    (K1 sees the whole N, as it serves only N == M) and keeps its rows
    after (`gather_length`, models/blocks.py); inside it sp is suspended.

Every collective is a `torch.autograd.Function` whose backward is its
adjoint (a halo's gradient returns to its owner, an all-reduce's gradient
is all-reduced, a gather's is summed and scattered), so rank r's backward
of its local loss puts on every rank that rank's part of the gradient;
summed over sp (the trainer averages over dp x sp, since each rank's loss
is the mean over its 1/sp of the length) it is the single-process gradient.
The local length must divide by the UNet's factor product (`check_length`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional

import torch
import torch.distributed as dist

from jen1_tpu_torch.parallel.mesh import axis_sizes


@dataclasses.dataclass(frozen=True)
class SPGroup:
    group: object
    rank: int
    size: int


# Process-wide, not per thread or context: on the card the backward runs in
# autograd's device thread, and under remat it recomputes forwards there,
# which must see the group the forward saw.
_ACTIVE: Optional[SPGroup] = None


def active() -> Optional[SPGroup]:
    """The sp group the UNet's modules run over now, or None."""
    return _ACTIVE


@contextlib.contextmanager
def _set(value: Optional[SPGroup]) -> Iterator[Optional[SPGroup]]:
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, value
    try:
        yield value
    finally:
        _ACTIVE = prev


def sequence_parallel(mesh):
    """Run the block with the length split over `mesh`'s sp axis (a no-op
    without a mesh or at sp = 1)."""
    if mesh is None or axis_sizes(mesh)["sp"] == 1:
        return contextlib.nullcontext()
    return _set(SPGroup(mesh.get_group("sp"), mesh.get_local_rank("sp"),
                        axis_sizes(mesh)["sp"]))


def suspended():
    """Run the block on whole-length tensors (inside a gather)."""
    return _set(None)


def length_slice(length: int, sp: SPGroup) -> slice:
    """This rank's frames of a global length."""
    if length % sp.size:
        raise ValueError(f"length {length} is not divisible by sp={sp.size}")
    per = length // sp.size
    return slice(sp.rank * per, (sp.rank + 1) * per)


def check_length(local: int, multiple: int) -> None:
    """The UNet's local length must divide by its factor product."""
    sp = active()
    if sp is not None and local % multiple:
        raise ValueError(f"under sp={sp.size} the local latent length {local} must be a "
                         f"multiple of the UNet's factor product {multiple}")


def _gather(t: torch.Tensor, sp: SPGroup):
    parts = [torch.empty_like(t) for _ in range(sp.size)]
    dist.all_gather(parts, t.contiguous(), group=sp.group)
    return parts


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, sp):
        ctx.sp = sp
        out = t.clone()
        dist.all_reduce(out, group=sp.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.sp.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor, sp: SPGroup) -> torch.Tensor:
    """Sum over sp, differentiable (the gradient is all-reduced too)."""
    return _AllReduce.apply(t, sp)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, left, right, sp):
        ctx.left, ctx.right, ctx.sp = left, right, sp
        length = x.shape[1]
        edges = _gather(torch.cat([x[:, length - left:], x[:, :right]], dim=1), sp)
        lo = (edges[sp.rank - 1][:, :left] if sp.rank > 0
              else x.new_zeros(x.shape[0], left, *x.shape[2:]))
        hi = (edges[sp.rank + 1][:, left:] if sp.rank + 1 < sp.size
              else x.new_zeros(x.shape[0], right, *x.shape[2:]))
        return torch.cat([lo, x, hi], dim=1)

    @staticmethod
    def backward(ctx, grad):
        left, right, sp = ctx.left, ctx.right, ctx.sp
        length = grad.shape[1] - left - right
        # this rank's halo gradients, [to the left neighbour; to the right one]
        sent = _gather(torch.cat([grad[:, :left], grad[:, left + length:]], dim=1), sp)
        out = grad[:, left:left + length].clone()
        if sp.rank + 1 < sp.size and left:  # the right neighbour's left halo is mine
            out[:, length - left:] += sent[sp.rank + 1][:, :left]
        if sp.rank > 0 and right:  # the left neighbour's right halo is mine
            out[:, :right] += sent[sp.rank - 1][:, left:]
        return out, None, None, None


def halo(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """(B, L, C) -> (B, left + L + right, C): this rank's frames with
    `left` frames of the previous rank's end and `right` of the next rank's
    start; zeros past the global ends."""
    sp = active()
    left, right = max(left, 0), max(right, 0)
    if sp is None or (left == 0 and right == 0):
        return x
    if max(left, right) > x.shape[1]:
        raise ValueError(f"a halo of ({left}, {right}) frames exceeds the local length "
                         f"{x.shape[1]} under sp={sp.size}")
    return _Halo.apply(x, left, right, sp)


class _GatherLength(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        return torch.cat(_gather(x, sp), dim=1)

    @staticmethod
    def backward(ctx, grad):
        sp = ctx.sp
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=sp.group)  # gloo has no reduce-scatter
        return grad[:, length_slice(grad.shape[1], sp)], None


def gather_length(x: torch.Tensor) -> torch.Tensor:
    """(B, L / sp, C) -> (B, L, C), every rank's frames in rank order."""
    sp = active()
    return x if sp is None else _GatherLength.apply(x, sp)


def own_frames(x: torch.Tensor) -> torch.Tensor:
    """This rank's frames of a whole-length (B, L, C)."""
    sp = active()
    return x if sp is None else x[:, length_slice(x.shape[1], sp)]


def group_norm(x: torch.Tensor, num_groups: int, weight, bias, eps: float) -> torch.Tensor:
    """GroupNorm of a length-sharded (B, L, C) in fp32: per example and
    group, the mean from the all-reduced sums, then the variance from the
    all-reduced sums of squared deviations (biased, as F.group_norm)."""
    sp = active()
    b, length, c = x.shape
    xg = x.float().reshape(b, length, num_groups, c // num_groups)
    count = length * sp.size * (c // num_groups)
    mean = all_reduce_sum(xg.sum(dim=(1, 3), keepdim=True), sp) / count
    dev = xg - mean
    var = all_reduce_sum(dev.square().sum(dim=(1, 3), keepdim=True), sp) / count
    y = (dev * torch.rsqrt(var + eps)).reshape(b, length, c)
    return y * weight + bias
