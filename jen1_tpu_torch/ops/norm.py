"""Normalisation layers, channels-last, fp32 statistics (port of
jen1_tpu/ops/norm.py). Under sequence parallelism GroupNorm's statistics
span the whole length (parallel/sp.py::group_norm).

GroupNorm carries the conv block's FiLM and SiLU with it
(`group_norm_act`), since on the card they run as one kernel, K5
(`csrc/group_norm.cu`), which reads and writes (B, L, C):

  * `group_norm_act_plain`: `F.group_norm` in fp32, the result in x's
    dtype, then the FiLM and the SiLU in x's dtype. It is what the conv
    block computed before K5, and K5 rounds where it rounds.
  * `group_norm_act_cuda` launches K5 and counts `LAUNCHES`.
  * `group_norm_act` routes by what the call shows: a call under sp to
    `seq.group_norm` (its statistics are all-reduced); CPU tensors, and a
    CUDA call that needs a gradient (K5 has no backward), to the plain
    version; every other CUDA call to K5. CUDA calls that took a plain
    route count in `PLAIN_CUDA`. No route falls back to another when one
    raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from jen1_tpu_torch.parallel import sp as seq

# Calls of `group_norm_act_cuda` (each launches K5: one kernel, or a
# statistics and an apply kernel at long rows; `launch_plan`) and CUDA calls of
# `group_norm_act` that took a plain route; incremented here only, and
# under a CUDA graph by utils/cuda_graphs.py at every replay.
COUNTERS = ("LAUNCHES", "PLAIN_CUDA")
LAUNCHES = 0
PLAIN_CUDA = 0

ScaleShift = Optional[Tuple[torch.Tensor, torch.Tensor]]
_ACTS = (None, "silu")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# K5's launch shapes, decided here alone (csrc/group_norm.cu only checks
# them): one launch holds a block's rows in registers, at most
# RESIDENT_ROWS a thread (the kernel's RES) of at most MAX_THREADS (its
# launch bound), over channel slices of whole groups of at least
# MIN_SLICE_BYTES a row; two launches split an example's rows over blocks of
# at least MIN_ROWS rows and about ROW_THREADS threads. Either aims at
# TARGET_BLOCKS blocks in all (two per SM of an H100).
RESIDENT_ROWS = 8
MAX_THREADS = 512
ROW_THREADS = 256
MIN_SLICE_BYTES = 32
MIN_ROWS = 16
TARGET_BLOCKS = 264


def film_act(y: torch.Tensor, scale_shift: ScaleShift = None, act: Optional[str] = None):
    """The conv block's FiLM, y * (scale + 1) + shift, then `act`, in y's
    dtype."""
    if scale_shift is not None:
        scale, shift = scale_shift
        y = y * (scale + 1.0) + shift
    return F.silu(y) if act == "silu" else y


def group_norm_act_plain(x, num_groups: int, weight, bias, eps: float,
                         scale_shift: ScaleShift = None, act: Optional[str] = None):
    """Plain version of K5: GroupNorm over (L, channels-in-group) of
    (B, L, C) in fp32, in x's dtype, then `film_act`."""
    y = F.group_norm(x.transpose(1, 2).float(), num_groups, weight, bias, eps)
    return film_act(y.to(x.dtype).transpose(1, 2), scale_shift, act)


class LaunchPlan(NamedTuple):
    resident: bool  # one launch (rows in registers), else two
    slices: int  # blocks an example along C (one launch)
    splits: int  # blocks an example along L (two launches)
    rows: int  # rows a block (two launches)
    ct: int  # channel vectors a block covers at once
    r: int  # row lanes a block; its threads are ct * r, rounded up to a warp


def launch_plan(batch: int, length: int, channels: int, groups: int, itemsize: int,
                vec: int) -> LaunchPlan:
    """K5's grid and blocks for (B, L, C) in `groups`, `vec` channels a
    load: one launch where a block can hold its rows in registers, over the
    most channel slices (whole groups) that keep a slice's row at least
    MIN_SLICE_BYTES and the grid within TARGET_BLOCKS, a thread for each
    vector of a slice's row and RESIDENT_ROWS rows; else two, with each
    example's rows split to fill the grid, a block's threads over at most
    MAX_THREADS vectors of a row and as many rows as make ROW_THREADS."""
    if (channels // groups) % vec == 0:
        slices = max(d for d in range(1, groups + 1)
                     if groups % d == 0
                     and (d == 1 or (channels // d) * itemsize >= MIN_SLICE_BYTES)
                     and (d == 1 or batch * d <= TARGET_BLOCKS))
        vectors = channels // slices // vec
        if vectors <= MAX_THREADS and length <= MAX_THREADS // vectors * RESIDENT_ROWS:
            return LaunchPlan(True, slices, 1, length, vectors,
                              min(MAX_THREADS // vectors, length))
    want = max(1, -(-TARGET_BLOCKS // batch))
    rows = max(MIN_ROWS, -(-length // want))
    ct = min(channels // vec, MAX_THREADS)
    return LaunchPlan(False, 1, -(-length // rows), rows, ct, max(1, ROW_THREADS // ct))


def _film_rows(t: torch.Tensor, batch: int, channels: int, like: torch.Tensor) -> torch.Tensor:
    """A FiLM scale or shift that broadcasts as (B, 1, C), as (B, C) rows
    with unit channel stride (a view)."""
    if t.dtype != like.dtype or t.device != like.device:
        raise ValueError(f"group_norm_act_cuda: FiLM {t.dtype} on {t.device}, x "
                         f"{like.dtype} on {like.device}")
    rows = t.expand(batch, 1, channels)[:, 0]
    if rows.stride(1) != 1:
        raise ValueError("group_norm_act_cuda: FiLM rows are not contiguous along C")
    return rows


def group_norm_act_cuda(x, num_groups: int, weight, bias, eps: float,
                        scale_shift: ScaleShift = None, act: Optional[str] = None):
    """Launch K5: x (B, L, C) bf16 or fp32 on the card with its (L, C)
    dense (any batch stride), weight and bias (C,) fp32 contiguous, FiLM
    scale and shift of x's dtype broadcasting as (B, 1, C), act None or
    "silu" -> a new contiguous (B, L, C) of x's dtype. Launches on the
    current stream without synchronising; a refused launch raises."""
    global LAUNCHES
    from jen1_tpu_torch.ops.kernels import library

    if not x.is_cuda or x.dim() != 3 or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"group_norm_act_cuda: x {tuple(x.shape)} {x.dtype} on {x.device}")
    b, length, c = x.shape
    if min(b, length, c) < 1 or not _dense_rows(x):
        raise ValueError(f"group_norm_act_cuda: x's (L, C) is not dense: strides {x.stride()}")
    if num_groups < 1 or c % num_groups or act not in _ACTS:
        raise ValueError(f"group_norm_act_cuda: {num_groups} groups of {c} channels, act {act}")
    for name, t in (("weight", weight), ("bias", bias)):
        if (t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != (c,)
                or not t.is_contiguous()):
            raise ValueError(f"group_norm_act_cuda: {name} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, not ({c},) fp32 contiguous beside x")
    scale = shift = None
    if scale_shift is not None:
        scale, shift = (_film_rows(t, b, c, x) for t in scale_shift)
    itemsize = x.element_size()
    vec = 16 // itemsize
    if (c % vec or x.data_ptr() % 16 or (x.stride(0) * itemsize) % 16):
        vec = 1
    plan = launch_plan(b, length, c, num_groups, itemsize, vec)
    out = torch.empty((b, length, c), dtype=x.dtype, device=x.device)
    partial = (None if plan.resident else
               torch.empty((b, plan.splits, num_groups, 3), dtype=torch.float32,
                           device=x.device))
    err = library().jen1_group_norm(
        x.data_ptr(), out.data_ptr(), x.stride(0), weight.data_ptr(), bias.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if shift is None else shift.data_ptr(),
        0 if scale is None else scale.stride(0), 0 if shift is None else shift.stride(0),
        None if partial is None else partial.data_ptr(),
        b, length, c, num_groups, int(plan.resident), plan.slices, plan.rows, plan.splits,
        plan.ct, plan.r, _DTYPE_CODES[x.dtype], vec,
        int(act == "silu"), float(eps), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"jen1_group_norm: launch failed with CUDA error {err}")
    LAUNCHES += 1
    return out


def _dense_rows(x: torch.Tensor) -> bool:
    """Whether each example of (B, L, C) is one dense (L, C) block."""
    _, length, c = x.shape
    return (c == 1 or x.stride(2) == 1) and (length == 1 or x.stride(1) == c)


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def group_norm_act(x, num_groups: int, weight, bias, eps: float,
                   scale_shift: ScaleShift = None, act: Optional[str] = None):
    """GroupNorm of (B, L, C) (fp32 statistics, output in x's dtype), then
    the FiLM y * (scale + 1) + shift when `scale_shift` is given, then SiLU
    when act == "silu"; routed as the module docstring says."""
    global PLAIN_CUDA
    cuda = _on_card(x)
    if seq.active() is not None:
        PLAIN_CUDA += cuda
        y = seq.group_norm(x, num_groups, weight, bias, eps).to(x.dtype)
        return film_act(y, scale_shift, act)
    film = () if scale_shift is None else scale_shift
    if not cuda or _needs_grad(x, weight, bias, *film):
        PLAIN_CUDA += cuda
        return group_norm_act_plain(x, num_groups, weight, bias, eps, scale_shift, act)
    if not _dense_rows(x):
        x = x.contiguous()
    return group_norm_act_cuda(x, num_groups, weight, bias, eps, scale_shift, act)


class GroupNorm(nn.Module):
    """GroupNorm over the channel (last) axis of (B, L, C); statistics over
    (L, channels-in-group) in fp32, output in the input dtype; optionally
    followed by the conv block's FiLM and SiLU (`group_norm_act`)."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        assert channels % num_groups == 0, (
            f"channels {channels} not divisible by groups {num_groups}"
        )
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def init_parameters(self, generator):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, scale_shift: ScaleShift = None,
                act: Optional[str] = None) -> torch.Tensor:
        return group_norm_act(x, self.num_groups, self.weight, self.bias, self.eps,
                              scale_shift, act)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with fp32 statistics; `use_bias=False`
    keeps the shift at zero (no parameter), as Stable Audio Open's blocks
    do."""

    def __init__(self, channels: int, eps: float = 1e-5, use_bias: bool = True):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels)) if use_bias else None

    def init_parameters(self, generator):
        nn.init.ones_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, self.eps)
        return y.to(x.dtype)
