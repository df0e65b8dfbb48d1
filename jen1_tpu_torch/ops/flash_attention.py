"""Flash attention: the Hopper kernels, their plain versions, the autograd
Function and the dispatcher (port of jen1_tpu/ops/flash_attention.py).

Three hand-written CUDA kernels, each with a wrapper that counts its
launches:
  * `flash_attention_fwd` (`csrc/flash_attention_fwd.cu`, K1) replaces the
    TPU kernel `_fwd_kernel` of `_flash_forward_lse`
    (jen1_tpu/ops/flash_attention.py:45-167); count `LAUNCHES`, and its
    causal launches again in `LAUNCHES_CAUSAL`.
  * `flash_attention_bwd_dq` (`csrc/flash_attention_bwd.cu`, K2) replaces
    `_bwd_dq_kernel` (:173-219, :309-324); count `LAUNCHES_DQ`.
  * `flash_attention_bwd_dkv` (same source, K3) replaces `_bwd_dkv_kernel`
    (:222-276, :325-349); count `LAUNCHES_DKV`.
Each has two routes, chosen by `tensor_core_route` from the dtype: bf16
runs its mma.sync tensor-core kernel (counted again in `LAUNCHES_MMA`,
`LAUNCHES_DQ_MMA` and `LAUNCHES_DKV_MMA`), which stages tiles with cp.async
and so needs every pointer 16-byte aligned; fp32 runs its scalar fp32
kernel.
`flash_attention_reference` and `flash_attention_bwd_reference` compute the
same functions in plain PyTorch; the tests and `chip_smoke.py` hold the
kernels against them. `flash_attention` mirrors the JAX `custom_vjp`
(:361-395): its forward and backward go through `FlashAttention`, which
takes the plain versions for CPU tensors and launches the kernels for CUDA
tensors, with no fallback. The kernels take head dims 16, 32, 64, 128 and
256; the wrappers zero-pad any other D <= 256 up to the next of these
(exact: zero columns add nothing to QK^T, PV or the gradients) and pass the
unpadded D^-1/2 as the logit scale.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# Launches of each CUDA kernel, incremented by its wrapper only; the _MMA
# counts are the launches of K1, K2 and K3 that took the tensor-core route,
# LAUNCHES_CAUSAL the launches of K1 with the causal mask. Under a CUDA graph
# the wrapper runs once, at capture: utils/cuda_graphs.py takes that back and
# adds the capture's counts at every replay, so they stay launches on the
# card.
COUNTERS = ("LAUNCHES", "LAUNCHES_MMA", "LAUNCHES_CAUSAL", "LAUNCHES_DQ", "LAUNCHES_DQ_MMA",
            "LAUNCHES_DKV", "LAUNCHES_DKV_MMA")
LAUNCHES = 0
LAUNCHES_MMA = 0
LAUNCHES_CAUSAL = 0
LAUNCHES_DQ = 0
LAUNCHES_DQ_MMA = 0
LAUNCHES_DKV = 0
LAUNCHES_DKV_MMA = 0

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_supported(n: int, d: int) -> bool:
    """The JAX package's rule (jen1_tpu/ops/flash_attention.py:357-358)."""
    return n >= 128 and d <= 256


def kernel_head_dim(d: int) -> int:
    """The head dim the kernels run for D: the smallest supported one >= D."""
    for size in SUPPORTED_HEAD_DIMS:
        if d <= size:
            return size
    raise ValueError(f"flash attention: head dim {d} > {SUPPORTED_HEAD_DIMS[-1]}")


def tensor_core_route(dtype: torch.dtype) -> bool:
    """Whether K1, K2 and K3 run their tensor-core kernels for `dtype`: bf16
    at every head dim does; fp32 keeps the scalar kernels, since a TF32
    product would miss the fp32 bars. `csrc/flash_attention_{fwd,bwd}.cu` route by
    the same rule."""
    return dtype == torch.bfloat16


def check_aligned(fn: str, tensors) -> None:
    """cp.async copies 16 bytes at a time: the tensor-core route takes only
    tensors whose data starts on a 16-byte boundary."""
    for name, t in tensors:
        offset = t.data_ptr() % 16
        if offset:
            raise ValueError(
                f"{fn}: {name} starts {offset} bytes past a 16-byte boundary; the "
                "tensor-core route loads it with cp.async, which needs 16-byte alignment"
            )


def _causal_mask(n: int, device) -> torch.Tensor:
    """True above the diagonal: key columns a causal row may not see."""
    return torch.ones(n, n, dtype=torch.bool, device=device).triu(1)


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: q, k, v (B, H, N, D) -> (o, lse).

    fp32 logits and softmax, scale `sm_scale` (D^-1/2 by default), o in q's
    dtype, lse (B*H, N) fp32. Causal keeps key columns col <= row."""
    b, h, n, d = q.shape
    scale = d**-0.5 if sm_scale is None else sm_scale
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(_causal_mask(n, q.device), float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.matmul(p, v.float()).to(q.dtype)
    return o, lse.reshape(b * h, n)


def flash_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2 and K3: (dq, dk, dv) in q's dtype.

    Computes in fp32 exactly what the kernels compute: P = exp(S - lse)
    from the forward's lse (not a softmax recomputed from scratch),
    delta = rowsum(dO * O), dS = P * (dP - delta) * scale."""
    b, h, n, d = q.shape
    scale = d**-0.5 if sm_scale is None else sm_scale
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.reshape(b, h, n, 1))
    if causal:
        p = p.masked_fill(_causal_mask(n, q.device), 0.0)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _check(fn: str, q: torch.Tensor, tensors) -> None:
    """Device, dtype, shape and contiguity checks of a kernel wrapper."""
    for name, t in tensors:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, not CUDA beside q ({q.device})")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise ValueError(f"{fn}: {name} has dtype {t.dtype}")
        if t.shape != q.shape or t.dim() != 4:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")


def _check_rows(fn: str, q: torch.Tensor, tensors) -> None:
    """lse / delta: (B*H, N) fp32, contiguous, on q's device."""
    b, h, n, _ = q.shape
    for name, t in tensors:
        if t.device != q.device or t.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} must be fp32 on {q.device}")
        if tuple(t.shape) != (b * h, n) or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous ({b * h}, {n})")


def _pad_head_dim(t: torch.Tensor, dp: int) -> torch.Tensor:
    d = t.shape[-1]
    return t if d == dp else F.pad(t, (0, dp - d))


def _unpad(t: torch.Tensor, d: int) -> torch.Tensor:
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def _launch(name: str, q: torch.Tensor, ptrs, dp: int, causal: bool, sm_scale: float) -> None:
    from jen1_tpu_torch.ops.kernels import library

    b, h, n, _ = q.shape
    err = getattr(library(), name)(
        *[t.data_ptr() for t in ptrs], b * h, n, dp, _DTYPE_CODES[q.dtype],
        int(causal), sm_scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1: q, k, v contiguous (B, H, N, D) on the card, float32 or
    bfloat16 (then 16-byte aligned), D <= 256 -> (o, lse (B*H, N) fp32).

    Launches on the current stream without synchronising."""
    global LAUNCHES, LAUNCHES_MMA, LAUNCHES_CAUSAL
    fn = "flash_attention_fwd"
    _check(fn, q, (("q", q), ("k", k), ("v", v)))
    b, h, n, d = q.shape
    dp = kernel_head_dim(d)
    qp, kp, vp = (_pad_head_dim(t, dp) for t in (q, k, v))
    o = torch.empty_like(qp)
    lse = torch.empty((b * h, n), dtype=torch.float32, device=q.device)
    mma = tensor_core_route(q.dtype)
    if mma:
        check_aligned(fn, (("q", qp), ("k", kp), ("v", vp), ("o", o)))
    _launch("jen1_flash_attention_fwd", q, (qp, kp, vp, o, lse), dp, causal, d**-0.5)
    LAUNCHES += 1
    LAUNCHES_MMA += mma
    LAUNCHES_CAUSAL += bool(causal)
    return _unpad(o, d), lse


def flash_attention_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, causal: bool = False,
) -> torch.Tensor:
    """Launch K2: dq (B, H, N, D) in q's dtype. q, k, v, do as for
    `flash_attention_fwd`; lse (K1's) and delta = rowsum(dO * O) are
    contiguous (B*H, N) fp32."""
    global LAUNCHES_DQ, LAUNCHES_DQ_MMA
    fn = "flash_attention_bwd_dq"
    _check(fn, q, (("q", q), ("k", k), ("v", v), ("do", do)))
    _check_rows(fn, q, (("lse", lse), ("delta", delta)))
    d = q.shape[-1]
    dp = kernel_head_dim(d)
    qp, kp, vp, dop = (_pad_head_dim(t, dp) for t in (q, k, v, do))
    dq = torch.empty_like(qp)
    mma = tensor_core_route(q.dtype)
    if mma:
        check_aligned(fn, (("q", qp), ("k", kp), ("v", vp), ("do", dop), ("dq", dq)))
    _launch("jen1_flash_attention_bwd_dq", q, (qp, kp, vp, dop, lse, delta, dq),
            dp, causal, d**-0.5)
    LAUNCHES_DQ += 1
    LAUNCHES_DQ_MMA += mma
    return _unpad(dq, d)


def flash_attention_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3: (dk, dv) (B, H, N, D) in q's dtype; arguments as for
    `flash_attention_bwd_dq` (bf16 ones 16-byte aligned)."""
    global LAUNCHES_DKV, LAUNCHES_DKV_MMA
    fn = "flash_attention_bwd_dkv"
    _check(fn, q, (("q", q), ("k", k), ("v", v), ("do", do)))
    _check_rows(fn, q, (("lse", lse), ("delta", delta)))
    d = q.shape[-1]
    dp = kernel_head_dim(d)
    qp, kp, vp, dop = (_pad_head_dim(t, dp) for t in (q, k, v, do))
    dk, dv = torch.empty_like(kp), torch.empty_like(vp)
    mma = tensor_core_route(q.dtype)
    if mma:
        check_aligned(fn, (("q", qp), ("k", kp), ("v", vp), ("do", dop), ("dk", dk), ("dv", dv)))
    _launch("jen1_flash_attention_bwd_dkv", q, (qp, kp, vp, dop, lse, delta, dk, dv),
            dp, causal, d**-0.5)
    LAUNCHES_DKV += 1
    LAUNCHES_DKV_MMA += mma
    return _unpad(dk, d), _unpad(dv, d)


class FlashAttention(torch.autograd.Function):
    """The JAX `custom_vjp` (flash_attention.py:361-395): the forward saves
    q, k, v, o and lse; the backward recomputes P from lse. CPU tensors take
    the plain versions, CUDA tensors K1 and then K2 and K3."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        if q.device.type == "cpu":
            o, lse = flash_attention_reference(q, k, v, causal)
        else:
            o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_reference(q, k, v, o, lse, do, ctx.causal)
            return dq, dk, dv, None
        do = do.contiguous()
        b, h, n, _ = q.shape
        # delta_i = sum_d dO_id O_id in fp32, outside the kernels (:300-302)
        delta = (do.float() * o.float()).sum(-1).reshape(b * h, n)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, ctx.causal)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """q, k, v: (B, H, N, D) self-attention (N == M) -> (B, H, N, D)."""
    if not flash_attention_supported(q.shape[2], q.shape[3]):
        from jen1_tpu_torch.ops.attention import dot_product_attention

        return dot_product_attention(q, k, v, causal=causal)
    return FlashAttention.apply(q, k, v, causal)
