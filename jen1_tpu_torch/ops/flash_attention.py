"""Flash-attention forward: the Hopper kernel, its plain version and the
dispatcher (port of jen1_tpu/ops/flash_attention.py).

`flash_attention_fwd` launches the hand-written CUDA kernel
(`csrc/flash_attention_fwd.cu`, which replaces the TPU kernel `_fwd_kernel`
of `_flash_forward_lse`, jen1_tpu/ops/flash_attention.py:45-167) and counts
its launches in `LAUNCHES`. `flash_attention_reference` computes the same
function in plain PyTorch; the tests and `chip_smoke.py` hold the kernel
against it. `flash_attention` dispatches: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. The backward kernels
(`_bwd_dq_kernel`, `_bwd_dkv_kernel`) are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

# Launches of the CUDA kernel, incremented by `flash_attention_fwd` only.
LAUNCHES = 0

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_supported(n: int, d: int) -> bool:
    """The JAX package's rule (jen1_tpu/ops/flash_attention.py:357-358)."""
    return n >= 128 and d <= 256


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: q, k, v (B, H, N, D) -> (o, lse).

    fp32 logits and softmax, scale D^-1/2, o in q's dtype, lse (B*H, N)
    fp32. Causal keeps key columns col <= row."""
    b, h, n, d = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d**-0.5
    if causal:
        above = torch.ones(n, n, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(above, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.matmul(p, v.float()).to(q.dtype)
    return o, lse.reshape(b * h, n)


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: q, k, v contiguous (B, H, N, D) on the card,
    float32 or bfloat16, D in SUPPORTED_HEAD_DIMS -> (o, lse (B*H, N) fp32).

    Launches on the current stream without synchronising."""
    global LAUNCHES
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} is on {t.device}, not CUDA "
                             f"beside q ({q.device})")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise ValueError(f"flash_attention_fwd: {name} has dtype {t.dtype}")
        if t.shape != q.shape or t.dim() != 4:
            raise ValueError(f"flash_attention_fwd: {name} has shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_fwd: {name} is not contiguous")
    b, h, n, d = q.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"flash_attention_fwd: head dim {d} not in {SUPPORTED_HEAD_DIMS}"
        )
    from jen1_tpu_torch.ops.kernels import library

    o = torch.empty_like(q)
    lse = torch.empty((b * h, n), dtype=torch.float32, device=q.device)
    err = library().jen1_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b * h, n, d, _DTYPE_CODES[q.dtype], int(causal),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd: launch failed with CUDA error {err}")
    LAUNCHES += 1
    return o, lse


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """q, k, v: (B, H, N, D) self-attention (N == M) -> (B, H, N, D)."""
    if not flash_attention_supported(q.shape[2], q.shape[3]):
        from jen1_tpu_torch.ops.attention import dot_product_attention

        return dot_product_attention(q, k, v, causal=causal)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal)[0]
    return flash_attention_fwd(q, k, v, causal)[0]
