"""Attention (port of jen1_tpu/ops/attention.py).

Two paths, chosen as in the JAX package (jen1_tpu/ops/attention.py:120):
self-attention with `use_flash`, N >= flash_min_seq_len and N == M goes to
`flash_attention` (the CUDA kernel on the card); everything else runs the
plain fp32-logits path below. Cross-attention padding zeroes the masked k/v
rows, and the k/v input always has its own LayerNorm, even for
self-attention.

Under tensor parallelism (parallel/mesh.py) to_q and to_kv are
column-parallel and return this rank's columns: the heads come from the
local width, and to_kv's local rows are laid out [k_r; v_r], so the chunk
below splits them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from jen1_tpu_torch.ops.flash_attention import flash_attention
from jen1_tpu_torch.ops.linear import Linear
from jen1_tpu_torch.ops.norm import LayerNorm


def dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False
) -> torch.Tensor:
    """q, k, v: (B, H, N|M, D). fp32 logits and softmax, output in q.dtype."""
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        n, m = logits.shape[-2], logits.shape[-1]
        row = torch.arange(n, device=q.device)[:, None]
        col = torch.arange(m, device=q.device)[None, :]
        # allow j <= i + (m - n): standard causal alignment for n == m
        logits = logits.masked_fill(
            col > row + (m - n), torch.finfo(torch.float32).min
        )
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(dtype), v)


class Attention(nn.Module):
    """Self- or cross-attention: pre-LayerNorm on input and context,
    bias-free q/kv projections, output projection with bias."""

    def __init__(
        self,
        features: int,
        head_features: int,
        num_heads: int,
        out_features: Optional[int] = None,
        context_features: Optional[int] = None,
        use_flash: bool = False,
        flash_min_seq_len: int = 512,
    ):
        super().__init__()
        mid = head_features * num_heads
        ctx_features = context_features or features
        self.head_features = head_features
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.flash_min_seq_len = flash_min_seq_len
        self.norm = LayerNorm(features)
        self.norm_context = LayerNorm(ctx_features)
        self.to_q = Linear(features, mid, use_bias=False)
        self.to_kv = Linear(ctx_features, 2 * mid, use_bias=False)
        self.to_out = Linear(mid, out_features or features)

    def forward(
        self,
        x: torch.Tensor,  # (B, N, C)
        context: Optional[torch.Tensor] = None,  # (B, M, Cc)
        context_mask: Optional[torch.Tensor] = None,  # (B, M) bool/0-1
        causal: bool = False,
    ) -> torch.Tensor:
        ctx = x if context is None else context
        x = self.norm(x)
        ctx = self.norm_context(ctx)
        q = self.to_q(x)
        k, v = self.to_kv(ctx).chunk(2, dim=-1)
        if context_mask is not None:
            m = context_mask.to(k.dtype)[..., None]  # (B, M, 1)
            k = k * m
            v = v * m

        b, n, _ = q.shape
        m_len = k.shape[1]
        d = self.head_features
        h = q.shape[-1] // d  # num_heads, or num_heads / tp under tp

        def heads(a, length):
            return a.reshape(b, length, h, d).transpose(1, 2).contiguous()

        q, k, v = heads(q, n), heads(k, m_len), heads(v, m_len)
        if self.use_flash and n >= self.flash_min_seq_len and n == m_len:
            out = flash_attention(q, k, v, causal=causal)
        else:
            out = dot_product_attention(q, k, v, causal=causal)
        out = out.transpose(1, 2).reshape(b, n, h * d)
        return self.to_out(out)
