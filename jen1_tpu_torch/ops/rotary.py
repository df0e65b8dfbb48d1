"""Rotary position embedding over the leading dims of each head, in fp32
(stable-audio-tools `models/transformer.py`: `RotaryEmbedding`,
`rotate_half`, `apply_rotary_pos_emb`).

Frequencies base^(-2i/dim) for i < dim / 2, concatenated twice to width
`dim`; rotate_half splits the rotated dims in halves, so the pairs are
(i, i + dim / 2). Dims past `dim` pass unrotated (partial rotary).
Plain torch ops: the JAX package has no such kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rotary_tables(n: int, dim: int, base: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (n, dim) fp32, for positions 0..n-1."""
    inv_freq = 1.0 / (base ** (torch.arange(0, dim, 2, device=device, dtype=torch.float32)
                               / dim))
    freqs = torch.arange(n, device=device, dtype=torch.float32)[:, None] * inv_freq[None, :]
    freqs = torch.cat([freqs, freqs], dim=-1)
    return freqs.cos(), freqs.sin()


def apply_rotary(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """t (..., n, D) rotated on its first cos.shape[-1] dims in fp32, in t's
    dtype; a contiguous result."""
    r = cos.shape[-1]
    rot = t[..., :r].float()
    x1, x2 = rot.chunk(2, dim=-1)
    out = rot * cos + torch.cat([-x2, x1], dim=-1) * sin
    return torch.cat([out.to(t.dtype), t[..., r:]], dim=-1)
