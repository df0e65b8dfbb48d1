"""Time and null-context embeddings and the CFG dropout draw (port of
jen1_tpu/ops/embeddings.py)."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from jen1_tpu_torch.ops.initializers import normal_
from jen1_tpu_torch.ops.linear import Linear


def rand_bool(
    generator: Optional[torch.Generator], shape: Sequence[int], proba: float, device=None
) -> torch.Tensor:
    """Bernoulli(proba) mask of `shape` (jen1_tpu/ops/embeddings.py:18-24):
    U[0, 1) < proba, drawn from `generator` on `device`. proba 0 and 1 draw
    nothing."""
    if proba == 1.0:
        return torch.ones(tuple(shape), dtype=torch.bool, device=device)
    if proba == 0.0:
        return torch.zeros(tuple(shape), dtype=torch.bool, device=device)
    return torch.rand(tuple(shape), generator=generator, device=device) < proba


class LearnedPositionalEmbedding(nn.Module):
    """Random-Fourier time embedding: (B,) -> (B, dim + 1) as
    [x, sin(2 pi x w), cos(2 pi x w)] with learned frequencies w."""

    def __init__(self, dim: int):
        super().__init__()
        assert dim % 2 == 0
        self.weights = nn.Parameter(torch.empty(dim // 2))

    def init_parameters(self, generator):
        normal_(self.weights, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()[:, None]
        freqs = xf * self.weights.float()[None, :] * (2 * math.pi)
        return torch.cat([xf, torch.sin(freqs), torch.cos(freqs)], dim=-1)


class TimePositionalEmbedding(nn.Module):
    """LearnedPositionalEmbedding followed by a Linear."""

    def __init__(self, dim: int, out_features: int):
        super().__init__()
        self.pos = LearnedPositionalEmbedding(dim)
        self.linear = Linear(dim + 1, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(self.pos(x))


class FixedEmbedding(nn.Module):
    """Learned null-context table (the CFG unconditional embedding),
    broadcast over the batch of `x` (B, L, ...)."""

    def __init__(self, max_length: int, features: int):
        super().__init__()
        self.max_length = max_length
        self.embedding = nn.Parameter(torch.empty(max_length, features))

    def init_parameters(self, generator):
        normal_(self.embedding, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, length = x.shape[0], x.shape[1]
        assert length <= self.max_length, "input length exceeds max_length"
        emb = self.embedding[:length].to(x.dtype)
        return emb[None].expand(b, length, emb.shape[-1])
