"""Snake activation x + sin^2(a x) / a, channels-last (port of
jen1_tpu/ops/snake.py).

Plain torch ops: the JAX package has no Pallas kernel here, so the port
has none either.
"""

from __future__ import annotations

import torch
from torch import nn


def snake(x: torch.Tensor, alpha: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """x (..., C), alpha (C,): computed in fp32, returned in x's dtype."""
    a = alpha.float()
    xf = x.float()
    y = xf + torch.reciprocal(a + eps) * torch.sin(a * xf).square()
    return y.to(x.dtype)


class Snake1d(nn.Module):
    """Per-channel learned frequency `alpha`, initialised at ones."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(channels))

    def init_parameters(self, generator):
        nn.init.ones_(self.alpha)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return snake(x, self.alpha)
