"""Snake activation x + sin^2(a x) / a, channels-last (port of
jen1_tpu/ops/snake.py), and SnakeBeta, the Oobleck VAE's two-parameter
variant (codec/oobleck.py).

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


def snake_beta(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-9) -> torch.Tensor:
    """SnakeBeta (stable-audio-tools `models/activations.py`), log-scale
    parameters: x + sin^2(x e^alpha) / (e^beta + eps). x (..., C), alpha and
    beta (C,); computed in fp32, returned in x's dtype."""
    xf = x.float()
    y = xf + torch.sin(xf * alpha.float().exp()).square() / (beta.float().exp() + eps)
    return y.to(x.dtype)


class SnakeBeta(nn.Module):
    """Per-channel log-scale frequency `alpha` and magnitude `beta`, both
    initialised at zero (e^0 = 1), as the Oobleck VAE's activations."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(channels))
        self.beta = nn.Parameter(torch.empty(channels))

    def init_parameters(self, generator):
        nn.init.zeros_(self.alpha)
        nn.init.zeros_(self.beta)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return snake_beta(x, self.alpha, self.beta)
