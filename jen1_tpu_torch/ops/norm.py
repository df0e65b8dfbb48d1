"""Normalisation layers, channels-last, fp32 statistics (port of
jen1_tpu/ops/norm.py). Under sequence parallelism GroupNorm's statistics
span the whole length (parallel/sp.py::group_norm)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from jen1_tpu_torch.parallel import sp as seq


class GroupNorm(nn.Module):
    """GroupNorm over the channel (last) axis of (B, L, C); statistics over
    (L, channels-in-group) in fp32, output in the input dtype."""

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if seq.active() is not None:
            return seq.group_norm(x, self.num_groups, self.weight, self.bias,
                                  self.eps).to(x.dtype)
        y = F.group_norm(x.transpose(1, 2).float(), self.num_groups, self.weight,
                         self.bias, self.eps)
        return y.to(x.dtype).transpose(1, 2)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with fp32 statistics."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def init_parameters(self, generator):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, self.eps)
        return y.to(x.dtype)
