"""Mixed-precision Linear (port of jen1_tpu/ops/linear.py).

The weight is stored fp32 and read at the activation dtype: its staged
copy (ops/staging.py) or a cast at the call; the product accumulates in
fp32 (cuBLAS does so for bf16 inputs). A subclass of `torch.nn.Linear`, so
that DTensor's tensor-parallel styles take it (parallel/mesh.py); its own
init and forward replace nn.Linear's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from jen1_tpu_torch.ops.initializers import torch_uniform_
from jen1_tpu_torch.ops.staging import compute_weights


class Linear(nn.Linear):
    """torch.nn.Linear semantics and init; weight (out, in)."""

    staged_reads = (("weight", False), ("bias", False))

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        nn.Module.__init__(self)  # nn.Linear's would allocate and initialise
        self.in_features = in_features
        self.out_features = features
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def init_parameters(self, generator):
        torch_uniform_(self.weight, self.in_features, generator)
        if self.bias is not None:
            torch_uniform_(self.bias, self.in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, *compute_weights(self, x.dtype))
