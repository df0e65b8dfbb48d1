"""Seeded parameter initialisation (port of jen1_tpu/ops/initializers.py).

The JAX package draws torch-default U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
Linear, Conv and LSTM weights and biases, and normal(1.0) for embeddings and
T5 kernels. The port draws the same distributions from an explicit
`torch.Generator` on the parameters' device: modules that own parameters
define `init_parameters(generator)`, and `init_module` calls them in
registration order. The numbers differ from JAX's stream; weights that must
agree come through `ckpt/from_jax.py`.
"""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def torch_uniform_(t: torch.Tensor, fan_in: int, generator: torch.Generator):
    bound = 1.0 / (fan_in**0.5)
    return t.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def normal_(t: torch.Tensor, generator: torch.Generator):
    return t.normal_(0.0, 1.0, generator=generator)


@torch.no_grad()
def init_module(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter-owning submodule from `generator`."""
    for m in module.modules():
        init = getattr(m, "init_parameters", None)
        if init is not None:
            init(generator)
    return module
