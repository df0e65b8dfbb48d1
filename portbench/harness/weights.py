"""The benchmark's weights: made on the device from the run's seed, in one
draw, and handed by name to the program and to the plain reference alike.

Every floating tensor of the reference's state dicts takes its slice of
one U(-1, 1) draw, scaled by its role: a matrix or kernel by
1/sqrt(fan_in) (fan_in = its size over its first axis), a bias by 0.1, a
norm scale to 1 + 0.1 u, Fourier frequencies by 2. Tensors are visited in
sorted name order, so the same seed gives the same weights on both sides.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch


def _rule(name: str, shape: Tuple[int, ...], u: torch.Tensor) -> torch.Tensor:
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) >= 2:
        return u * (1.0 / math.sqrt(math.prod(shape[1:])))
    if "bias" in leaf:
        return u * 0.1
    if leaf == "weights":  # Fourier frequencies of the time embeddings
        return u * 2.0
    return 1.0 + 0.1 * u


def shapes(modules: Dict[str, torch.nn.Module]) -> Iterable[Tuple[str, Tuple[int, ...]]]:
    """(group.name, shape) of every floating tensor, sorted."""
    out = []
    for group, module in modules.items():
        for name, t in module.state_dict().items():
            if t.is_floating_point():
                out.append((f"{group}.{name}", tuple(t.shape)))
    return sorted(out)


def seeded(modules: Dict[str, torch.nn.Module], seed: int,
           device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{group: state dict} for `modules` (any device, meta included) from
    `seed`, made on `device`."""
    entries = list(shapes(modules))
    total = sum(math.prod(s) for _, s in entries)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    out: Dict[str, Dict[str, torch.Tensor]] = {g: {} for g in modules}
    offset = 0
    for full, shape in entries:
        n = math.prod(shape)
        group, name = full.split(".", 1)
        out[group][name] = _rule(name, shape, flat[offset:offset + n].view(shape))
        offset += n
    return out


def weight_seed(seed: int) -> int:
    """A 63-bit seed of the weights, derived from the run's seed."""
    return (int(seed) * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019) % (2**63)
