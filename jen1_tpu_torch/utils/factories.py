"""Object factories under the reference's construction names (port of
jen1_tpu/utils/factories.py): create_model, create_diffusion,
create_model_and_diffusion and create_multi_conditioner over the port's
own factories. Each builds on `device` ("cuda" by default)."""

from __future__ import annotations

from math import ceil, floor, log2
from typing import Optional, Tuple

import torch

from jen1_tpu_torch.config import Config


def exists(x) -> bool:
    return x is not None


def default(x, y):
    if x is not None:
        return x
    return y() if callable(y) else y


def closest_power_2(x: float) -> int:
    """The power of two nearest x."""
    exponent = log2(x)
    candidates = (floor(exponent), ceil(exponent))
    return 2 ** int(min(candidates, key=lambda z: abs(x - 2**z)))


def create_model(config: Config, *, device="cuda", generator: Optional[torch.Generator] = None):
    """The UNetCFG1d of `config.model_config`, random from `generator`
    (default: seeded with config.seed) on `device`."""
    from jen1_tpu_torch.api.generation import resolve_device
    from jen1_tpu_torch.models.unet import unet_from_model_config
    from jen1_tpu_torch.ops.initializers import init_module

    dev = resolve_device(device)
    with torch.device(dev):
        model = unet_from_model_config(config.model_config)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(config.seed)
    return init_module(model, generator)


def create_diffusion(config: Config, sampling_steps: Optional[int] = None, *, device="cuda"):
    if config.diffusion_type.lower() == "gdm":
        from jen1_tpu_torch.diffusion.gdm import create_gaussian_diffusion

        return create_gaussian_diffusion(config.diffusion_config.gaussian_diffusion,
                                         sampling_steps, device=device)
    if config.diffusion_type.lower() == "vdm":
        from jen1_tpu_torch.diffusion.vdm import create_variational_diffusion

        return create_variational_diffusion(config.diffusion_config.variational_diffusion)
    raise ValueError(f"unknown diffusion_type: {config.diffusion_type}")


def create_model_and_diffusion(config: Config, sampling_steps: Optional[int] = None, *,
                               device="cuda") -> Tuple[object, object]:
    return (create_model(config, device=device),
            create_diffusion(config, sampling_steps, device=device))


def create_multi_conditioner(conditioner_config, *, device="cuda",
                             generator: Optional[torch.Generator] = None):
    from jen1_tpu_torch.conditioning.conditioners import create_multi_conditioner as _create

    return _create(conditioner_config, device=device, generator=generator)
