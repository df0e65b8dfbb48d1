"""Continuous-time trigonometric v-diffusion sampler (port of
jen1_tpu/diffusion/vdm.py).

alpha(t) = cos(t pi/2), sigma(t) = sin(t pi/2); the deterministic v-space
sampler walks linspace(1 -> 0, step + 1) as a Python loop. The training
loss and the GDM/DDIM samplers are not ported yet.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch

ModelFn = Callable[..., torch.Tensor]
Conditioning = Dict[str, Any]


def alpha_sigma(t):
    """(cos(t pi/2), sin(t pi/2)) for a tensor or an fp32 numpy scalar."""
    ang = t * np.float32(math.pi / 2)
    if isinstance(ang, torch.Tensor):
        return torch.cos(ang), torch.sin(ang)
    return np.cos(ang), np.sin(ang)


def initial_noise(
    shape: Sequence[int], generator: torch.Generator, device
) -> torch.Tensor:
    """x_T ~ N(0, I) in fp32: the sampler's only random draw."""
    return torch.randn(tuple(shape), generator=generator, device=device)


class VDM:
    def __init__(
        self,
        *,
        embedding_scale: float = 0.8,
        batch_cfg: bool = False,
        scale_cfg: bool = False,
    ):
        self.embedding_scale = float(embedding_scale)
        self.batch_cfg = bool(batch_cfg)
        self.scale_cfg = bool(scale_cfg)

    def _call_model(self, model_fn, x, t, conditioning, *, causal: bool):
        concat = conditioning.get("input_concat_cond")
        return model_fn(
            x,
            t,
            embedding=conditioning["cross_attn_cond"],
            embedding_mask=conditioning.get("cross_attn_masks"),
            embedding_scale=self.embedding_scale,
            features=conditioning.get("global_cond"),
            channels_list=[concat] if concat is not None else None,
            batch_cfg=self.batch_cfg,
            scale_cfg=self.scale_cfg,
            causal=causal,
        )

    @torch.no_grad()
    def p_sample_loop(
        self,
        model_fn: ModelFn,
        shape: Sequence[int],
        conditioning: Conditioning,
        generator: torch.Generator,
        *,
        device,
        step: int = 100,
        causal: bool = False,
    ) -> torch.Tensor:
        """Deterministic v-space sampler from x_T = `initial_noise(...)`."""
        batch = shape[0]
        audio = initial_noise(shape, generator, device)
        steps = np.linspace(1.0, 0.0, step + 1, dtype=np.float32)
        for t, t_next in zip(steps[:-1], steps[1:]):
            time_cond = torch.full((batch,), float(t), dtype=torch.float32, device=device)
            v_pred = self._call_model(
                model_fn, audio, time_cond, conditioning, causal=causal
            ).float()
            alpha, sigma = (float(a) for a in alpha_sigma(t))
            alpha_next, sigma_next = (float(a) for a in alpha_sigma(t_next))
            x_pred = alpha * audio - sigma * v_pred
            noise_pred = sigma * audio + alpha * v_pred
            audio = alpha_next * x_pred + sigma_next * noise_pred
        return audio


def create_variational_diffusion(vdm_config) -> VDM:
    """Factory from a `jen1_tpu_torch.config.VDMConfig`."""
    return VDM(
        embedding_scale=vdm_config.embedding_scale,
        batch_cfg=vdm_config.batch_cfg,
        scale_cfg=vdm_config.scale_cfg,
    )
