"""Continuous-time trigonometric v-diffusion: sampler and training loss
(port of jen1_tpu/diffusion/vdm.py).

alpha(t) = cos(t pi/2), sigma(t) = sin(t pi/2); the deterministic v-space
sampler walks linspace(1 -> 0, step + 1) as a Python loop. The training
loss (vdm.py:104-139) draws t ~ U[0, 1) per example; its times, noise and
CFG dropout bits can be handed in instead. With `dropout_during_sampling`
the sampler's UNet calls keep the training CFG dropout, each step drawing
its bits from the request's generator (vdm.py:48, 179).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from jen1_tpu_torch.diffusion.gdm import noise_like, with_init_data

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
        loss_type: str = "l2",
        cfg_dropout_proba: float = 0.1,
        embedding_scale: float = 0.8,
        batch_cfg: bool = False,
        scale_cfg: bool = False,
        uniform_noise_compat: bool = False,
        xt_target_compat: bool = False,
        dropout_during_sampling: bool = False,
    ):
        if loss_type not in {"l1", "l2"}:
            raise ValueError(f"loss_type must be 'l1' or 'l2', got {loss_type!r}")
        self.loss_type = loss_type
        self.cfg_dropout_proba = float(cfg_dropout_proba)
        self.embedding_scale = float(embedding_scale)
        self.batch_cfg = bool(batch_cfg)
        self.scale_cfg = bool(scale_cfg)
        self.uniform_noise_compat = uniform_noise_compat
        self.xt_target_compat = xt_target_compat
        self.dropout_during_sampling = bool(dropout_during_sampling)

    def _call_model(self, model_fn, x, t, conditioning, *, causal: bool, **dropout):
        """The denoiser with the CFG plumbing; `dropout` holds the training
        call's embedding_mask_proba, generator and embedding_mask_bits."""
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
            **dropout,
        )

    def q_sample(self, x_start: torch.Tensor, times: torch.Tensor, noise: torch.Tensor):
        """times (B,) in [0, 1] -> (x_t, alphas, sigmas), the last two
        shaped to broadcast over x_start."""
        shape = (-1,) + (1,) * (x_start.dim() - 1)
        alphas, sigmas = (a.reshape(shape) for a in alpha_sigma(times))
        return x_start * alphas + noise * sigmas, alphas, sigmas

    def training_losses(
        self,
        model_fn: ModelFn,
        x_start: torch.Tensor,
        conditioning: Conditioning,
        *,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        times: Optional[torch.Tensor] = None,
        cfg_bits: Optional[torch.Tensor] = None,
        causal: bool = False,
        reduce: str = "mean",
    ) -> torch.Tensor:
        """v-objective loss (vdm.py:104-139). Times, noise and CFG bits not
        handed in are drawn from `generator`. reduce='none' returns the
        per-example loss (B,)."""
        b = x_start.shape[0]
        if times is None:
            times = torch.rand((b,), generator=generator, device=x_start.device)
        if noise is None:
            noise = noise_like(x_start, generator, self.uniform_noise_compat)
        x_t, alphas, sigmas = self.q_sample(x_start, times, noise)
        model_out = self._call_model(
            model_fn, x_t, times, conditioning, causal=causal,
            embedding_mask_proba=self.cfg_dropout_proba, generator=generator,
            embedding_mask_bits=cfg_bits,
        ).float()
        base = x_t if self.xt_target_compat else x_start
        target = noise * alphas - base * sigmas
        err = model_out - target
        dims = tuple(range(1, x_start.dim()))
        per_ex = err.abs().mean(dims) if self.loss_type == "l1" else err.square().mean(dims)
        return per_ex if reduce == "none" else per_ex.mean()

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
        init_data: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Deterministic v-space sampler from x_T = `initial_noise(...)`, plus
        `init_data` (the encoded init audio) in fp32 when given
        (jen1_tpu/diffusion/vdm.py:157-160)."""
        batch = shape[0]
        audio = with_init_data(initial_noise(shape, generator, device), init_data)
        steps = np.linspace(1.0, 0.0, step + 1, dtype=np.float32)
        dropout = {}
        if self.dropout_during_sampling:
            dropout = dict(embedding_mask_proba=self.cfg_dropout_proba, generator=generator)
        for t, t_next in zip(steps[:-1], steps[1:]):
            time_cond = torch.full((batch,), float(t), dtype=torch.float32, device=device)
            v_pred = self._call_model(
                model_fn, audio, time_cond, conditioning, causal=causal, **dropout
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
        loss_type=vdm_config.loss_type,
        cfg_dropout_proba=vdm_config.cfg_dropout_proba,
        embedding_scale=vdm_config.embedding_scale,
        batch_cfg=vdm_config.batch_cfg,
        scale_cfg=vdm_config.scale_cfg,
        uniform_noise_compat=vdm_config.uniform_noise_compat,
        xt_target_compat=vdm_config.xt_target_compat,
    )
