"""Discrete-time Gaussian diffusion: buffers, forward process and training
loss (port of jen1_tpu/diffusion/gdm.py:42-275 and :669-697).

Same tables (float64 on the host, stored fp32 on the device), objectives
('noise' | 'x0' | 'v') and losses (l1 / l2) as the JAX package. The noise,
the timesteps and the CFG dropout bits of a loss can be handed in, so a
test can feed both packages the same draws. The DDPM / DDIM samplers are
not ported yet. All arrays are channels-last (B, L, C).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

ModelFn = Callable[..., torch.Tensor]
Conditioning = Dict[str, Any]


def _extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-timestep scalars (B,) reshaped to broadcast over (B, ...)."""
    out = table[t]
    return out.reshape(out.shape[0], *((1,) * (ndim - 1)))


def noise_like(x: torch.Tensor, generator: Optional[torch.Generator],
               uniform: bool = False) -> torch.Tensor:
    """fp32 N(0, I) noise of x's shape, or U[0, 1) under the compat flag."""
    draw = torch.rand if uniform else torch.randn
    return draw(tuple(x.shape), generator=generator, device=x.device, dtype=torch.float32)


class GaussianDiffusion:
    def __init__(
        self,
        *,
        steps: int,
        betas: np.ndarray,
        objective: str,
        loss_type: str,
        alphas: Optional[np.ndarray] = None,
        cfg_dropout_proba: float = 0.1,
        embedding_scale: float = 0.8,
        batch_cfg: bool = False,
        scale_cfg: bool = False,
        sampling_timesteps: Optional[int] = None,
        ddim_sampling_eta: float = 1.0,
        uniform_noise_compat: bool = False,
        dropout_during_sampling: bool = False,
        device="cpu",
    ):
        if objective not in {"noise", "x0", "v"}:
            raise ValueError(f"objective must be 'noise', 'x0' or 'v', got {objective!r}")
        if loss_type not in {"l1", "l2"}:
            raise ValueError(f"loss_type must be 'l1' or 'l2', got {loss_type!r}")
        self.objective = objective
        self.loss_type = loss_type
        self.cfg_dropout_proba = float(cfg_dropout_proba)
        self.embedding_scale = float(embedding_scale)
        self.batch_cfg = bool(batch_cfg)
        self.scale_cfg = bool(scale_cfg)
        self.uniform_noise_compat = uniform_noise_compat
        self.dropout_during_sampling = dropout_during_sampling

        self.num_timesteps = int(steps)
        self.sampling_timesteps = (
            int(sampling_timesteps) if sampling_timesteps is not None else self.num_timesteps
        )
        if self.sampling_timesteps > self.num_timesteps:
            raise ValueError("sampling_timesteps exceeds steps")
        self.is_ddim_sampling = self.sampling_timesteps < self.num_timesteps
        self.ddim_sampling_eta = float(ddim_sampling_eta)

        betas = np.asarray(betas, dtype=np.float64)
        if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
            raise ValueError("betas must be a 1-D table in (0, 1]")
        alphas = 1.0 - betas if alphas is None else np.asarray(alphas, np.float64)
        alphas_cumprod = np.cumprod(alphas)
        alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
        posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)

        def as32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        self.betas = as32(betas)
        self.alphas_cumprod = as32(alphas_cumprod)
        self.alphas_cumprod_prev = as32(alphas_cumprod_prev)
        self.sqrt_alphas_cumprod = as32(np.sqrt(alphas_cumprod))
        self.sqrt_one_minus_alphas_cumprod = as32(np.sqrt(1.0 - alphas_cumprod))
        self.log_one_minus_alphas_cumprod = as32(np.log(1.0 - alphas_cumprod))
        self.sqrt_recip_alphas_cumprod = as32(np.sqrt(1.0 / alphas_cumprod))
        self.sqrt_recipm1_alphas_cumprod = as32(np.sqrt(1.0 / alphas_cumprod - 1.0))
        self.posterior_variance = as32(posterior_variance)
        self.posterior_log_variance_clipped = as32(
            np.log(np.concatenate([[posterior_variance[1]], posterior_variance[1:]]))
        )
        self.posterior_mean_coef1 = as32(
            betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        )
        self.posterior_mean_coef2 = as32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
        )

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """x_t = sqrt(acp_t) x_0 + sqrt(1 - acp_t) noise, fp32."""
        nd = x_start.dim()
        return (
            _extract(self.sqrt_alphas_cumprod, t, nd) * x_start
            + _extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * noise
        )

    def _call_model(
        self,
        model_fn: ModelFn,
        x: torch.Tensor,
        t: torch.Tensor,
        conditioning: Conditioning,
        *,
        causal: bool,
        dropout: bool,
        generator: Optional[torch.Generator] = None,
        cfg_bits: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """The denoiser with the CFG plumbing (gdm.py:160-190)."""
        concat = conditioning.get("input_concat_cond")
        return model_fn(
            x,
            t,
            embedding=conditioning["cross_attn_cond"],
            embedding_mask=conditioning.get("cross_attn_masks"),
            embedding_scale=self.embedding_scale,
            embedding_mask_proba=self.cfg_dropout_proba if dropout else 0.0,
            features=conditioning.get("global_cond"),
            channels_list=[concat] if concat is not None else None,
            batch_cfg=self.batch_cfg,
            scale_cfg=self.scale_cfg,
            causal=causal,
            generator=generator,
            embedding_mask_bits=cfg_bits,
        )

    def training_losses(
        self,
        model_fn: ModelFn,
        x_start: torch.Tensor,
        t: torch.Tensor,
        conditioning: Conditioning,
        *,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        cfg_bits: Optional[torch.Tensor] = None,
        causal: bool = False,
        reduce: str = "mean",
    ) -> torch.Tensor:
        """Diffusion loss (gdm.py:233-275). Noise and CFG bits not handed in
        are drawn from `generator`. reduce='none' returns the per-example
        loss (B,)."""
        if noise is None:
            noise = noise_like(x_start, generator, self.uniform_noise_compat)
        x_t = self.q_sample(x_start, t, noise)
        model_out = self._call_model(
            model_fn, x_t, t, conditioning, causal=causal, dropout=True,
            generator=generator, cfg_bits=cfg_bits,
        ).float()

        nd = x_start.dim()
        if self.objective == "noise":
            target = noise
        elif self.objective == "x0":
            target = x_start.float()
        else:  # 'v'
            target = (
                _extract(self.sqrt_alphas_cumprod, t, nd) * noise
                - _extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * x_start
            )
        err = model_out - target
        dims = tuple(range(1, nd))
        per_ex = err.abs().mean(dims) if self.loss_type == "l1" else err.square().mean(dims)
        return per_ex if reduce == "none" else per_ex.mean()


def create_gaussian_diffusion(
    gdm_config, sampling_steps: Optional[int] = None, device="cpu"
) -> GaussianDiffusion:
    """Factory from a `jen1_tpu_torch.config.GDMConfig` (gdm.py:669-697)."""
    from jen1_tpu_torch.diffusion.schedules import get_beta_schedule

    if sampling_steps is None:
        sampling_steps = gdm_config.sampling_timesteps
    betas, alphas = get_beta_schedule(gdm_config.noise_schedule, gdm_config.steps)
    return GaussianDiffusion(
        steps=gdm_config.steps,
        betas=betas,
        alphas=alphas,
        objective=gdm_config.objective,
        loss_type=gdm_config.loss_type,
        cfg_dropout_proba=gdm_config.cfg_dropout_proba,
        embedding_scale=gdm_config.embedding_scale,
        batch_cfg=gdm_config.batch_cfg,
        scale_cfg=gdm_config.scale_cfg,
        sampling_timesteps=sampling_steps,
        ddim_sampling_eta=gdm_config.ddim_sampling_eta,
        uniform_noise_compat=gdm_config.uniform_noise_compat,
        dropout_during_sampling=gdm_config.dropout_during_sampling,
        device=device,
    )
