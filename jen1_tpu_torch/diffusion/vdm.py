"""Continuous-time trigonometric v-diffusion: sampler and training loss
(port of jen1_tpu/diffusion/vdm.py).

alpha(t) = cos(t pi/2), sigma(t) = sin(t pi/2); the deterministic v-space
sampler walks linspace(1 -> 0, step + 1) as a `VDMSampler`: static buffers
and a device table of each step's (t, alpha, sigma, alpha_next,
sigma_next), computed on the host in fp32, read through the step index
("scan": advanced on the device; "stepwise": written by the host), so that
on the card the step can run as a captured CUDA graph (`gdm.StaticSampler`,
utils/cuda_graphs.py). The training loss (vdm.py:104-139) draws t ~ U[0, 1)
per example; its times, noise and CFG dropout bits can be handed in
instead. With `dropout_during_sampling` the sampler's UNet calls keep the
training CFG dropout, each step's bits drawn from the request's generator
by the host into a static buffer before the step, in the order the eager
loop drew them (vdm.py:48, 179).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from jen1_tpu_torch.diffusion.gdm import (
    StaticSampler,
    draw_cfg_bits,
    noise_like,
    with_init_data,
)

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
        mode: str = "scan",
    ) -> torch.Tensor:
        """Deterministic v-space sampler from x_T = `initial_noise(...)`, plus
        `init_data` (the encoded init audio) in fp32 when given
        (jen1_tpu/diffusion/vdm.py:157-160), as an eager `VDMSampler`."""
        sampler = VDMSampler(self, model_fn, shape, conditioning, device=device, steps=step,
                             causal=causal, mode=mode)
        return sampler.sample(conditioning, generator, init_data)


class VDMSampler(StaticSampler):
    """The v-space sampler (jen1_tpu/diffusion/vdm.py:143-252) on static
    buffers (module docstring). With `graphs` (a
    utils/cuda_graphs.py::GraphSet) its step runs as a CUDA graph on the
    card; `conditioning` gives the shapes of the static buffers."""

    def __init__(self, vdm: VDM, model_fn: ModelFn, shape: Sequence[int],
                 conditioning: Conditioning, *, device, steps: int, causal: bool = False,
                 mode: str = "scan", graphs=None):
        from jen1_tpu_torch.utils.cuda_graphs import StepProgram

        super().__init__(shape, conditioning, steps=steps, mode=mode, device=device)
        self.vdm = vdm
        self.model_fn = model_fn
        self.causal = causal
        ts = np.linspace(1.0, 0.0, steps + 1, dtype=np.float32)
        rows = [(t, *alpha_sigma(t), *alpha_sigma(t_next)) for t, t_next in zip(ts[:-1], ts[1:])]
        self.table = torch.from_numpy(np.array(rows, np.float32)).to(self.device)
        self.bits = None
        if vdm.dropout_during_sampling:
            # the current step's bits, drawn by the host before the step
            self.bits = torch.zeros((self.batch, 1, 1), dtype=torch.bool, device=self.device)
        self.programs = (StepProgram(self.device, graphs),)

    def _step(self) -> None:
        t, alpha, sigma, alpha_next, sigma_next = self.at_step(self.table).unbind(0)
        dropout = {}
        if self.bits is not None:
            dropout = dict(embedding_mask_proba=self.vdm.cfg_dropout_proba,
                           embedding_mask_bits=self.bits)
        audio = self.audio
        v_pred = self.vdm._call_model(
            self.model_fn, audio, t.expand(self.batch).contiguous(), self.cond,
            causal=self.causal, **dropout,
        ).float()
        x_pred = alpha * audio - sigma * v_pred
        noise_pred = sigma * audio + alpha * v_pred
        audio.copy_(alpha_next * x_pred + sigma_next * noise_pred)
        self.advance()

    def sample(self, conditioning: Conditioning, generator: torch.Generator,
               init_data: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One request: x_T (+ init_data), then the steps, each after its
        CFG bits are drawn with dropout_during_sampling."""
        x_t = with_init_data(initial_noise(self.shape, generator, self.device), init_data)
        self.load(x_t, conditioning)
        draw = None
        if self.bits is not None:
            def draw(i: int) -> None:
                self.bits.copy_(draw_cfg_bits(generator, self.batch,
                                              self.vdm.cfg_dropout_proba, self.device))
        return self.run([(self.programs[0], self._step)] * self.steps, draw)


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
