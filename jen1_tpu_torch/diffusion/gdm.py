"""Discrete-time Gaussian diffusion: buffers, forward process, training
loss and the DDPM / DDIM samplers (port of jen1_tpu/diffusion/gdm.py).

Same tables (float64 on the host, stored fp32 on the device), objectives
('noise' | 'x0' | 'v') and losses (l1 / l2) as the JAX package. The noise,
the timesteps and the CFG dropout bits of a loss can be handed in, so a
test can feed both packages the same draws. The samplers are Python loops
(the JAX `lax.scan`s); every draw goes through `initial_noise` (x_T) or
`step_noise` (each step's noise), which a test can replace. DDIM and
DPM-Solver++ take `encoder_reuse=k` (Faster-Diffusion encoder propagation):
the first step of every k-step block runs the whole UNet and keeps its
encoder cache, the other k - 1 run the decoder against it
(`reuse_schedule`). All arrays are channels-last (B, L, C).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

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


def initial_noise(shape: Sequence[int], generator: torch.Generator, device) -> torch.Tensor:
    """A sampler's x_T ~ N(0, I), fp32."""
    return torch.randn(tuple(shape), generator=generator, device=device)


def with_init_data(x_t: torch.Tensor, init_data: Optional[torch.Tensor]) -> torch.Tensor:
    """x_T plus the encoded init audio in fp32, the JAX samplers' start
    (gdm.py:279-283); x_T alone without it."""
    return x_t if init_data is None else x_t + init_data.float()


def step_noise(x: torch.Tensor, generator: torch.Generator, index: int,
               uniform: bool = False) -> torch.Tensor:
    """The noise of sampler step `index` (0 for the first step taken), of
    x's shape; U[0, 1) for DDPM under `uniform_noise_compat`."""
    return noise_like(x, generator, uniform)


def reuse_schedule(steps: int, encoder_reuse: int, final_full: bool) -> list:
    """Per sampler step, True where it runs the whole UNet (and refreshes the
    encoder cache), False where it runs the decoder against the cache: the
    first step of each `encoder_reuse`-step block. DDIM (`final_full=True`)
    also runs the last step whole, since its x_start is the sample
    (jen1_tpu/diffusion/gdm.py:357-412); DPM-Solver++ runs the steps after
    its last whole block whole (jen1_tpu/diffusion/dpm_solver.py:90-133), so
    when `encoder_reuse` divides `steps` its last step is decoder-only."""
    k = max(1, int(encoder_reuse))
    whole_blocks = steps // k * k
    return [i % k == 0 or (final_full and i == steps - 1)
            or (not final_full and i >= whole_blocks) for i in range(steps)]


def time_pairs(num_timesteps: int, sampling_timesteps: int):
    """(t, t_next) per step: linspace(-1, T - 1, S + 1) as int32, descending
    (gdm.py:311-316); t_next = -1 on the last step."""
    times = np.linspace(-1, num_timesteps - 1, num=sampling_timesteps + 1).astype(np.int32)
    times = times[::-1]
    return [(int(a), int(b)) for a, b in zip(times[:-1], times[1:])]


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

        # fp32 host copy for the per-step scalars of the samplers
        self.alphas_cumprod_host = np.asarray(alphas_cumprod, np.float32)
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
        encoder_cache=None,
        return_encoder_cache: bool = False,
    ):
        """The denoiser with the CFG plumbing (gdm.py:160-190). The encoder
        cache arguments reach the model only when used, as JAX's `extra`
        (gdm.py:173-174); with `return_encoder_cache` the result is
        (output, cache)."""
        concat = conditioning.get("input_concat_cond")
        extra = {}
        if encoder_cache is not None or return_encoder_cache:
            extra = dict(encoder_cache=encoder_cache, return_encoder_cache=return_encoder_cache)
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
            **extra,
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

    # ----------------------------------------------------------- samplers

    def predict_start_from_noise(self, x_t, t, noise):
        nd = x_t.dim()
        return (_extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t
                - _extract(self.sqrt_recipm1_alphas_cumprod, t, nd) * noise)

    def predict_noise_from_start(self, x_t, t, x0):
        nd = x_t.dim()
        return ((_extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t - x0)
                / _extract(self.sqrt_recipm1_alphas_cumprod, t, nd))

    def predict_start_from_v(self, x_t, t, v):
        nd = x_t.dim()
        return (_extract(self.sqrt_alphas_cumprod, t, nd) * x_t
                - _extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * v)

    def q_posterior(self, x_start, x_t, t):
        """(mean, variance, log variance) of q(x_{t-1} | x_t, x_0)."""
        nd = x_t.dim()
        mean = (_extract(self.posterior_mean_coef1, t, nd) * x_start
                + _extract(self.posterior_mean_coef2, t, nd) * x_t)
        return (mean, _extract(self.posterior_variance, t, nd),
                _extract(self.posterior_log_variance_clipped, t, nd))

    def _predictions_from_out(self, model_out, x, t, clip_x_start: bool):
        """Objective-specific (pred_noise, x_start) from the raw model output
        (gdm.py:209-229)."""
        model_out = model_out.float()

        def clip(a):
            return a.clamp(-1.0, 1.0) if clip_x_start else a

        if self.objective == "noise":
            pred_noise = model_out
            x_start = clip(self.predict_start_from_noise(x, t, pred_noise))
        elif self.objective == "x0":
            x_start = clip(model_out)
            pred_noise = self.predict_noise_from_start(x, t, x_start)
        else:  # 'v'
            x_start = clip(self.predict_start_from_v(x, t, model_out))
            pred_noise = self.predict_noise_from_start(x, t, x_start)
        return pred_noise, x_start

    def model_predictions(self, model_fn, x, t, conditioning, *, clip_x_start=False,
                          causal=False, generator=None):
        """(pred_noise, x_start) of one sampling call of the denoiser."""
        model_out = self._call_model(
            model_fn, x, t, conditioning, causal=causal,
            dropout=self.dropout_during_sampling, generator=generator,
        )
        return self._predictions_from_out(model_out, x, t, clip_x_start)

    def cached_predictions(self, model_fn, x, t, conditioning, *, cache, causal=False,
                           generator=None):
        """(pred_noise, x_start clipped, encoder cache) of one sampling call
        that returns its encoder cache; decoder-only when `cache` is given."""
        model_out, cache = self._call_model(
            model_fn, x, t, conditioning, causal=causal,
            dropout=self.dropout_during_sampling, generator=generator,
            encoder_cache=cache, return_encoder_cache=True,
        )
        return (*self._predictions_from_out(model_out, x, t, True), cache)

    @torch.no_grad()
    def ddim_sample(
        self,
        model_fn: ModelFn,
        shape: Sequence[int],
        conditioning: Conditioning,
        generator: torch.Generator,
        *,
        device,
        causal: bool = False,
        init_data: Optional[torch.Tensor] = None,
        return_all_timesteps: bool = False,
        encoder_reuse: int = 1,
    ) -> torch.Tensor:
        """DDIM (gdm.py:285-438) over `sampling_timesteps` steps, x_start
        clipped to [-1, 1]. The step's scalars are fp32, computed on the
        host as the JAX scan computes them; each step draws its noise (used
        where eta > 0). `return_all_timesteps` stacks x_T and every step's
        result (S + 1, ...). encoder_reuse > 1 runs the UNet's decoder alone
        on the steps `reuse_schedule(S, k, final_full=True)` marks, against
        the cache of the last whole forward."""
        if encoder_reuse > 1 and return_all_timesteps:
            raise ValueError("encoder_reuse>1 does not support return_all_timesteps")
        batch = shape[0]
        acp = self.alphas_cumprod_host
        eta = np.float32(self.ddim_sampling_eta)
        one = np.float32(1.0)
        audio = with_init_data(initial_noise(shape, generator, device), init_data)
        trajectory = [audio]
        pairs = time_pairs(self.num_timesteps, self.sampling_timesteps)
        whole = reuse_schedule(len(pairs), encoder_reuse, final_full=True)
        cache = None
        for i, (time, time_next) in enumerate(pairs):
            time_cond = torch.full((batch,), time, dtype=torch.long, device=device)
            if encoder_reuse > 1:
                pred_noise, x_start, cache = self.cached_predictions(
                    model_fn, audio, time_cond, conditioning,
                    cache=None if whole[i] else cache, causal=causal, generator=generator,
                )
            else:
                pred_noise, x_start = self.model_predictions(
                    model_fn, audio, time_cond, conditioning, clip_x_start=True,
                    causal=causal, generator=generator,
                )
            alpha, alpha_next = acp[time], acp[max(time_next, 0)]
            sigma = eta * np.sqrt((one - alpha / alpha_next) * (one - alpha_next) / (one - alpha))
            c = np.sqrt(one - alpha_next - sigma * sigma)
            noise = step_noise(audio, generator, i)
            if time_next < 0:
                audio = x_start
            else:
                audio = (x_start * float(np.sqrt(alpha_next)) + float(c) * pred_noise
                         + float(sigma) * noise)
            if return_all_timesteps:
                trajectory.append(audio)
        return torch.stack(trajectory) if return_all_timesteps else audio

    @torch.no_grad()
    def p_sample_loop(
        self,
        model_fn: ModelFn,
        shape: Sequence[int],
        conditioning: Conditioning,
        generator: torch.Generator,
        *,
        device,
        causal: bool = False,
        init_data: Optional[torch.Tensor] = None,
        return_all_timesteps: bool = False,
    ) -> torch.Tensor:
        """Ancestral DDPM over all `num_timesteps` (gdm.py:440-481), x_start
        clipped to [-1, 1]. Step i runs t = T - 1 - i; the JAX stream folds
        t, not i, into its key. `return_all_timesteps` stacks x_T and every
        step's result."""
        batch = shape[0]
        audio = with_init_data(initial_noise(shape, generator, device), init_data)
        trajectory = [audio]
        for i, t in enumerate(range(self.num_timesteps - 1, -1, -1)):
            time_cond = torch.full((batch,), t, dtype=torch.long, device=device)
            _, x_start = self.model_predictions(
                model_fn, audio, time_cond, conditioning, clip_x_start=True,
                causal=causal, generator=generator,
            )
            mean, _, log_var = self.q_posterior(x_start, audio, time_cond)
            noise = step_noise(audio, generator, i, self.uniform_noise_compat)
            audio = mean + torch.exp(0.5 * log_var) * noise if t > 0 else mean
            if return_all_timesteps:
                trajectory.append(audio)
        return torch.stack(trajectory) if return_all_timesteps else audio

    def sample(
        self,
        model_fn: ModelFn,
        shape: Sequence[int],
        conditioning: Conditioning,
        generator: torch.Generator,
        *,
        device,
        causal: bool = False,
        mode: str = "scan",
        encoder_reuse: int = 1,
        init_data: Optional[torch.Tensor] = None,
        return_all_timesteps: bool = False,
    ) -> torch.Tensor:
        """DDIM iff sampling_timesteps < num_timesteps, else DDPM
        (gdm.py:581-666). mode 'scan' and 'stepwise' are one Python loop
        here (the JAX package's two are numerically identical, :498-499);
        'dpm++' runs DPM-Solver++(2M) (`diffusion/dpm_solver.py`). Every
        sampler starts from x_T + init_data when it is given.
        encoder_reuse > 1 needs DDIM ('scan') or 'dpm++', as in JAX."""
        if mode not in ("scan", "stepwise", "dpm++"):
            raise ValueError(f"mode must be 'scan', 'stepwise' or 'dpm++', got {mode!r}")
        if encoder_reuse > 1:
            # checked before the dispatch, so that no mode ignores the flag
            if mode == "stepwise":
                raise ValueError(
                    "encoder_reuse>1 requires mode='scan' or 'dpm++'; the "
                    "stepwise sampler does not implement encoder propagation")
            if not self.is_ddim_sampling and mode != "dpm++":
                raise ValueError("encoder_reuse is implemented for DDIM sampling")
        common = dict(device=device, causal=causal, init_data=init_data)
        if mode == "dpm++":
            from jen1_tpu_torch.diffusion.dpm_solver import dpm_solver_pp_2m

            if return_all_timesteps:
                raise ValueError("mode='dpm++' does not return all timesteps")
            return dpm_solver_pp_2m(self, model_fn, shape, conditioning, generator,
                                    encoder_reuse=encoder_reuse, **common)
        if mode == "stepwise":
            if not self.is_ddim_sampling:
                raise ValueError("mode='stepwise' implements DDIM")
            if return_all_timesteps:
                raise ValueError("mode='stepwise' does not return all timesteps")
        if self.is_ddim_sampling:
            return self.ddim_sample(model_fn, shape, conditioning, generator,
                                    return_all_timesteps=return_all_timesteps,
                                    encoder_reuse=encoder_reuse, **common)
        return self.p_sample_loop(model_fn, shape, conditioning, generator,
                                  return_all_timesteps=return_all_timesteps, **common)


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
