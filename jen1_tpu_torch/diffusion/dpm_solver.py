"""DPM-Solver++(2M) over the discrete GDM schedule (port of
jen1_tpu/diffusion/dpm_solver.py:33-151, without `encoder_reuse`).

A second-order multistep solver of the probability-flow ODE in
data-prediction form, on the timestep grid of `GaussianDiffusion.ddim_sample`,
one CFG model call per step. Deterministic after x_T.

With alpha_t = sqrt(acp[t]), sigma_t = sqrt(1 - acp[t]), lambda_t =
log(alpha_t) - log(sigma_t), h = lambda_t - lambda_s and m the predicted x0:
  first step: x_t = (sigma_t / sigma_s) x_s - alpha_t (e^-h - 1) m_s
  later:      D = m_s + (m_s - m_prev) / (2 r), r = h_prev / h, and D for m_s
  last step (t < 0): x = m_s.
The scalars are fp32, computed on the host as the JAX scan computes them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from jen1_tpu_torch.diffusion import gdm as _gdm


@torch.no_grad()
def dpm_solver_pp_2m(
    gdm,
    model_fn,
    shape: Sequence[int],
    conditioning: Dict[str, Any],
    generator: torch.Generator,
    *,
    device,
    causal: bool = False,
    init_data: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sample with DPM-Solver++(2M); `gdm` (a GaussianDiffusion) gives the
    schedule, the objective and the CFG call (x0 clipped to [-1, 1]).
    gdm.sampling_timesteps model calls, from x_T + init_data when given
    (dpm_solver.py:66-69)."""
    batch = shape[0]
    acp = gdm.alphas_cumprod_host
    alpha = np.sqrt(acp)
    sigma = np.sqrt(np.float32(1.0) - acp)
    lam = np.log(alpha) - np.log(sigma)

    x = _gdm.with_init_data(_gdm.initial_noise(shape, generator, device), init_data)
    m_prev, lam_prev = None, np.float32(0.0)
    for i, (t_s, t_t) in enumerate(_gdm.time_pairs(gdm.num_timesteps, gdm.sampling_timesteps)):
        time_cond = torch.full((batch,), t_s, dtype=torch.long, device=device)
        _, m = gdm.model_predictions(model_fn, x, time_cond, conditioning,
                                     clip_x_start=True, causal=causal,
                                     generator=generator)
        t_safe = max(t_t, 0)
        lam_s, lam_t = lam[t_s], lam[t_safe]
        h = lam_t - lam_s
        if i > 0:
            r = (lam_s - lam_prev) / max(h, np.float32(1e-12))
            d = m + (m - m_prev) / float(max(np.float32(2.0) * r, np.float32(1e-12)))
        else:
            d = m
        if t_t < 0:
            x = m
        else:
            coef_x = sigma[t_safe] / sigma[t_s]
            coef_d = alpha[t_safe] * (np.exp(-h) - np.float32(1.0))
            x = float(coef_x) * x - float(coef_d) * d
        m_prev, lam_prev = m, lam_s
    return x
