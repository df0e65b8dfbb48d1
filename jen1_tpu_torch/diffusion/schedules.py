"""Noise schedules (port of jen1_tpu/diffusion/schedules.py:15-45):
numpy float32 beta tables, computed on the host."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np


def get_beta_schedule(
    schedule_name: str, num_diffusion_timesteps: int
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    if schedule_name == "linear":
        scale = 1000 / num_diffusion_timesteps
        return (
            np.linspace(
                scale * 0.0001, scale * 0.02, num_diffusion_timesteps, dtype=np.float64
            ).astype(np.float32),
            None,
        )
    if schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def betas_for_alpha_bar(
    num_diffusion_timesteps: int, alpha_bar, max_beta: float = 0.999
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.asarray(betas, dtype=np.float32), None
