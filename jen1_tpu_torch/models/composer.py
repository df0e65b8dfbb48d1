"""Multi-track (Composer) conditioning helpers the trainer calls (port of
jen1_tpu/models/composer.py:48-64). Tracks are channel groups of one latent
(B, L, n_tracks * track_dim); n_tracks = 1 is single-track JEN-1. The
track-subset masks and `generate_tracks` are not ported yet."""

from __future__ import annotations

from typing import Tuple

import torch


def expand_track_mask(mask: torch.Tensor, track_dim: int) -> torch.Tensor:
    """(B, L, n_tracks) -> (B, L, n_tracks * track_dim): each track's mask
    repeated over its latent channel group."""
    return torch.repeat_interleave(mask, track_dim, dim=-1)


def composer_conditioning(
    latents: torch.Tensor,  # (B, L, n_tracks * track_dim)
    mask: torch.Tensor,  # (B, L, n_tracks)
    track_dim: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked_input, mask_channels) for the channel-concat conditioning:
    the masked latent plus one mask channel per track."""
    full = expand_track_mask(mask, track_dim)
    return latents * full.to(latents.dtype), mask
