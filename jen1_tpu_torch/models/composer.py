"""JEN-1-Composer-style multi-track conditioning (port of
jen1_tpu/models/composer.py:23-112).

Tracks are channel groups of one latent, (B, L, n_tracks * track_dim); the
channel-concat conditioning carries each track's masked latent plus one
mask channel per track, so any subset of tracks conditions the generation
of the others (the `track_gen` task). n_tracks = 1 is single-track JEN-1.
The UNet is the standard one, built from `config.composer_config(n_tracks)`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from jen1_tpu_torch.ops.embeddings import rand_bool


def track_mask(batch: int, length: int, n_tracks: int, keep_tracks: Sequence[int],
               device=None) -> torch.Tensor:
    """(B, L, n_tracks) float32 mask: 1 for the tracks given as context, 0
    for the tracks to generate."""
    keep = torch.zeros((n_tracks,), device=device)
    if len(keep_tracks):
        keep[torch.as_tensor(list(keep_tracks), device=device)] = 1.0
    return keep[None, None, :].expand(batch, length, n_tracks)


def draw_track_bits(generator: Optional[torch.Generator], n_tracks: int,
                    device=None) -> torch.Tensor:
    """The training draw of `random_track_mask`: each track kept with
    probability 0.5, (n_tracks,) bool."""
    return rand_bool(generator, (n_tracks,), 0.5, device)


def track_bits_mask(bits: torch.Tensor, batch: int, length: int) -> torch.Tensor:
    """(B, L, n_tracks) mask of drawn keep-bits, shared over the batch; the
    all-kept draw becomes all-hidden, so there is always a track to
    generate (jen1_tpu/models/composer.py:36-45)."""
    bits = bits.float()
    bits = torch.where(bits.eq(1.0).all(), torch.zeros_like(bits), bits)
    return bits[None, None, :].expand(batch, length, bits.shape[0])


def random_track_mask(generator: Optional[torch.Generator], batch: int, length: int,
                      n_tracks: int, device=None) -> torch.Tensor:
    """Training mask of the track_gen task, drawn from `generator`."""
    return track_bits_mask(draw_track_bits(generator, n_tracks, device), batch, length)


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


def stack_tracks(tracks: Sequence[torch.Tensor]) -> torch.Tensor:
    """n_tracks x (B, L, D) -> (B, L, n_tracks * D)."""
    return torch.cat(list(tracks), dim=-1)


def split_tracks(latents: torch.Tensor, n_tracks: int) -> Tuple[torch.Tensor, ...]:
    """(B, L, n_tracks * D) -> n_tracks x (B, L, D)."""
    return tuple(torch.chunk(latents, n_tracks, dim=-1))


def generate_tracks(diffusion, model_fn, *, generator: Optional[torch.Generator],
                    n_tracks: int, track_dim: int, length: int, text_cond: dict,
                    context_tracks: Optional[dict] = None, batch: int = 1,
                    causal: bool = False, device=None, **sample_kw) -> torch.Tensor:
    """Track-conditional sampling (jen1_tpu/models/composer.py:76-112):
    `context_tracks` maps a track index to its (B, L, track_dim) latent,
    given as context; the other tracks are generated. `text_cond` holds the
    conditioner's cross_attn_cond / cross_attn_masks / global_cond; the
    input_concat_cond is assembled here. `diffusion` is a GDM (`sample`)
    or a VDM (`p_sample_loop`). Returns (B, L, n_tracks * track_dim)."""
    context_tracks = context_tracks or {}
    base = torch.zeros((batch, length, n_tracks * track_dim), device=device)
    for ti, lat in context_tracks.items():
        base[..., ti * track_dim:(ti + 1) * track_dim] = lat.float()
    mask = track_mask(batch, length, n_tracks, sorted(context_tracks), device)
    masked_input, mask_ch = composer_conditioning(base, mask, track_dim)
    conditioning = dict(text_cond)
    conditioning["input_concat_cond"] = torch.cat([masked_input, mask_ch], dim=-1)
    shape = (batch, length, n_tracks * track_dim)
    sample = diffusion.sample if hasattr(diffusion, "sample") else diffusion.p_sample_loop
    return sample(model_fn, shape, conditioning, generator, device=device, causal=causal,
                  **sample_kw)
