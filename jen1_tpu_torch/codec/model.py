"""EnCodec-48k decode (port of the decode half of jen1_tpu/codec/model.py).

`decode_latent` runs the SEANet decoder on the whole latent;
`decode_latent_chunked` decodes 150-frame chunks with a 148-frame hop as one
batched decoder call and joins them with EnCodec's triangular overlap-add.
Layout: latent (B, F, D) -> audio (B, F * hop_length, channels). The
encoder, the RVQ and checkpoint import are not ported yet; the decoder is
random-initialised from a seeded generator or loaded through
`ckpt/from_jax.py`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from jen1_tpu_torch.codec.seanet import SEANetDecoder
from jen1_tpu_torch.ops.initializers import init_module


@dataclasses.dataclass
class EncodecConfig:
    sample_rate: int = 48_000
    channels: int = 2
    dimension: int = 128
    n_filters: int = 32
    ratios: Tuple[int, ...] = (8, 5, 4, 2)
    causal: bool = False
    norm: str = "time_group_norm"

    @property
    def hop_length(self) -> int:
        return math.prod(self.ratios)


def encodec_48khz_config() -> EncodecConfig:
    return EncodecConfig()


def _triangle(n: int, device) -> torch.Tensor:
    """EnCodec's _linear_overlap_add weights over n samples."""
    t = torch.linspace(0.0, 1.0, n + 2, dtype=torch.float32, device=device)[1:-1]
    return 0.5 - (t - 0.5).abs()


class EncodecModel(nn.Module):
    """The decoder side of EnCodec, on `device`."""

    def __init__(self, config: EncodecConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        with torch.device(device):
            self.decoder = SEANetDecoder(
                channels=config.channels, dimension=config.dimension,
                n_filters=config.n_filters, ratios=config.ratios,
                causal=config.causal, norm=config.norm,
            )
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(1)
        init_module(self, generator)

    @torch.no_grad()
    def decode_latent(self, latent: torch.Tensor) -> torch.Tensor:
        """latent (B, F, D) -> audio (B, F * hop, ch), one decoder pass."""
        return self.decoder(latent)

    @torch.no_grad()
    def decode_latent_chunked(
        self, latent: torch.Tensor, chunk_frames: int = 150, hop_frames: int = 148
    ) -> torch.Tensor:
        """latent (B, F, D) -> audio (B, F * hop, ch) by overlapping latent
        chunks, decoded as one batch, and triangular overlap-add (EnCodec's
        1 s segments with 1 % overlap)."""
        b, f, d = latent.shape
        hop = self.config.hop_length
        if f <= chunk_frames:
            return self.decode_latent(latent)[:, : f * hop]
        n = math.ceil((f - chunk_frames) / hop_frames) + 1
        pad = (n - 1) * hop_frames + chunk_frames - f
        latent = torch.nn.functional.pad(latent, (0, 0, 0, pad))
        chunks = latent.unfold(1, chunk_frames, hop_frames)  # (B, n, D, Fc)
        chunks = chunks.permute(0, 1, 3, 2).reshape(b * n, chunk_frames, d)
        audio = self.decoder(chunks)  # (B*n, Fc*hop, ch)
        seg_len = chunk_frames * hop
        audio = audio[:, :seg_len].reshape(b, n, seg_len, -1).float()
        w = _triangle(seg_len, latent.device)[:, None]
        stride = hop_frames * hop
        total = stride * (n - 1) + seg_len
        out = torch.zeros((b, total, audio.shape[-1]), dtype=torch.float32,
                          device=latent.device)
        norm = torch.zeros((total, 1), dtype=torch.float32, device=latent.device)
        for i in range(n):
            out[:, i * stride : i * stride + seg_len] += audio[:, i] * w
            norm[i * stride : i * stride + seg_len] += w
        return (out / norm.clamp_min(1e-12))[:, : f * hop]
