"""Stable Audio Open's Oobleck VAE decoder (stable-audio-tools
`models/autoencoders.py::OobleckDecoder`), channels-last: latent (B, F,
dimension) -> audio (B, F * hop, channels).

  * WNConv(dimension -> c_mults[-1] * base_channels, k 7);
  * a decoder block per stride, from the widest: SnakeBeta, the weight-normed
    transposed conv (k 2s, stride s, padding ceil(s / 2)), then three
    residual units at dilations 1, 3 and 9, each x + WNConv_1(SnakeBeta(
    WNConv_7,dil(SnakeBeta(x))));
  * SnakeBeta and WNConv(base_channels -> channels, k 7, no bias), with no
    final tanh (Stable Audio Open's `final_tanh` is false).

Weight norm is folded: each conv holds its plain weight (random weights
are plain weights; a trained g / |v| v folds into one). The convs run
through ops/conv.py (cuDNN on (B, C, 1, L) channels-last views) with the
weights cast to the activation's dtype at use.

`OobleckCodec` is what `Jen1` decodes with when `codec_type` is "oobleck":
one clip at a time (the published `iterate_batch`), each clip a span
`codec.decode` keyed by its row, in fp32 products (`fp32_precision`) or,
given `dtype`, in that dtype. The VAE encoder is not ported: a Jen1 with
this codec runs text_guided generation only.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from jen1_tpu_torch.ops.conv import conv1d, conv_transpose1d, fp32_precision
from jen1_tpu_torch.ops.initializers import init_module, torch_uniform_
from jen1_tpu_torch.ops.snake import SnakeBeta
from jen1_tpu_torch.utils.profiling import annotate


class WNConv(nn.Module):
    """A 'same'-padded conv, weight (out, in, k), folded weight norm."""

    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1, bias: bool = True):
        super().__init__()
        self.dilation, self.fan_in = dilation, cin * k
        self.weight = nn.Parameter(torch.empty(cout, cin, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def init_parameters(self, generator):
        torch_uniform_(self.weight, self.fan_in, generator)
        if self.bias is not None:
            torch_uniform_(self.bias, self.fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d(x, self.weight, self.bias, dilation=self.dilation)


class WNConvTranspose(nn.Module):
    """Transposed conv k 2s, stride s, padding ceil(s / 2); weight (in,
    out, k), folded weight norm."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.stride, self.fan_in = stride, cin * 2 * stride
        self.weight = nn.Parameter(torch.empty(cin, cout, 2 * stride))
        self.bias = nn.Parameter(torch.empty(cout))

    def init_parameters(self, generator):
        torch_uniform_(self.weight, self.fan_in, generator)
        torch_uniform_(self.bias, self.fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose1d(x, self.weight, self.bias, stride=self.stride,
                                padding=math.ceil(self.stride / 2))


class ResidualUnit(nn.Module):
    def __init__(self, channels: int, dilation: int):
        super().__init__()
        self.act1 = SnakeBeta(channels)
        self.conv1 = WNConv(channels, channels, 7, dilation)
        self.act2 = SnakeBeta(channels)
        self.conv2 = WNConv(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(self.act2(self.conv1(self.act1(x))))


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.act = SnakeBeta(cin)
        self.up = WNConvTranspose(cin, cout, stride)
        self.res = nn.ModuleList(ResidualUnit(cout, d) for d in (1, 3, 9))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.up(self.act(x))
        for unit in self.res:
            x = unit(x)
        return x


class OobleckDecoder(nn.Module):
    """The decoder of a `config.OobleckConfig` (module docstring)."""

    def __init__(self, oc):
        super().__init__()
        ch = oc.base_channels
        mults = (1,) + tuple(oc.c_mults)
        self.conv_in = WNConv(oc.dimension, mults[-1] * ch, 7)
        self.blocks = nn.ModuleList(
            DecoderBlock(mults[i] * ch, mults[i - 1] * ch, oc.strides[i - 1])
            for i in range(len(mults) - 1, 0, -1))
        self.act_out = SnakeBeta(ch)
        self.conv_out = WNConv(ch, oc.channels, 7, bias=False)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(z)
        for block in self.blocks:
            x = block(x)
        return self.conv_out(self.act_out(x))


class OobleckCodec(nn.Module):
    """The decoder as `Jen1`'s codec (module docstring): `config` (an
    OobleckConfig: channels, dimension, hop_length, sample_rate) and
    `decoder`, random from `generator` until weights are loaded."""

    def __init__(self, config, *, device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        with torch.device(device):
            self.decoder = OobleckDecoder(config)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(2)
        init_module(self, generator)

    def latent_frames(self, samples: int) -> int:
        """Latent frames of a clip of `samples` samples: whole hops only."""
        return samples // self.config.hop_length

    @torch.no_grad()
    def decode_latent(self, latent: torch.Tensor,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """(B, F, dimension) -> (B, F * hop, channels) fp32, a clip at a
        time, in fp32 or `dtype`."""
        outs = []
        with fp32_precision():
            for i in range(latent.shape[0]):
                with annotate("codec.decode", key=i):
                    z = latent[i:i + 1].to(dtype or torch.float32)
                    outs.append(self.decoder(z).float())
        return torch.cat(outs, dim=0)

    decode_latent_chunked = decode_latent
