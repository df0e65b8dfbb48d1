"""SEANet encoder and decoder, EnCodec's conv backbone (port of
jen1_tpu/codec/seanet.py).

The submodules work on (B, C, L) tensors; `SEANetEncoder` and
`SEANetDecoder` take and return channels-last (B, L, C) like the JAX
package. Padding follows EnCodec: total pad (K-1)*dilation - (stride-1),
split with the extra right padding that keeps the last partial frame,
reflect mode with a zero extension of inputs shorter than the pad.
Transposed convs apply GroupNorm(1) before the K - stride trim. GroupNorm
statistics and the LSTM run in fp32 whatever the activation dtype, as in
the JAX package.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from jen1_tpu_torch.ops.initializers import torch_uniform_


def _extra_padding(length: int, k: int, stride: int, padding_total: int) -> int:
    n_frames = (length - k + padding_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (k - padding_total)
    return max(ideal - length, 0)


def _pad1d(x: torch.Tensor, left: int, right: int, mode: str = "reflect"):
    """Pad the last axis of (B, C, L); reflect zero-extends tiny inputs
    first and trims the extension back off (encodec pad1d)."""
    if left == 0 and right == 0:
        return x
    if mode != "reflect":
        return F.pad(x, (left, right))
    length = x.shape[-1]
    extra = 0
    if length <= max(left, right):
        extra = max(left, right) - length + 1
        x = F.pad(x, (0, extra))
    y = F.pad(x, (left, right), mode="reflect")
    return y[..., : y.shape[-1] - extra] if extra else y


class _TimeGroupNorm(nn.Module):
    """GroupNorm with one group over a (B, C, L) tensor, fp32 statistics."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def init_parameters(self, generator):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.group_norm(x.float(), 1, self.weight.float(), self.bias.float(),
                            1e-5).to(x.dtype)


def _norm(norm: str, channels: int):
    return _TimeGroupNorm(channels) if norm == "time_group_norm" else None


class SConv1d(nn.Module):
    """EnCodec SConv1d: explicit padding + VALID conv + optional group norm."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, causal: bool = False,
                 norm: str = "time_group_norm", pad_mode: str = "reflect"):
        super().__init__()
        self.fan_in = in_channels * kernel_size
        self.stride, self.dilation = stride, dilation
        self.causal, self.pad_mode = causal, pad_mode
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.norm = _norm(norm, out_channels)

    def init_parameters(self, generator):
        torch_uniform_(self.weight, self.fan_in, generator)
        torch_uniform_(self.bias, self.fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s, d = self.weight.shape[-1], self.stride, self.dilation
        keff = (k - 1) * d + 1
        padding_total = keff - s
        extra = _extra_padding(x.shape[-1], keff, s, padding_total)
        if self.causal:
            x = _pad1d(x, padding_total, extra, self.pad_mode)
        else:
            right = padding_total // 2
            x = _pad1d(x, padding_total - right, right + extra, self.pad_mode)
        y = F.conv1d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                     stride=s, dilation=d)
        return y if self.norm is None else self.norm(y)


class SConvTranspose1d(nn.Module):
    """EnCodec SConvTranspose1d: transposed conv, norm, then trim K - stride."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, causal: bool = False, norm: str = "time_group_norm",
                 trim_right_ratio: float = 1.0):
        super().__init__()
        self.in_channels = in_channels
        self.stride, self.causal = stride, causal
        self.trim_right_ratio = trim_right_ratio
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.norm = _norm(norm, out_channels)

    def init_parameters(self, generator):
        k = self.weight.shape[-1]
        torch_uniform_(self.weight, self.in_channels * k, generator)
        torch_uniform_(self.bias, self.in_channels, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.weight.shape[-1], self.stride
        y = F.conv_transpose1d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), stride=s)
        if self.norm is not None:
            y = self.norm(y)  # statistics include the samples trimmed below
        padding_total = k - s
        if self.causal:
            right = math.ceil(padding_total * self.trim_right_ratio)
        else:
            right = padding_total // 2
        left = padding_total - right
        return y[..., left : y.shape[-1] - right]


class SLSTM(nn.Module):
    """Multi-layer LSTM over time with a skip connection (EnCodec SLSTM), on
    `torch.nn.LSTM` (gate order i, f, g, o; b_ih + b_hh). It runs at its
    weights' dtype and returns the input's: a bf16 codec keeps this module
    in fp32 (bf16-rounded values), as JAX promotes bf16 weights to its fp32
    LSTM math."""

    def __init__(self, channels: int, num_layers: int = 2, skip: bool = True):
        super().__init__()
        self.skip = skip
        self.lstm = nn.LSTM(channels, channels, num_layers)

    def init_parameters(self, generator):
        for p in self.lstm.parameters():
            torch_uniform_(p, self.lstm.hidden_size, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq = x.permute(2, 0, 1)  # (L, B, C)
        y, _ = self.lstm(seq.to(self.lstm.weight_ih_l0.dtype))
        y = y.to(seq.dtype)
        if self.skip:
            y = y + seq
        return y.permute(1, 2, 0)


class SEANetResnetBlock(nn.Module):
    """ELU-conv(k3, dilation)-ELU-conv(k1) with a 1x1 conv shortcut."""

    def __init__(self, dim: int, dilation: int = 1, compress: int = 2,
                 causal: bool = False, norm: str = "time_group_norm",
                 pad_mode: str = "reflect"):
        super().__init__()
        hidden = dim // compress
        kw = dict(causal=causal, norm=norm, pad_mode=pad_mode)
        self.conv1 = SConv1d(dim, hidden, 3, dilation=dilation, **kw)
        self.conv2 = SConv1d(hidden, dim, 1, **kw)
        self.shortcut = SConv1d(dim, dim, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(F.elu(self.conv1(F.elu(x))))
        return self.shortcut(x) + h


class SEANetEncoder(nn.Module):
    """audio (B, T, channels) -> latent (B, ceil(T / prod(ratios)), dimension)
    (jen1_tpu/codec/seanet.py:293-339); the stages downsample by the ratios
    in reverse order."""

    def __init__(self, channels: int = 2, dimension: int = 128, n_filters: int = 32,
                 n_residual_layers: int = 1, ratios: Sequence[int] = (8, 5, 4, 2),
                 dilation_base: int = 2, causal: bool = False,
                 norm: str = "time_group_norm", pad_mode: str = "reflect", lstm: int = 2):
        super().__init__()
        self.ratios = tuple(ratios)
        self.n_residual_layers = n_residual_layers
        kw = dict(causal=causal, norm=norm, pad_mode=pad_mode)
        mult = 1
        self.conv_in = SConv1d(channels, n_filters, 7, **kw)
        for si, ratio in enumerate(reversed(self.ratios)):
            for j in range(n_residual_layers):
                self.add_module(f"stage{si}_res{j}", SEANetResnetBlock(
                    mult * n_filters, dilation=dilation_base**j, **kw))
            self.add_module(f"stage{si}_down", SConv1d(
                mult * n_filters, mult * n_filters * 2, ratio * 2, stride=ratio, **kw))
            mult *= 2
        self.lstm = SLSTM(mult * n_filters, num_layers=lstm) if lstm else None
        self.conv_out = SConv1d(mult * n_filters, dimension, 7, **kw)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(audio.transpose(1, 2))
        for si in range(len(self.ratios)):
            for j in range(self.n_residual_layers):
                x = getattr(self, f"stage{si}_res{j}")(x)
            x = getattr(self, f"stage{si}_down")(F.elu(x))
        if self.lstm is not None:
            x = self.lstm(x)
        return self.conv_out(F.elu(x)).transpose(1, 2)


class SEANetDecoder(nn.Module):
    """latent (B, F, dimension) -> audio (B, F * prod(ratios), channels)."""

    def __init__(self, channels: int = 2, dimension: int = 128, n_filters: int = 32,
                 n_residual_layers: int = 1, ratios: Sequence[int] = (8, 5, 4, 2),
                 dilation_base: int = 2, causal: bool = False,
                 norm: str = "time_group_norm", pad_mode: str = "reflect",
                 lstm: int = 2, trim_right_ratio: float = 1.0):
        super().__init__()
        self.ratios = tuple(ratios)
        self.n_residual_layers = n_residual_layers
        kw = dict(causal=causal, norm=norm)
        mult = 2 ** len(self.ratios)
        self.conv_in = SConv1d(dimension, mult * n_filters, 7, pad_mode=pad_mode, **kw)
        self.lstm = SLSTM(mult * n_filters, num_layers=lstm) if lstm else None
        for si, ratio in enumerate(self.ratios):
            dim = mult * n_filters // 2
            self.add_module(f"stage{si}_up", SConvTranspose1d(
                mult * n_filters, dim, ratio * 2, stride=ratio,
                trim_right_ratio=trim_right_ratio, **kw,
            ))
            for j in range(n_residual_layers):
                self.add_module(f"stage{si}_res{j}", SEANetResnetBlock(
                    dim, dilation=dilation_base**j, pad_mode=pad_mode, **kw
                ))
            mult //= 2
        self.conv_out = SConv1d(n_filters, channels, 7, pad_mode=pad_mode, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(z.transpose(1, 2))
        if self.lstm is not None:
            x = self.lstm(x)
        for si in range(len(self.ratios)):
            x = getattr(self, f"stage{si}_up")(F.elu(x))
            for j in range(self.n_residual_layers):
                x = getattr(self, f"stage{si}_res{j}")(x)
        return self.conv_out(F.elu(x)).transpose(1, 2)
