"""Omnidirectional 1-D convolutions, channels-last (B, L, C) (port of
jen1_tpu/ops/conv.py).

Weights are stored in torch layout, fp32, and cast to the activation dtype
at use: Conv1d (out, in, K), ConvTranspose1d (in, out, K). The functions
transpose to (B, C, L) for `F.conv1d` and back. A stride-1 `OmniConv1d`
given an int8 kernel (`ops/int8_matmul.py::attach_qweights`) runs
`conv1d_int8w` instead.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from jen1_tpu_torch.ops.initializers import torch_uniform_
from jen1_tpu_torch.ops.int8_matmul import conv1d_int8w


def _cast(w: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if w is None else w.to(dtype)


def conv1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    dilation: int = 1,
    causal: bool = False,
) -> torch.Tensor:
    """x (B, L, Cin), weight (Cout, Cin, K) -> (B, L', Cout).

    Padding is (K-1)*dilation in total: all on the left when causal, else
    `pad // 2` on each side (jen1_tpu/ops/conv.py:54-56)."""
    k = weight.shape[-1]
    pad = (k - 1) * dilation
    pads = (pad, 0) if causal else (pad // 2, pad // 2)
    xt = F.pad(x.transpose(1, 2), pads)
    y = F.conv1d(
        xt, weight.to(x.dtype), _cast(bias, x.dtype), stride=stride, dilation=dilation
    )
    return y.transpose(1, 2)


def conv_transpose1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: int,
    padding: int,
    output_padding: int = 0,
) -> torch.Tensor:
    """torch-semantics ConvTranspose1d in channels-last: x (B, L, Cin),
    weight (Cin, Cout, K); out_len = (L-1)*stride - 2*padding + K +
    output_padding."""
    y = F.conv_transpose1d(
        x.transpose(1, 2),
        weight.to(x.dtype),
        _cast(bias, x.dtype),
        stride=stride,
        padding=padding,
        output_padding=output_padding,
    )
    return y.transpose(1, 2)


class OmniConv1d(nn.Module):
    """Conv1d with the omnidirectional causal/bidirectional padding rule.

    `kernel8` ((K*in, out) int8) and `scale` ((out,) fp32) are None until
    `attach_qweights` sets them; a stride-1 conv then reads them instead of
    `weight` (jen1_tpu/ops/conv.py:180-187). They are not part of the state
    dict: the fp32 weight stays, as JAX keeps `params` beside `qweights`."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 1,
        stride: int = 1,
        dilation: int = 1,
        use_bias: bool = True,
    ):
        super().__init__()
        self.fan_in = in_channels * kernel_size
        self.stride = stride
        self.dilation = dilation
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None
        self.register_buffer("kernel8", None, persistent=False)
        self.register_buffer("scale", None, persistent=False)

    def init_parameters(self, generator):
        torch_uniform_(self.weight, self.fan_in, generator)
        if self.bias is not None:
            torch_uniform_(self.bias, self.fan_in, generator)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        if self.stride == 1 and self.kernel8 is not None:
            return conv1d_int8w(x, self.kernel8, self.scale, self.bias,
                                dilation=self.dilation, causal=causal)
        return conv1d(
            x, self.weight, self.bias,
            stride=self.stride, dilation=self.dilation, causal=causal,
        )


class Downsample1d(nn.Module):
    """Strided omnidirectional conv; kernel = factor * kernel_multiplier + 1."""

    def __init__(
        self, in_channels: int, out_channels: int, factor: int, kernel_multiplier: int = 2
    ):
        super().__init__()
        assert kernel_multiplier % 2 == 0, "kernel multiplier must be even"
        self.conv = OmniConv1d(
            in_channels, out_channels,
            kernel_size=factor * kernel_multiplier + 1, stride=factor,
        )

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        return self.conv(x, causal=causal)


class Upsample1d(nn.Module):
    """Upsampling block (jen1_tpu/ops/conv.py:201-267).

    factor == 1   -> plain conv k=3 (symmetric padding, never causal)
    use_nearest   -> nearest-neighbour repeat + conv k=3
    otherwise     -> transposed conv k=2*factor, stride=factor
    """

    def __init__(
        self, in_channels: int, out_channels: int, factor: int, use_nearest: bool = False
    ):
        super().__init__()
        self.factor = factor
        self.transposed = not (factor == 1 or use_nearest)
        if self.transposed:
            k = 2 * factor
            shape = (in_channels, out_channels, k)
        else:
            k = 3
            shape = (out_channels, in_channels, k)
        self.fan_in = in_channels * k
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def init_parameters(self, generator):
        torch_uniform_(self.weight, self.fan_in, generator)
        torch_uniform_(self.bias, self.fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = self.factor
        if not self.transposed:
            if f > 1:
                x = torch.repeat_interleave(x, f, dim=1)
            return conv1d(x, self.weight, self.bias, stride=1, causal=False)
        return conv_transpose1d(
            x, self.weight, self.bias,
            stride=f, padding=f // 2 + f % 2, output_padding=f % 2,
        )
