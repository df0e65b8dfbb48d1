"""Omnidirectional 1-D convolutions, channels-last (B, L, C) (port of
jen1_tpu/ops/conv.py).

Weights are stored in torch layout, fp32: Conv1d (out, in, K),
ConvTranspose1d (in, out, K). The functions hand the convolution a
channels-last view of (B, L, C), (B, C, 1, L) with NHWC strides, and the
weight at the activation dtype laid out channels-last, (O, I, 1, K), so
cuDNN reads and writes (B, L, C) with no transposing copy before or after
(a 3-D `F.conv1d` makes its input (B, C, L)-contiguous first); symmetric
padding is the convolution's own, a causal conv pads in (B, L, C). A
contiguous input gives a contiguous (B, L', C) output. Given a (O, I, K)
weight, a function casts and lays it out in one copy at each call (the
codecs' convs); the modules here hand it that form already, their staged
copy where it serves (ops/staging.py).

A stride-1 `OmniConv1d` given an int8 kernel
(`ops/int8_matmul.py::attach_qweights`) runs `conv1d_int8w` instead.
`fp32_precision` is the port's counterpart of the JAX package's
`Precision.HIGHEST` for fp32 products.

Under sequence parallelism (parallel/sp.py) the input is this rank's frames
of the length: each conv first takes the frames its padding implies from
its neighbours (`halo`; zeros at the global ends) and then runs unpadded,
or (the int8 and transposed convs) runs padded over the extended input and
keeps its own outputs.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from jen1_tpu_torch.ops.initializers import torch_uniform_
from jen1_tpu_torch.ops.int8_matmul import conv1d_int8w
from jen1_tpu_torch.ops.staging import compute_form, compute_weights
from jen1_tpu_torch.parallel import sp as seq

# a conv module's reads (ops/staging.py): the weight channels-last, the bias
CONV_READS = (("weight", True), ("bias", False))


@contextlib.contextmanager
def fp32_precision():
    """fp32 convs, LSTMs and matmuls in full fp32, never TF32, as the JAX
    package asks of XLA with Precision.HIGHEST (jen1_tpu/ops/conv.py:27-31),
    whatever the caller set; bf16 products are unaffected. cuDNN's
    `allow_tf32` defaults to True, so every fp32 path runs under this."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(
            enabled=torch.backends.cudnn.enabled,
            benchmark=torch.backends.cudnn.benchmark,
            deterministic=torch.backends.cudnn.deterministic,
            allow_tf32=False,
        ):
            yield
    finally:
        matmul.allow_tf32 = prev


def _cast(w: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if w is None else w.to(dtype)


def _weight_cl(w: torch.Tensor, dtype) -> torch.Tensor:
    """A (O, I, K) weight as (O, I, 1, K) of `dtype`, channels-last (cuDNN's
    KRSC order), in one copy; a 4-D weight is in that form already."""
    return w if w.dim() == 4 else compute_form(w.unsqueeze(2), dtype, True)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, L, C) as the (B, C, 1, L) view with channels-last strides."""
    return x.transpose(1, 2).unsqueeze(2)


def _blc(y: torch.Tensor) -> torch.Tensor:
    """A (B, C, 1, L) convolution output back to (B, L, C) (a view)."""
    return y.squeeze(2).transpose(1, 2)


def conv1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    dilation: int = 1,
    causal: bool = False,
) -> torch.Tensor:
    """x (B, L, Cin), weight (Cout, Cin, K) or its form (Cout, Cin, 1, K)
    -> (B, L', Cout).

    Padding is (K-1)*dilation in total: all on the left when causal, else
    `pad // 2` on each side (jen1_tpu/ops/conv.py:54-56)."""
    k = weight.shape[-1]
    pad = (k - 1) * dilation
    pads = (pad, 0) if causal else (pad // 2, pad // 2)
    if seq.active() is not None:
        # the frames this rank's outputs read: pads[0] before, and after
        # its last output's window end minus its own length
        x = seq.halo(x, pads[0], pad + 1 - stride - pads[0])
        pads = (0, 0)
    elif causal and pad:
        x = F.pad(x, (0, 0, pad, 0))
        pads = (0, 0)
    y = F.conv2d(
        _nhwc(x), _weight_cl(weight, x.dtype), _cast(bias, x.dtype),
        stride=(1, stride), padding=(0, pads[0]), dilation=(1, dilation),
    )
    return _blc(y)


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
    weight (Cin, Cout, K) or its form (Cin, Cout, 1, K); out_len =
    (L-1)*stride - 2*padding + K + output_padding. Under sp (K <= 2 *
    stride) one frame from each neighbour, and this rank's L * stride
    outputs."""
    length = x.shape[1]
    sharded = seq.active() is not None
    if sharded:
        x = seq.halo(x, 1, 1)
    y = _blc(F.conv_transpose2d(
        _nhwc(x),
        _weight_cl(weight, x.dtype),
        _cast(bias, x.dtype),
        stride=(1, stride),
        padding=(0, padding),
        output_padding=(0, output_padding),
    ))
    if sharded:
        y = y[:, stride:stride + length * stride]
    return y


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

    @property
    def staged_reads(self):
        return () if self.stride == 1 and self.kernel8 is not None else CONV_READS

    def init_parameters(self, generator):
        torch_uniform_(self.weight, self.fan_in, generator)
        if self.bias is not None:
            torch_uniform_(self.bias, self.fan_in, generator)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        if self.stride == 1 and self.kernel8 is not None:
            length = x.shape[1]
            pad = (self.kernel8.shape[0] // x.shape[-1] - 1) * self.dilation
            left = pad if causal else pad // 2
            x = seq.halo(x, left, pad - left)  # x itself unless under sp
            y = conv1d_int8w(x, self.kernel8, self.scale, self.bias,
                             dilation=self.dilation, causal=causal)
            return y[:, left:left + length] if seq.active() is not None else y
        return conv1d(
            x, *compute_weights(self, x.dtype),
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

    staged_reads = CONV_READS

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
        weight, bias = compute_weights(self, x.dtype)
        if not self.transposed:
            if f > 1:
                x = torch.repeat_interleave(x, f, dim=1)
            return conv1d(x, weight, bias, stride=1, causal=False)
        return conv_transpose1d(
            x, weight, bias,
            stride=f, padding=f // 2 + f % 2, output_padding=f % 2,
        )
