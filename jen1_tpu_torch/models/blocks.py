"""UNet building blocks, channels-last (B, L, C) (port of
jen1_tpu/models/blocks.py).

Submodules carry the flax names of the JAX package (`block0`,
`transformer`, `to_scale_shift`, ...) so that `ckpt/from_jax.py` maps
parameters by path. Only the block configurations the UNet builds are
ported: pre-downsample blocks with skips and post-upsample blocks that
consume them. `use_snake` swaps every conv block's SiLU for Snake
(`ops/snake.py`, submodule `snake`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from jen1_tpu_torch.ops.attention import Attention
from jen1_tpu_torch.ops.conv import Downsample1d, OmniConv1d, Upsample1d
from jen1_tpu_torch.ops.linear import Linear
from jen1_tpu_torch.ops.norm import GroupNorm
from jen1_tpu_torch.ops.snake import Snake1d


class ConvBlock1d(nn.Module):
    """GroupNorm -> (FiLM) -> SiLU or Snake -> OmniConv1d."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        dilation: int = 1,
        num_groups: int = 8,
        use_norm: bool = True,
        use_snake: bool = False,
    ):
        super().__init__()
        self.groupnorm = GroupNorm(num_groups, in_channels) if use_norm else None
        self.snake = Snake1d(in_channels) if use_snake else None
        self.project = OmniConv1d(
            in_channels, out_channels, kernel_size, stride=stride, dilation=dilation
        )

    def forward(
        self,
        x: torch.Tensor,
        scale_shift: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        causal: bool = False,
    ) -> torch.Tensor:
        if self.groupnorm is not None:
            x = self.groupnorm(x)
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0) + shift
        x = F.silu(x) if self.snake is None else self.snake(x)
        return self.project(x, causal=causal)


class MappingToScaleShift(nn.Module):
    """FiLM head: SiLU -> Linear -> (scale, shift), each (B, 1, C)."""

    def __init__(self, features: int, channels: int):
        super().__init__()
        self.to_scale_shift = Linear(features, channels * 2)

    def forward(self, mapping: torch.Tensor):
        scale, shift = self.to_scale_shift(F.silu(mapping)).chunk(2, dim=-1)
        return scale[:, None, :], shift[:, None, :]


class ResnetBlock1d(nn.Module):
    """Two conv blocks with FiLM between them and a 1x1 residual projection."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        num_groups: int = 8,
        mapping_features: Optional[int] = None,
        use_snake: bool = False,
    ):
        super().__init__()
        self.block1 = ConvBlock1d(
            in_channels, out_channels, num_groups=num_groups, use_snake=use_snake
        )
        self.to_scale_shift = (
            MappingToScaleShift(mapping_features, out_channels)
            if mapping_features is not None
            else None
        )
        self.block2 = ConvBlock1d(
            out_channels, out_channels, num_groups=num_groups, use_snake=use_snake
        )
        self.to_out = (
            OmniConv1d(in_channels, out_channels, 1)
            if in_channels != out_channels
            else None
        )

    def forward(
        self, x: torch.Tensor, mapping: Optional[torch.Tensor] = None, causal: bool = False
    ) -> torch.Tensor:
        assert (self.to_scale_shift is None) == (mapping is None), (
            "context mapping required iff use_mapping"
        )
        h = self.block1(x, causal=causal)
        scale_shift = None if mapping is None else self.to_scale_shift(mapping)
        h = self.block2(h, scale_shift=scale_shift, causal=causal)
        res = x if self.to_out is None else self.to_out(x, causal=causal)
        return h + res


class Patcher(nn.Module):
    """Resnet + pixel-unshuffle-1d: (B, L*p, C) -> (B, L, C*p)."""

    def __init__(self, in_channels: int, out_channels: int, patch_size: int,
                 mapping_features: Optional[int] = None, use_snake: bool = False):
        super().__init__()
        assert out_channels % patch_size == 0
        self.patch_size = patch_size
        self.block = ResnetBlock1d(
            in_channels, out_channels // patch_size, num_groups=1,
            mapping_features=mapping_features, use_snake=use_snake,
        )

    def forward(self, x: torch.Tensor, mapping: Optional[torch.Tensor] = None):
        x = self.block(x, mapping=mapping)
        p = self.patch_size
        if p > 1:
            b, lp, c = x.shape
            x = x.reshape(b, lp // p, p, c).transpose(2, 3).reshape(b, lp // p, c * p)
        return x


class Unpatcher(nn.Module):
    """Pixel-shuffle-1d + resnet: (B, L, C*p) -> (B, L*p, C_out)."""

    def __init__(self, in_channels: int, out_channels: int, patch_size: int,
                 mapping_features: Optional[int] = None, use_snake: bool = False):
        super().__init__()
        assert in_channels % patch_size == 0
        self.patch_size = patch_size
        self.block = ResnetBlock1d(
            in_channels // patch_size, out_channels, num_groups=1,
            mapping_features=mapping_features, use_snake=use_snake,
        )

    def forward(self, x: torch.Tensor, mapping: Optional[torch.Tensor] = None):
        p = self.patch_size
        if p > 1:
            b, length, cp = x.shape
            x = x.reshape(b, length, cp // p, p).transpose(2, 3).reshape(b, length * p, cp // p)
        return self.block(x, mapping=mapping)


class FeedForward(nn.Module):
    """Linear -> exact GELU -> Linear."""

    def __init__(self, features: int, multiplier: int):
        super().__init__()
        self.linear1 = Linear(features, features * multiplier)
        self.linear2 = Linear(features * multiplier, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(F.gelu(self.linear1(x)))


class TransformerBlock(nn.Module):
    """Self-attention (+ cross-attention) + FFN, residual. Only
    self-attention sees the causal flag."""

    def __init__(
        self,
        features: int,
        num_heads: int,
        head_features: int,
        multiplier: int,
        context_features: Optional[int] = None,
        use_flash: bool = False,
        flash_min_seq_len: int = 512,
    ):
        super().__init__()
        self.attention = Attention(
            features, head_features, num_heads,
            use_flash=use_flash, flash_min_seq_len=flash_min_seq_len,
        )
        self.cross_attention = (
            Attention(features, head_features, num_heads, context_features=context_features)
            if context_features
            else None
        )
        self.feed_forward = FeedForward(features, multiplier)

    def forward(self, x, context=None, context_mask=None, causal: bool = False):
        x = self.attention(x, causal=causal) + x
        if self.cross_attention is not None:
            x = self.cross_attention(x, context=context, context_mask=context_mask) + x
        return self.feed_forward(x) + x


class Transformer1d(nn.Module):
    """GroupNorm(min(32, C), eps 1e-6) -> 1x1 conv -> transformer blocks ->
    1x1 conv (tied to the first one when `tie_projections`)."""

    def __init__(
        self,
        num_layers: int,
        channels: int,
        num_heads: int,
        head_features: int,
        multiplier: int,
        context_features: Optional[int] = None,
        tie_projections: bool = False,
        use_flash: bool = False,
        flash_min_seq_len: int = 512,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.group_norm = GroupNorm(min(32, channels), channels, eps=1e-6)
        self.conv_in = OmniConv1d(channels, channels, 1)
        for i in range(num_layers):
            self.add_module(f"block{i}", TransformerBlock(
                channels, num_heads, head_features, multiplier,
                context_features=context_features,
                use_flash=use_flash, flash_min_seq_len=flash_min_seq_len,
            ))
        self.conv_out = None if tie_projections else OmniConv1d(channels, channels, 1)

    def forward(self, x, context=None, context_mask=None, causal: bool = False):
        x = self.conv_in(self.group_norm(x), causal=causal)
        for i in range(self.num_layers):
            x = getattr(self, f"block{i}")(
                x, context=context, context_mask=context_mask, causal=causal
            )
        conv_out = self.conv_in if self.conv_out is None else self.conv_out
        return conv_out(x, causal=causal)


def _crop_to_common_length(x: torch.Tensor, skip: torch.Tensor):
    """Centre-crop the longer of (x, skip) along axis 1."""
    lx, ls = x.shape[1], skip.shape[1]
    if lx > ls:
        start = (lx - ls) // 2
        x = x[:, start : start + ls]
    elif ls > lx:
        start = (ls - lx) // 2
        skip = skip[:, start : start + lx]
    return x, skip


def _transformer(attn: "_AttnArgs", channels: int) -> Transformer1d:
    return Transformer1d(
        num_layers=attn.num_blocks,
        channels=channels,
        num_heads=attn.heads,
        head_features=attn.features or channels // attn.heads,
        multiplier=attn.multiplier,
        context_features=attn.context_features,
        tie_projections=attn.tie_projections,
        use_flash=attn.use_flash,
        flash_min_seq_len=attn.flash_min_seq_len,
    )


class _AttnArgs:
    """The transformer settings a down/up/bottleneck block passes on."""

    def __init__(self, num_blocks, heads, features, multiplier, context_features,
                 tie_projections, use_flash, flash_min_seq_len):
        self.num_blocks = num_blocks
        self.heads = heads
        self.features = features
        self.multiplier = multiplier
        self.context_features = context_features
        self.tie_projections = tie_projections
        self.use_flash = use_flash
        self.flash_min_seq_len = flash_min_seq_len


class DownsampleBlock1d(nn.Module):
    """Downsample conv -> [context-channel concat] -> resnets -> [Transformer1d],
    returning the output and the skips (one per resnet and transformer)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        factor: int,
        num_groups: int,
        num_layers: int,
        attn: _AttnArgs,
        kernel_multiplier: int = 2,
        context_channels: int = 0,
        mapping_features: Optional[int] = None,
        use_snake: bool = False,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.context_channels = context_channels
        self.downsample = Downsample1d(in_channels, out_channels, factor, kernel_multiplier)
        for i in range(num_layers):
            self.add_module(f"block{i}", ResnetBlock1d(
                out_channels + (context_channels if i == 0 else 0), out_channels,
                num_groups=num_groups, mapping_features=mapping_features,
                use_snake=use_snake,
            ))
        self.transformer = _transformer(attn, out_channels) if attn.num_blocks > 0 else None

    def forward(self, x, mapping=None, channels=None, embedding=None,
                embedding_mask=None, causal: bool = False):
        x = self.downsample(x, causal=causal)
        if self.context_channels > 0 and channels is not None:
            x = torch.cat([x, channels.to(x.dtype)], dim=-1)
        skips: List[torch.Tensor] = []
        for i in range(self.num_layers):
            x = getattr(self, f"block{i}")(x, mapping=mapping, causal=causal)
            skips.append(x)
        if self.transformer is not None:
            x = self.transformer(x, context=embedding, context_mask=embedding_mask,
                                 causal=causal)
            skips.append(x)
        return x, skips


class UpsampleBlock1d(nn.Module):
    """Skip-concat resnets (skips consumed LIFO, scaled by 2^-1/2) ->
    [Transformer1d] -> upsample."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        factor: int,
        num_layers: int,
        num_groups: int,
        skip_channels: int,
        attn: _AttnArgs,
        use_nearest: bool = False,
        use_skip_scale: bool = False,
        mapping_features: Optional[int] = None,
        use_snake: bool = False,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.skip_scale = 2**-0.5 if use_skip_scale else 1.0
        for i in range(num_layers):
            self.add_module(f"block{i}", ResnetBlock1d(
                in_channels + skip_channels, in_channels,
                num_groups=num_groups, mapping_features=mapping_features,
                use_snake=use_snake,
            ))
        self.transformer = _transformer(attn, in_channels) if attn.num_blocks > 0 else None
        self.upsample = Upsample1d(in_channels, out_channels, factor, use_nearest)

    def forward(self, x, skips, mapping=None, embedding=None, embedding_mask=None,
                causal: bool = False):
        skips = list(skips)
        for i in range(self.num_layers):
            x, skip = _crop_to_common_length(x, skips.pop())
            x = torch.cat([x, skip * self.skip_scale], dim=-1)
            x = getattr(self, f"block{i}")(x, mapping=mapping, causal=causal)
        if self.transformer is not None:
            x = self.transformer(x, context=embedding, context_mask=embedding_mask,
                                 causal=causal)
        return self.upsample(x)


class BottleneckBlock1d(nn.Module):
    """Resnet -> [Transformer1d] -> resnet."""

    def __init__(self, channels: int, num_groups: int, attn: _AttnArgs,
                 mapping_features: Optional[int] = None, use_snake: bool = False):
        super().__init__()
        kw = dict(num_groups=num_groups, mapping_features=mapping_features,
                  use_snake=use_snake)
        self.pre_block = ResnetBlock1d(channels, channels, **kw)
        self.transformer = _transformer(attn, channels) if attn.num_blocks > 0 else None
        self.post_block = ResnetBlock1d(channels, channels, **kw)

    def forward(self, x, mapping=None, embedding=None, embedding_mask=None,
                causal: bool = False):
        x = self.pre_block(x, mapping=mapping, causal=causal)
        if self.transformer is not None:
            x = self.transformer(x, context=embedding, context_mask=embedding_mask,
                                 causal=causal)
        return self.post_block(x, mapping=mapping, causal=causal)

