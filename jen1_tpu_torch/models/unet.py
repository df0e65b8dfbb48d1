"""1-D UNet denoiser with classifier-free guidance, channels-last (B, L, C)
(port of jen1_tpu/models/unet.py).

Not ported yet: the encoder cache (`encoder_cache` /
`return_encoder_cache`) and STFT mode.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from jen1_tpu_torch.models.blocks import (
    BottleneckBlock1d,
    DownsampleBlock1d,
    Patcher,
    Unpatcher,
    UpsampleBlock1d,
    _AttnArgs,
    _crop_to_common_length,
)
from jen1_tpu_torch.ops.embeddings import FixedEmbedding, TimePositionalEmbedding, rand_bool
from jen1_tpu_torch.ops.linear import Linear


class UNet1d(nn.Module):
    """Symmetric encoder/decoder 1-D UNet (jen1_tpu/models/unet.py:35-478).

    Level i: Downsample1d(factor_i) -> num_blocks_i resnets ->
    [Transformer1d]; the matching up level eats those skips LIFO and ends
    with Upsample1d(factor_i). A Patcher/Unpatcher wraps the top and a
    resnet-transformer-resnet bottleneck sits at the bottom. Time (and
    optional global features) map to a FiLM vector."""

    def __init__(
        self,
        in_channels: int,
        channels: int,
        multipliers: Sequence[int],
        factors: Sequence[int],
        num_blocks: Sequence[int],
        attentions: Sequence[int],
        patch_size: int = 1,
        resnet_groups: int = 8,
        use_context_time: bool = True,
        kernel_multiplier_downsample: int = 2,
        use_nearest_upsample: bool = False,
        use_skip_scale: bool = True,
        out_channels: Optional[int] = None,
        context_features: Optional[int] = None,
        context_features_multiplier: int = 4,
        context_channels: Sequence[int] = (),
        context_embedding_features: Optional[int] = None,
        attention_heads: Optional[int] = None,
        attention_features: Optional[int] = None,
        attention_multiplier: Optional[int] = None,
        tie_transformer_projections: bool = False,
        use_flash_attention: bool = False,
        flash_min_seq_len: int = 512,
    ):
        super().__init__()
        n = len(multipliers) - 1
        assert len(factors) == n and len(num_blocks) == n and len(attentions) >= n
        self.num_layers = n
        self.use_context_time = use_context_time
        self.context_features = context_features
        cc = list(context_channels)
        self.context_channels = cc + [0] * (n + 1 - len(cc))
        mf = (
            channels * context_features_multiplier
            if use_context_time or context_features is not None
            else None
        )
        self.mapping_features = mf
        if use_context_time:
            self.to_time = TimePositionalEmbedding(channels, mf)
        if context_features is not None:
            self.to_features = Linear(context_features, mf)
        if mf is not None:
            self.to_mapping_1 = Linear(mf, mf)
            self.to_mapping_2 = Linear(mf, mf)

        def attn(num_blocks):
            return _AttnArgs(
                num_blocks, attention_heads, attention_features, attention_multiplier,
                context_embedding_features, tie_transformer_projections,
                use_flash_attention, flash_min_seq_len,
            )

        common = dict(mapping_features=mf)
        self.to_in = Patcher(
            in_channels + self.context_channels[0], channels * multipliers[0],
            patch_size, **common,
        )
        for i in range(n):
            self.add_module(f"downsample{i}", DownsampleBlock1d(
                channels * multipliers[i], channels * multipliers[i + 1],
                factor=factors[i], num_groups=resnet_groups, num_layers=num_blocks[i],
                attn=attn(attentions[i]), kernel_multiplier=kernel_multiplier_downsample,
                context_channels=self.context_channels[i + 1], **common,
            ))
        self.bottleneck = BottleneckBlock1d(
            channels * multipliers[-1], resnet_groups, attn(attentions[-1]), **common
        )
        for j, i in enumerate(reversed(range(n))):
            self.add_module(f"upsample{j}", UpsampleBlock1d(
                channels * multipliers[i + 1], channels * multipliers[i],
                factor=factors[i],
                num_layers=num_blocks[i] + (1 if attentions[i] else 0),
                num_groups=resnet_groups,
                skip_channels=channels * multipliers[i + 1],
                attn=attn(attentions[i]), use_nearest=use_nearest_upsample,
                use_skip_scale=use_skip_scale, **common,
            ))
        self.to_out = Unpatcher(
            channels * multipliers[0], out_channels or in_channels, patch_size, **common
        )

    def _get_channels(self, channels_list, layer: int) -> Optional[torch.Tensor]:
        """The context-channels tensor for `layer`."""
        cc = self.context_channels
        if cc[layer] == 0:
            return None
        assert channels_list is not None, f"missing context channels for layer {layer}"
        channels = channels_list[sum(c > 0 for c in cc[:layer])]
        assert channels.shape[-1] == cc[layer], (
            f"expected {cc[layer]} context channels at layer {layer}, "
            f"got {channels.shape[-1]}"
        )
        return channels

    def _get_mapping(self, time, features) -> Optional[torch.Tensor]:
        if self.mapping_features is None:
            return None
        items = []
        if self.use_context_time:
            assert time is not None, "use_context_time=True but no time provided"
            items.append(F.gelu(self.to_time(time)))
        if self.context_features is not None:
            assert features is not None, "context_features set but none provided"
            items.append(F.gelu(self.to_features(features)))
        mapping = sum(items)
        mapping = F.gelu(self.to_mapping_1(mapping))
        return F.gelu(self.to_mapping_2(mapping))

    def forward(
        self,
        x: torch.Tensor,  # (B, L, in_channels)
        time: Optional[torch.Tensor] = None,  # (B,)
        *,
        features: Optional[torch.Tensor] = None,
        channels_list: Optional[Sequence[torch.Tensor]] = None,
        embedding: Optional[torch.Tensor] = None,  # (B, M, E)
        embedding_mask: Optional[torch.Tensor] = None,  # (B, M)
        causal: bool = False,
    ) -> torch.Tensor:
        channels = self._get_channels(channels_list, 0)
        if channels is not None:
            x = torch.cat([x, channels.to(x.dtype)], dim=-1)
        mapping = self._get_mapping(time, features)
        if mapping is not None:
            # FiLM follows the activation dtype, as in the JAX package
            mapping = mapping.to(x.dtype)
        if embedding is not None:
            embedding = embedding.to(x.dtype)
        ctx = dict(embedding=embedding, embedding_mask=embedding_mask, causal=causal)

        x = self.to_in(x, mapping=mapping)
        skips_list: List[List[torch.Tensor]] = [[x]]
        for i in range(self.num_layers):
            x, skips = getattr(self, f"downsample{i}")(
                x, mapping=mapping, channels=self._get_channels(channels_list, i + 1), **ctx
            )
            skips_list.append(skips)
        x = self.bottleneck(x, mapping=mapping, **ctx)
        for j in range(self.num_layers):
            x = getattr(self, f"upsample{j}")(
                x, skips=skips_list.pop(), mapping=mapping, **ctx
            )
        (skip0,) = skips_list.pop()
        x, skip0 = _crop_to_common_length(x, skip0)
        return self.to_out(x + skip0, mapping=mapping)


class UNetCFG1d(nn.Module):
    """UNet1d + classifier-free guidance (jen1_tpu/models/unet.py:481-585):
    optional cross-attention time token, learned null embedding, batch-CFG
    (one doubled forward) or two forwards, guidance mix and the optional
    std-matching rescale (`scale_cfg`, `scale_phi`)."""

    def __init__(
        self,
        context_embedding_max_length: int,
        context_embedding_features: int,
        use_xattn_time: bool = False,
        **unet_kwargs,
    ):
        super().__init__()
        self.unet = UNet1d(
            context_embedding_features=context_embedding_features, **unet_kwargs
        )
        self.fixed_embedding = FixedEmbedding(
            context_embedding_max_length + (1 if use_xattn_time else 0),
            context_embedding_features,
        )
        self.to_time_embedding = (
            TimePositionalEmbedding(unet_kwargs["channels"], context_embedding_features)
            if use_xattn_time
            else None
        )

    def forward(
        self,
        x: torch.Tensor,  # (B, L, C)
        time: torch.Tensor,  # (B,)
        *,
        embedding: torch.Tensor,  # (B, M, E)
        embedding_mask: Optional[torch.Tensor] = None,  # (B, M)
        embedding_scale: float = 1.0,
        embedding_mask_proba: float = 0.0,
        batch_cfg: bool = False,
        scale_cfg: bool = False,
        scale_phi: float = 0.7,
        features: Optional[torch.Tensor] = None,
        channels_list: Optional[Sequence[torch.Tensor]] = None,
        causal: bool = False,
        generator: Optional[torch.Generator] = None,
        embedding_mask_bits: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """CFG dropout (training): with embedding_mask_proba > 0 each
        example's embedding is replaced by the null embedding where its bit
        is set. The (B, 1, 1) bits are `embedding_mask_bits` when given,
        else drawn as rand_bool(generator, (B, 1, 1), proba)."""
        b = embedding.shape[0]
        if self.to_time_embedding is not None:
            token = F.gelu(self.to_time_embedding(time.float())).to(embedding.dtype)
            embedding = torch.cat([embedding, token[:, None, :]], dim=1)
            if embedding_mask is not None:
                ones = torch.ones((b, 1), dtype=embedding_mask.dtype,
                                  device=embedding_mask.device)
                embedding_mask = torch.cat([embedding_mask, ones], dim=1)
        fixed_embedding = self.fixed_embedding(embedding)
        if embedding_mask_proba > 0.0:
            bits = embedding_mask_bits
            if bits is None:
                bits = rand_bool(generator, (b, 1, 1), embedding_mask_proba, embedding.device)
            embedding = torch.where(bits.to(embedding.device), fixed_embedding, embedding)
        kw = dict(features=features, channels_list=channels_list, causal=causal)

        if embedding_scale == 1.0:
            return self.unet(x, time, embedding=embedding, embedding_mask=embedding_mask, **kw)

        if batch_cfg:
            def twice(a):
                return None if a is None else torch.cat([a, a], dim=0)

            out, out_masked = self.unet(
                twice(x), twice(time),
                embedding=torch.cat([embedding, fixed_embedding], dim=0),
                embedding_mask=twice(embedding_mask),
                features=twice(features),
                channels_list=(None if channels_list is None
                               else [twice(c) for c in channels_list]),
                causal=causal,
            ).chunk(2, dim=0)
        else:
            out = self.unet(x, time, embedding=embedding, embedding_mask=embedding_mask, **kw)
            out_masked = self.unet(
                x, time, embedding=fixed_embedding, embedding_mask=embedding_mask, **kw
            )

        out_cfg = out_masked + (out - out_masked) * embedding_scale
        if scale_cfg:
            # std over channels with Bessel's correction (torch Tensor.std)
            out_std = out.float().std(dim=-1, keepdim=True, correction=1)
            cfg32 = out_cfg.float()
            cfg_std = cfg32.std(dim=-1, keepdim=True, correction=1)
            mixed = scale_phi * (cfg32 * (out_std / cfg_std)) + (1.0 - scale_phi) * cfg32
            out_cfg = mixed.to(out_cfg.dtype)
        return out_cfg


def unet_from_model_config(mc) -> UNetCFG1d:
    """Build UNetCFG1d from a `jen1_tpu_torch.config.ModelConfig`."""
    return UNetCFG1d(
        context_embedding_max_length=mc.context_embedding_max_length,
        context_embedding_features=mc.context_embedding_features,
        use_xattn_time=mc.use_xattn_time,
        in_channels=mc.in_channels,
        channels=mc.channels,
        multipliers=tuple(mc.multipliers),
        factors=tuple(mc.factors),
        num_blocks=tuple(mc.num_blocks),
        attentions=tuple(mc.attentions),
        patch_size=mc.patch_size,
        resnet_groups=mc.resnet_groups,
        use_context_time=mc.use_context_time,
        kernel_multiplier_downsample=mc.kernel_multiplier_downsample,
        use_nearest_upsample=mc.use_nearest_upsample,
        use_skip_scale=mc.use_skip_scale,
        out_channels=mc.out_channels,
        context_features=mc.context_features,
        context_features_multiplier=mc.context_features_multiplier,
        context_channels=tuple(mc.context_channels),
        attention_heads=mc.attention_heads,
        attention_features=mc.attention_features,
        attention_multiplier=mc.attention_multiplier,
        tie_transformer_projections=mc.tie_transformer_projections,
        use_flash_attention=mc.use_flash_attention,
        flash_min_seq_len=mc.flash_min_seq_len,
    )
