"""1-D UNet denoiser with classifier-free guidance, channels-last (B, L, C)
(port of jen1_tpu/models/unet.py).

The encoder cache (`encoder_cache` / `return_encoder_cache`) carries the
pre-bottleneck feature and the skips of levels 1..n from a full forward to
decoder-only forwards (Faster-Diffusion encoder propagation, the samplers'
`encoder_reuse`). `remat` recomputes each down block, the bottleneck and
each up block in the backward (`torch.utils.checkpoint`). `use_snake`
swaps every conv block's SiLU for Snake. `use_stft` runs the UNet on the
STFT of a waveform input (`ops/stft.py`: magnitude and phase channels, the
context STFT-encoded too with `use_stft_context`) and inverts its output
back to the input's length.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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
from jen1_tpu_torch.ops.stft import STFT
from jen1_tpu_torch.parallel import sp as seq


# (pre-bottleneck feature, per-level skips of levels 1..n): a plain tuple of
# tensors, the same structure from a full and a decoder-only forward
EncoderCache = Tuple[torch.Tensor, Tuple[Tuple[torch.Tensor, ...], ...]]


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
        use_snake: bool = False,
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
        remat: bool = False,
        use_stft: bool = False,
        use_stft_context: bool = False,
        stft_num_fft: int = 1023,
        stft_hop_length: int = 256,
    ):
        super().__init__()
        n = len(multipliers) - 1
        self.remat = remat
        assert len(factors) == n and len(num_blocks) == n and len(attentions) >= n
        self.num_layers = n
        # the length the down stack divides exactly (sequence parallelism)
        self.length_multiple = patch_size * math.prod(factors[:n])
        self.use_context_time = use_context_time
        self.context_features = context_features
        # STFT mode (jen1_tpu/models/unet.py:85-93): C waveform channels
        # become C * stft_channels stacked magnitude and phase channels
        self.stft = STFT(num_fft=stft_num_fft, hop_length=stft_hop_length) if use_stft else None
        self.use_stft_context = use_stft_context
        stft_channels = (stft_num_fft // 2 + 1) * 2 if use_stft else 1
        cc = list(context_channels)
        if cc and use_stft and use_stft_context:
            cc[0] *= stft_channels
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

        common = dict(mapping_features=mf, use_snake=use_snake)
        self.to_in = Patcher(
            in_channels * stft_channels + self.context_channels[0], channels * multipliers[0],
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
            channels * multipliers[0], (out_channels or in_channels) * stft_channels,
            patch_size, **common,
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

    def _block(self, block: nn.Module, *args, **kw):
        """One down, bottleneck or up block; under `remat` with grad enabled
        its activations are recomputed in the backward instead of stored
        (jen1_tpu/models/unet.py:249-343, nn.remat per block)."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False, **kw)
        return block(*args, **kw)

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
        encoder_cache: Optional[EncoderCache] = None,
        return_encoder_cache: bool = False,
    ):
        """With `encoder_cache` (x_pre_bottleneck, skips of levels 1..n) the
        down stack is skipped: the patcher still runs on the current x (its
        output is skip0), the bottleneck and the up stack run against the
        cached features (jen1_tpu/models/unet.py:159-168, 215-223). With
        `return_encoder_cache` the forward returns (out, cache); a full
        forward's cache is its own pre-bottleneck feature and skips, a
        decoder-only forward's the cache it was given. In STFT mode x is a
        waveform (B, T, C) and so is the output; the cache holds STFT-domain
        features."""
        wave_len, x_dtype = x.shape[1], x.dtype
        if seq.active() is not None:
            if self.stft is not None:
                raise NotImplementedError("sequence parallelism over the STFT-domain UNet "
                                          "(its STFT spans the whole waveform)")
            seq.check_length(x.shape[1], self.length_multiple)
        if self.stft is not None:
            if self.use_stft_context and channels_list is not None:
                channels_list = [self._stft_encode(c) for c in channels_list]
            x = self._stft_encode(x)
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
        if encoder_cache is not None:
            x, cached_skips = encoder_cache
            skips_list += [list(s) for s in cached_skips]
            cache = encoder_cache
        else:
            for i in range(self.num_layers):
                x, skips = self._block(
                    getattr(self, f"downsample{i}"), x, mapping=mapping,
                    channels=self._get_channels(channels_list, i + 1), **ctx,
                )
                skips_list.append(skips)
            cache = (x, tuple(tuple(s) for s in skips_list[1:]))
        x = self._block(self.bottleneck, x, mapping=mapping, **ctx)
        for j in range(self.num_layers):
            x = self._block(getattr(self, f"upsample{j}"), x, skips=skips_list.pop(),
                            mapping=mapping, **ctx)
        (skip0,) = skips_list.pop()
        x, skip0 = _crop_to_common_length(x, skip0)
        out = self.to_out(x + skip0, mapping=mapping)
        if self.stft is not None:
            # back to the waveform at the input's length, in fp32
            out = self.stft.decode1d(out.transpose(1, 2).float(), length=wave_len)
            out = out.transpose(1, 2).to(x_dtype)
        return (out, cache) if return_encoder_cache else out

    def _stft_encode(self, wave: torch.Tensor) -> torch.Tensor:
        """(B, T, C) waveform -> (B, L_frames, 2 C F) in wave's dtype."""
        return self.stft.encode1d(wave.transpose(1, 2)).transpose(1, 2).to(wave.dtype)


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
        encoder_cache: Optional[EncoderCache] = None,
        return_encoder_cache: bool = False,
    ):
        """CFG dropout (training): with embedding_mask_proba > 0 each
        example's embedding is replaced by the null embedding where its bit
        is set. The (B, 1, 1) bits are `embedding_mask_bits` when given,
        else drawn as rand_bool(generator, (B, 1, 1), proba).

        `encoder_cache` / `return_encoder_cache` pass to the UNet
        (jen1_tpu/models/unet.py:485-500); under guidance the cache lives
        in the CFG-doubled batch, so it needs batch_cfg=True."""
        cache_kw = dict(encoder_cache=encoder_cache, return_encoder_cache=return_encoder_cache)
        if (encoder_cache is not None or return_encoder_cache) and (
                embedding_scale != 1.0 and not batch_cfg):
            raise ValueError("encoder propagation with CFG requires batch_cfg=True "
                             "(the cache lives in the CFG-doubled batch)")
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
            return self.unet(x, time, embedding=embedding, embedding_mask=embedding_mask,
                             **kw, **cache_kw)

        cache = None
        if batch_cfg:
            def twice(a):
                return None if a is None else torch.cat([a, a], dim=0)

            batch_out = self.unet(
                twice(x), twice(time),
                embedding=torch.cat([embedding, fixed_embedding], dim=0),
                embedding_mask=twice(embedding_mask),
                features=twice(features),
                channels_list=(None if channels_list is None
                               else [twice(c) for c in channels_list]),
                causal=causal,
                **cache_kw,
            )
            if return_encoder_cache:
                batch_out, cache = batch_out
            out, out_masked = batch_out.chunk(2, dim=0)
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
        return (out_cfg, cache) if return_encoder_cache else out_cfg


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
        use_snake=mc.use_snake,
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
        remat=mc.remat,
        use_stft=mc.use_stft,
        use_stft_context=mc.use_stft_context,
        stft_num_fft=mc.stft_num_fft,
        stft_hop_length=mc.stft_hop_length,
    )
