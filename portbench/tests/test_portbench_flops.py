"""The benchmark's count of the work: the UNet's FLOPs against a hand
count at a tiny configuration, and the flash kernels' operations and bytes
against the bounds chip_smoke.py printed for K1-K3 (PERF.md's kernel
table: bound ms at B*H 16 and 64, N 1125, D 16, bf16)."""

from __future__ import annotations

import pytest

from portbench import flops

TINY = dict(in_channels=4, channels=8, multipliers=[1, 2], factors=[2], num_blocks=[1],
            attentions=[1], context_features_multiplier=1, context_embedding_features=8,
            context_channels=[5], kernel_multiplier_downsample=2, attention_multiplier=1,
            out_channels=4, use_flash_attention=False, flash_min_seq_len=1024,
            attention_heads=2, attention_features=None)


def test_unet_flops_by_hand():
    b, L, m = 1, 6, 3
    mf = 8
    f = 2 * 9 * mf + 2 * 2 * mf * mf + 2 * 9 * 8  # time, mapping, time token
    # to_in resnet 9 -> 8 at 6 frames: two k3 convs, FiLM, a 1x1 projection
    f += 2 * 6 * 9 * 8 * 3 + 2 * 6 * 8 * 8 * 3 + 2 * mf * 16 + 2 * 6 * 9 * 8
    f += 2 * 3 * 8 * 16 * 5  # downsample k5 stride 2 to 3 frames, 8 -> 16
    res16 = 2 * 3 * 16 * 16 * 3 * 2 + 2 * mf * 32
    tr = (2 * 2 * 3 * 16 * 16 + 2 * 3 * 16 * 48 + 4 * 3 * 3 * 16 + 2 * 3 * 16 * 16
          + 2 * 3 * 16 * 16 + 2 * m * 8 * 32 + 4 * 3 * m * 16 + 2 * 3 * 16 * 16
          + 4 * 3 * 16 * 16)
    f += res16 + tr  # down level: one resnet, one transformer
    f += 2 * res16 + tr  # bottleneck
    res_up = 2 * 3 * 32 * 16 * 3 + 2 * 3 * 16 * 16 * 3 + 2 * mf * 32 + 2 * 3 * 32 * 16
    f += 2 * res_up + tr + 2 * 3 * 16 * 8 * 4  # two skip resnets, transformer, upsample k4
    f += 2 * 6 * 8 * 4 * 3 + 2 * 6 * 4 * 4 * 3 + 2 * mf * 8 + 2 * 6 * 8 * 4  # to_out
    assert flops.unet_forward_flops(TINY, b, L, m) == f
    assert flops.unet_forward_flops(TINY, 4, L, m) == 4 * f
    # causal self-attention counts the pairs at or below the diagonal
    saved = 3 * (4 * 3 * 3 * 16 - 4 * 6 * 16)  # three transformers, n=3: 9 -> 6 pairs
    assert flops.unet_forward_flops(TINY, b, L, m, causal=True) == f - saved


@pytest.mark.parametrize("fn,bh,bound_ms", [
    (flops.attn_fwd, 16, 0.0013104), (flops.attn_fwd, 64, 0.0052417),
    (flops.attn_bwd_dq, 16, 0.0019656), (flops.attn_bwd_dkv, 16, 0.0026208),
    (flops.attn_bwd_dq, 32, 0.0039312), (flops.attn_bwd_dkv, 32, 0.0052417),
])
def test_attention_bounds_match_chip_smoke(fn, bh, bound_ms):
    assert flops.bound_s(*fn(bh, 1125, 16)) * 1e3 == pytest.approx(bound_ms, rel=1e-4)


def test_flash_calls_follow_the_level_lengths():
    mc = dict(TINY, factors=[1, 4, 4], multipliers=[1, 1, 2, 2], attentions=[0, 1, 1],
              use_flash_attention=True)
    assert flops.level_lengths(mc, 4500) == [4500, 4500, 1125, 282]
    assert flops.flash_calls(mc, 4500) == [(1, 1125)]
    assert flops.flash_calls(mc, 1500) == []  # 375 frames: the plain path
