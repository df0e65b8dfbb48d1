"""Port parity of jen1_tpu_torch/ops against jen1_tpu/ops on the same numpy
inputs and weights (fp32, CPU). Bars 1e-5 to 1e-4: the same arithmetic in
another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jen1_tpu.ops import conv as jconv
from jen1_tpu.ops import embeddings as jemb
from jen1_tpu.ops.linear import Linear as JLinear
from jen1_tpu.ops.norm import GroupNorm as JGroupNorm, LayerNorm as JLayerNorm
from jen1_tpu_torch.ops import conv as pconv
from jen1_tpu_torch.ops import embeddings as pemb
from jen1_tpu_torch.ops.linear import Linear
from jen1_tpu_torch.ops.norm import GroupNorm, LayerNorm
from torch_port_util import assert_close, load, randn, rng

T = torch.from_numpy


def flax_vs_port(jmodule, pmodule, x, atol=1e-5, **call_kw):
    params = jmodule.init(jax.random.PRNGKey(0), x, **call_kw)
    ref = jmodule.apply(params, x, **call_kw)
    with torch.no_grad():
        out = load(pmodule, params)(torch.tensor(np.asarray(x)), **call_kw)
    assert out.shape == ref.shape
    assert_close(out, ref, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("k,dilation,stride", [(3, 1, 1), (3, 2, 1), (4, 1, 1), (9, 1, 4)])
def test_conv1d(k, dilation, stride, causal):
    g = rng(k * 10 + dilation + stride)
    x, w, b = randn(g, 2, 37, 5), randn(g, k, 5, 6), randn(g, 6)
    ref = jconv.conv1d(x, w, b, stride=stride, dilation=dilation, causal=causal)
    out = pconv.conv1d(T(x), T(w.transpose(2, 1, 0).copy()), T(b),
                       stride=stride, dilation=dilation, causal=causal)
    assert out.shape == ref.shape
    assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_conv_transpose1d(factor):
    g = rng(factor)
    x, w, b = randn(g, 2, 11, 4), randn(g, 2 * factor, 4, 3), randn(g, 3)
    kw = dict(stride=factor, padding=factor // 2 + factor % 2, output_padding=factor % 2)
    ref = jconv.conv_transpose1d(x, w, b, **kw)
    out = pconv.conv_transpose1d(T(x), T(w.transpose(1, 2, 0).copy()), T(b), **kw)
    assert out.shape == ref.shape
    assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("factor,nearest", [(1, False), (2, True), (4, False), (3, False)])
def test_upsample1d_branches(factor, nearest):
    """factor 1: plain conv; nearest: repeat + conv; else transposed conv."""
    x = jnp.asarray(randn(rng(factor), 2, 13, 6))
    flax_vs_port(jconv.Upsample1d(out_channels=4, factor=factor, use_nearest=nearest),
                 pconv.Upsample1d(6, 4, factor, use_nearest=nearest), x)


@pytest.mark.parametrize("causal", [False, True])
def test_downsample1d(causal):
    x = jnp.asarray(randn(rng(5), 2, 45, 6))
    flax_vs_port(jconv.Downsample1d(out_channels=8, factor=4, kernel_multiplier=2),
                 pconv.Downsample1d(6, 8, 4, 2), x, causal=causal)


@pytest.mark.parametrize("causal", [False, True])
def test_omni_conv1d(causal):
    x = jnp.asarray(randn(rng(6), 2, 21, 6))
    flax_vs_port(jconv.OmniConv1d(out_channels=5, kernel_size=3, dilation=2),
                 pconv.OmniConv1d(6, 5, 3, dilation=2), x, causal=causal)


@pytest.mark.parametrize("groups,eps", [(1, 1e-5), (4, 1e-5), (8, 1e-6)])
def test_group_norm(groups, eps):
    x = jnp.asarray(3.0 + 2.0 * randn(rng(groups), 2, 17, 8))
    flax_vs_port(JGroupNorm(num_groups=groups, eps=eps), GroupNorm(groups, 8, eps=eps), x,
                 atol=1e-4)


def test_layer_norm():
    x = jnp.asarray(1.0 + randn(rng(7), 2, 9, 12))
    flax_vs_port(JLayerNorm(), LayerNorm(12), x, atol=1e-4)


@pytest.mark.parametrize("use_bias", [True, False])
def test_linear(use_bias):
    x = jnp.asarray(randn(rng(8), 3, 5, 7))
    flax_vs_port(JLinear(features=4, use_bias=use_bias), Linear(7, 4, use_bias=use_bias), x)


def test_learned_positional_and_time_embedding():
    t = jnp.asarray(rng(9).uniform(size=(4,)).astype(np.float32))
    flax_vs_port(jemb.LearnedPositionalEmbedding(dim=16),
                 pemb.LearnedPositionalEmbedding(16), t, atol=1e-4)
    flax_vs_port(jemb.TimePositionalEmbedding(dim=16, out_features=12),
                 pemb.TimePositionalEmbedding(16, 12), t, atol=1e-4)


def test_fixed_embedding():
    x = jnp.asarray(randn(rng(10), 3, 5, 7))
    flax_vs_port(jemb.FixedEmbedding(max_length=6, features=7), pemb.FixedEmbedding(6, 7), x)
