"""Port parity of jen1_tpu_torch/ops against jen1_tpu/ops on the same numpy
inputs and weights (fp32, CPU). Bars 1e-5 to 1e-4: the same arithmetic in
another order. Then the port against itself: `group_norm_act`'s plain
version against the composition it replaced (bit for bit), the
channels-last convs against the transposing path they replaced, and the
route that sends a CUDA call to K5 or a plain version (by its counters)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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


# ------------------------------------------- GroupNorm + FiLM + SiLU (K5's route)

def composed_group_norm(x, gn, scale_shift, silu):
    """The conv block's norm, FiLM and SiLU as separate steps: GroupNorm's
    forward, then models/blocks.py's FiLM and activation, as they were
    before `group_norm_act` carried them."""
    y = F.group_norm(x.transpose(1, 2).float(), gn.num_groups, gn.weight, gn.bias, gn.eps)
    y = y.to(x.dtype).transpose(1, 2)
    if scale_shift is not None:
        scale, shift = scale_shift
        y = y * (scale + 1.0) + shift
    return F.silu(y) if silu else y


def group_norm_case(groups, eps, dtype, film, seed=0, b=3, length=19, c=64):
    g = torch.Generator().manual_seed(seed)
    gn = GroupNorm(groups, c, eps=eps)
    with torch.no_grad():
        gn.weight.copy_(1.0 + 0.2 * torch.randn(c, generator=g))
        gn.bias.copy_(0.3 * torch.randn(c, generator=g))
    x = (2.0 + 3.0 * torch.randn((b, length, c), generator=g)).to(dtype)
    scale_shift = None
    if film:
        scale_shift = tuple(torch.randn((b, 1, c), generator=g).to(dtype) for _ in range(2))
    return gn, x, scale_shift


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("groups", [1, 8, 32])
def test_group_norm_act_plain_equals_composition(groups, eps, film, silu, dtype):
    """On the CPU `group_norm_act` is its plain version, which is the old
    GroupNorm -> FiLM -> SiLU composition bit for bit."""
    gn, x, scale_shift = group_norm_case(groups, eps, dtype, film, seed=groups)
    with torch.no_grad():
        out = gn(x, scale_shift, "silu" if silu else None)
        ref = composed_group_norm(x, gn, scale_shift, silu)
    assert out.dtype == dtype and out.shape == x.shape
    assert torch.equal(out, ref)


def old_conv1d(x, w, b, *, stride=1, dilation=1, causal=False):
    """ops/conv.py's conv before it fed cuDNN channels-last: pad and conv in
    (B, C, L), transposed back."""
    pad = (w.shape[-1] - 1) * dilation
    pads = (pad, 0) if causal else (pad // 2, pad // 2)
    xt = F.pad(x.transpose(1, 2), pads)
    return F.conv1d(xt, w.to(x.dtype), b.to(x.dtype), stride=stride,
                    dilation=dilation).transpose(1, 2)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("k,dilation,stride,cin", [(3, 1, 1, 5), (3, 2, 1, 16), (1, 1, 1, 64),
                                                   (9, 1, 4, 6), (5, 3, 2, 8)])
def test_conv1d_channels_last_matches_transposing_path(k, dilation, stride, cin, causal):
    """conv1d gives the old transposing path's values (fp32; up to the
    order of the sums) and a contiguous (B, L', C) for a contiguous input."""
    g = torch.Generator().manual_seed(k * 7 + stride)
    x = torch.randn((2, 41, cin), generator=g)
    w, b = torch.randn((6, cin, k), generator=g), torch.randn(6, generator=g)
    out = pconv.conv1d(x, w, b, stride=stride, dilation=dilation, causal=causal)
    ref = old_conv1d(x, w, b, stride=stride, dilation=dilation, causal=causal)
    assert out.shape == ref.shape and out.is_contiguous()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_conv_transpose1d_channels_last_matches_transposing_path(factor):
    g = torch.Generator().manual_seed(factor)
    x, w, b = (torch.randn((2, 11, 8), generator=g), torch.randn((8, 5, 2 * factor), generator=g),
               torch.randn(5, generator=g))
    kw = dict(stride=factor, padding=factor // 2 + factor % 2, output_padding=factor % 2)
    out = pconv.conv_transpose1d(x, w, b, **kw)
    ref = F.conv_transpose1d(x.transpose(1, 2), w, b, **kw).transpose(1, 2)
    assert out.shape == ref.shape and out.is_contiguous()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.fixture
def card_route(monkeypatch):
    """group_norm_act as it routes a CUDA call, on CPU tensors: every tensor
    counts as on the card, and the kernel is its plain version, counted."""
    from jen1_tpu_torch.ops import norm
    from jen1_tpu_torch.parallel import sp as seq

    def kernel(*args):
        norm.LAUNCHES += 1
        return norm.group_norm_act_plain(*args)

    monkeypatch.setattr(norm, "_on_card", lambda x: True)
    monkeypatch.setattr(norm, "group_norm_act_cuda", kernel)
    monkeypatch.setattr(seq, "all_reduce_sum", lambda t, sp: t)  # one rank
    monkeypatch.setattr(norm, "LAUNCHES", 0)
    monkeypatch.setattr(norm, "PLAIN_CUDA", 0)
    return norm


@pytest.mark.parametrize("case", ["no_grad", "frozen", "x_grad", "weight_grad", "film_grad",
                                  "no_grad_trained", "sp"])
def test_group_norm_route_by_counters(card_route, case):
    """A CUDA call takes K5 unless it needs a gradient (x, gamma / beta or
    the FiLM requires one, with grad enabled) or sp is active; those take a
    plain route and count in PLAIN_CUDA. Every route gives the plain
    version's values (sp over one rank: the two-pass formula)."""
    import contextlib

    from jen1_tpu_torch.parallel import sp as seq

    gn, x, scale_shift = group_norm_case(8, 1e-5, torch.float32, True)
    gn.requires_grad_(case in ("weight_grad", "no_grad_trained"))
    if case == "x_grad":
        x.requires_grad_(True)
    if case == "film_grad":
        scale_shift = (scale_shift[0].requires_grad_(True), scale_shift[1])
    grad = torch.no_grad() if case in ("no_grad", "no_grad_trained") else contextlib.nullcontext()
    sp = seq._set(seq.SPGroup(None, 0, 1)) if case == "sp" else contextlib.nullcontext()
    with grad, sp:
        out = gn(x, scale_shift, "silu")
    kernel = case in ("no_grad", "frozen", "no_grad_trained")
    assert (card_route.LAUNCHES, card_route.PLAIN_CUDA) == ((1, 0) if kernel else (0, 1))
    ref = composed_group_norm(x.detach(), gn, scale_shift and tuple(t.detach() for t in scale_shift),
                              True)
    torch.testing.assert_close(out.detach(), ref.detach(), rtol=1e-5, atol=1e-5)


def test_unet_group_norms_take_kernel_at_inference_and_plain_in_training(card_route):
    """Every GroupNorm of a tiny UNet forward takes K5 under no_grad and the
    plain route with its parameters training, one call per module."""
    import dataclasses

    from jen1_tpu_torch.config import tiny_test_config
    from jen1_tpu_torch.models.unet import unet_from_model_config
    from jen1_tpu_torch.ops.initializers import init_module

    mc = dataclasses.replace(tiny_test_config().model_config, remat=False)
    unet = init_module(unet_from_model_config(mc), torch.Generator().manual_seed(0))
    calls = sum(isinstance(m, GroupNorm) for m in unet.modules())
    g = torch.Generator().manual_seed(1)
    x, t = torch.randn((2, 32, mc.in_channels), generator=g), torch.rand((2,), generator=g)
    emb = torch.randn((2, 6, mc.context_embedding_features), generator=g)
    ctx = [torch.randn((2, 32, mc.context_channels[0]), generator=g)]
    with torch.no_grad():
        unet(x, t, embedding=emb, channels_list=ctx)
    assert (card_route.LAUNCHES, card_route.PLAIN_CUDA) == (calls, 0)
    unet(x, t, embedding=emb, channels_list=ctx).square().mean().backward()
    assert (card_route.LAUNCHES, card_route.PLAIN_CUDA) == (calls, calls)


def test_graph_counters_include_group_norm():
    """Graph replays add K5's and the plain routes' counts (utils/cuda_graphs)."""
    from jen1_tpu_torch.ops import norm
    from jen1_tpu_torch.utils import cuda_graphs

    names = {name for mod, name in cuda_graphs._counters() if mod is norm}
    assert names == {"LAUNCHES", "PLAIN_CUDA"}


@pytest.mark.parametrize("batch,length,channels,groups", [
    (8, 4500, 128, 1), (8, 4500, 257, 1), (8, 1125, 128, 8), (8, 1125, 256, 8), (8, 282, 512, 8),
    (8, 2, 1024, 32), (1, 3, 8, 8), (2, 300, 5120, 8), (3, 7, 12, 4)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_k5_launch_plan_covers_every_row(batch, length, channels, groups, itemsize):
    """K5's grid: one launch only where each block's rows fit its threads'
    registers over whole groups; two launches cover every row once with no
    empty block."""
    from jen1_tpu_torch.ops import norm

    vec = 16 // itemsize if channels % (16 // itemsize) == 0 else 1
    plan = norm.launch_plan(batch, length, channels, groups, itemsize, vec)
    if plan.resident:
        width = channels // plan.slices
        assert groups % plan.slices == 0 and (channels // groups) % vec == 0
        assert plan.slices == 1 or width * itemsize >= norm.MIN_SLICE_BYTES
        assert plan.ct == width // vec and length <= plan.r * norm.RESIDENT_ROWS
    else:
        assert plan.splits * plan.rows >= length > (plan.splits - 1) * plan.rows
        assert plan.ct <= channels // vec
    assert plan.ct * plan.r <= norm.MAX_THREADS
    assert batch * (plan.slices if plan.resident else plan.splits) <= 2 * norm.TARGET_BLOCKS
