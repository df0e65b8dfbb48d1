"""Port parity of the int8 weight-only path: jen1_tpu_torch/ops/int8_matmul.py
and the qweights wiring of OmniConv1d against jen1_tpu/ops/int8_matmul.py.

JAX runs its Pallas kernel in interpret mode (as tests/test_int8_matmul.py
does); the port runs the plain version of K4, since the tensors lie on the
CPU. Bars:
  * quantize_weight: equal int8 values and scales (same fp32 arithmetic,
    round half to even on both sides).
  * matmul_int8w: elementwise within 1e-4 * max|ref|: both sides sum the
    same exact products (bf16 x int8 fits an fp32) in other orders.
  * conv1d_int8w and one quantized OmniConv1d: the same bar on top of the
    same im2col.
  * a tiny UNetCFG1d with every conv quantized (thresholds 0): rtol 1e-2 /
    atol 1e-3. Both sides round each int8 conv's input to bf16, so an fp32
    difference upstream (the plain-forward bar is rtol 2e-3) can flip one
    bf16 step (2^-8 relative) of a conv input.
The census runs on the full-width default preset: the port's UNet is built
on the meta device and the JAX one through eval_shape, so nothing is
allocated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jen1_tpu.config import ModelConfig as JModelConfig
from jen1_tpu.models.unet import unet_from_model_config as jax_unet
from jen1_tpu.ops import conv as jconv
from jen1_tpu.ops import int8_matmul as jint8
from jen1_tpu_torch.ckpt.from_jax import load_flax_qweights
from jen1_tpu_torch.config import ModelConfig
from jen1_tpu_torch.models.unet import unet_from_model_config as port_unet
from jen1_tpu_torch.ops import conv as pconv
from jen1_tpu_torch.ops import int8_matmul as pint8
from torch_port_util import (
    assert_close, flash_model_configs, load, np_tree, randn, random_params, rng,
)

T = torch.from_numpy
TREE_BAR = dict(rtol=1e-2, atol=1e-3)


def assert_rel(out, ref, rel=1e-4):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref, np.float32)
    bar = rel * np.abs(ref).max()
    assert np.abs(out - ref).max() <= bar, (np.abs(out - ref).max(), bar)


def flat_paths(tree, prefix=""):
    """Dotted paths of the scopes that hold a kernel8 leaf."""
    out = set()
    for key, value in tree.items():
        if key == "kernel8":
            out.add(prefix[:-1])
        elif hasattr(value, "items"):
            out |= flat_paths(value, f"{prefix}{key}.")
    return out


@pytest.mark.parametrize("case", ["normal", "zero_columns", "ties"])
def test_quantize_weight_is_bit_identical(case):
    g = rng(0)
    w = (randn(g, 96, 40) * 0.3).astype(np.float32)
    if case == "zero_columns":
        w[:, [0, 7, 39]] = 0.0
    elif case == "ties":
        # amax 127 -> scale exactly 1: every x.5 is a rounding tie
        w = np.round(randn(g, 96, 40) * 40.0).astype(np.float32) + 0.5
        w[0, :] = 127.0
    jw8, js = jint8.quantize_weight(jnp.asarray(w))
    pw8, ps = pint8.quantize_weight(T(w))
    assert pw8.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pw8.numpy(), np.asarray(jw8))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    if case == "ties":
        assert (np.abs(w) % 1 == 0.5).sum() > 1000


@pytest.mark.parametrize("m,k,n", [(130, 96, 72), (282, 3072, 128), (6, 3072, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_int8w_matches_jax(m, k, n, dtype):
    g = rng(m + k + n)
    x = randn(g, m, k)
    w8, s = jint8.quantize_weight(jnp.asarray(randn(g, k, n) * 0.05))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    ref = jint8.matmul_int8w(jx, w8, s)
    px = T(x).to(getattr(torch, dtype))
    out = pint8.matmul_int8w(px, T(np.array(w8)), T(np.array(s)))
    assert out.shape == (m, n) and out.dtype == torch.float32
    assert_rel(out, ref)


def test_scale_applies_after_the_sum():
    """Dequantizing to bf16 before the product (w8 * scale rounded to bf16)
    is a different function: it must fail the bar the kernel is held to."""
    g = rng(4)
    x = T(randn(g, 10, 3072)).to(torch.bfloat16)
    w8, s = pint8.quantize_weight(T(randn(g, 3072, 256) * 0.05))
    ref = pint8.matmul_int8w_plain(x, w8, s)
    early = x.float() @ (w8.float() * s).to(torch.bfloat16).float()
    assert (early - ref).abs().max() > 1e-4 * ref.abs().max()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dilation", [1, 2])
def test_conv1d_int8w_matches_jax(causal, dilation):
    g = rng(2 + dilation)
    b, length, cin, cout, k = 2, 37, 24, 16, 3
    x, w, bias = randn(g, b, length, cin), randn(g, k, cin, cout) * 0.1, randn(g, cout)
    w8, s = jint8.quantize_weight(jnp.asarray(w).reshape(k * cin, cout))
    ref = jint8.conv1d_int8w(jnp.asarray(x), w8.reshape(k, cin, cout), s, jnp.asarray(bias),
                             causal=causal, dilation=dilation)
    out = pint8.conv1d_int8w(T(x), T(np.array(w8)), T(np.array(s)), T(bias),
                             causal=causal, dilation=dilation)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert_rel(out, ref)


def test_census_matches_jax_at_full_width():
    """The default preset: the same 56 conv kernels selected, 52 of them
    read by stride-1 convs (123,731,968 int8 bytes)."""
    jcfg = JModelConfig()
    jmodel = jax_unet(jcfg)
    mc = jcfg
    shapes = jax.eval_shape(lambda r: jmodel.init(
        r, jnp.zeros((1, 4096, mc.in_channels)), jnp.zeros((1,)),
        embedding=jnp.zeros((1, mc.context_embedding_max_length, mc.context_embedding_features)),
        channels_list=[jnp.zeros((1, 4096, mc.context_channels[0]))],
    ), jax.random.PRNGKey(0))
    jq = jax.eval_shape(jint8.quantize_conv_params, shapes)
    with torch.device("meta"):
        pmodel = port_unet(ModelConfig())
    pq = pint8.quantize_conv_params(pmodel)
    assert set(pq) == flat_paths(jq) and len(pq) == 56
    assert sum(w8.numel() for w8, _ in pq.values()) == 137_887_744
    read = [p for p in pq if pint8.reads_qweights(pmodel.get_submodule(p))]
    assert len(read) == 52 == pint8.attach_qweights(pmodel, pq)
    assert sum(pq[p][0].numel() for p in read) == 123_731_968
    assert sorted(set(pq) - set(read)) == [
        "unet.downsample7.downsample.conv", "unet.downsample8.downsample.conv",
        "unet.upsample0.upsample", "unet.upsample1.upsample",
    ]


def omniconv_pair(kernel_size, stride, seed):
    jmod = jconv.OmniConv1d(out_channels=16, kernel_size=kernel_size, stride=stride)
    x = randn(rng(seed), 1, 20, 12)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    pmod = load(pconv.OmniConv1d(12, 16, kernel_size, stride=stride), params["params"])
    return jmod, params, pmod, x


def test_omniconv_runs_int8_when_attached():
    jmod, params, pmod, x = omniconv_pair(3, 1, 3)
    base = pmod(T(x))
    q = pint8.quantize_conv_params(pmod, min_weight_bytes=0, min_weight_bytes_k1=0)
    assert set(q) == {""} and pint8.attach_qweights(pmod, q) == 1
    with torch.no_grad():
        out = pmod(T(x))
    diff = (out - base).abs().max().item()
    assert 0 < diff < 5e-2  # the int8 path ran: close to, not equal to, fp32
    jq = jint8.quantize_conv_params(params, min_weight_bytes=0, min_weight_bytes_k1=0)
    ref = jmod.apply({"params": params["params"], "qweights": jq}, jnp.asarray(x))
    assert_rel(out, ref)
    pint8.clear_qweights(pmod)
    torch.testing.assert_close(pmod(T(x)), base, rtol=0, atol=0)


def test_strided_conv_ignores_qweights():
    _, _, pmod, x = omniconv_pair(5, 2, 4)
    base = pmod(T(x))
    q = pint8.quantize_conv_params(pmod, min_weight_bytes=0, min_weight_bytes_k1=0)
    assert set(q) == {""} and pint8.attach_qweights(pmod, q) == 0
    assert pmod.kernel8 is None
    torch.testing.assert_close(pmod(T(x)), base, rtol=0, atol=0)


def test_threshold_excludes_small_kernels():
    _, params, pmod, _ = omniconv_pair(3, 1, 5)
    assert pint8.quantize_conv_params(pmod) == {}
    assert jint8.quantize_conv_params(params) == {}


def test_qweights_stay_out_of_the_state_dict():
    _, _, pmod, _ = omniconv_pair(3, 1, 6)
    keys = set(pmod.state_dict())
    pint8.attach_qweights(pmod, pint8.quantize_conv_params(pmod, min_weight_bytes=0))
    assert set(pmod.state_dict()) == keys == {"weight", "bias"}


@pytest.fixture(scope="module")
def tiny_unets():
    jcfg, pcfg = flash_model_configs()
    mc = jcfg.model_config
    jmodel = jax_unet(mc)
    shapes = jax.eval_shape(lambda r: jmodel.init(
        r, jnp.zeros((1, 40, mc.in_channels)), jnp.zeros((1,)),
        embedding=jnp.zeros((1, mc.context_embedding_max_length,
                             mc.context_embedding_features)),
        channels_list=[jnp.zeros((1, 40, mc.context_channels[0]))],
    ), jax.random.PRNGKey(0))
    params = random_params(shapes, seed=7)
    jq = jint8.quantize_conv_params(params, min_weight_bytes=0, min_weight_bytes_k1=0)
    return jmodel, params, jq, load(port_unet(pcfg.model_config), params), mc


def test_jax_qweights_tree_loads(tiny_unets):
    """from_jax attaches a JAX qweights tree; it equals the port's own
    quantization of the same weights, entry by entry."""
    _, _, jq, pmodel, _ = tiny_unets
    own = pint8.quantize_conv_params(pmodel, min_weight_bytes=0, min_weight_bytes_k1=0)
    assert set(own) == flat_paths(jq)
    loaded = load_flax_qweights(pmodel, {"qweights": np_tree(jq)})
    assert loaded == sum(pint8.reads_qweights(pmodel.get_submodule(p)) for p in own) > 10
    for path, (w8, scale) in own.items():
        mod = pmodel.get_submodule(path)
        if pint8.reads_qweights(mod):
            torch.testing.assert_close(mod.kernel8, w8, rtol=0, atol=0)
            torch.testing.assert_close(mod.scale, scale, rtol=0, atol=0)
    pint8.clear_qweights(pmodel)


def test_quantized_unet_forward_matches_jax(tiny_unets):
    """UNetCFG1d with every conv quantized (batch CFG at scale 0.8, L = 64)
    against jmodel.apply({'params', 'qweights'})."""
    jmodel, params, jq, pmodel, mc = tiny_unets
    g = rng(11)
    b, length, m = 2, 64, mc.context_embedding_max_length
    x, t = randn(g, b, length, mc.in_channels), g.uniform(size=(b,)).astype(np.float32)
    emb = randn(g, b, m, mc.context_embedding_features)
    chans = randn(g, b, length, mc.context_channels[0])
    kw = dict(embedding_scale=0.8, batch_cfg=True)
    ref = jax.jit(lambda p, q: jmodel.apply({"params": p["params"], "qweights": q}, x, t, embedding=emb,
                                            channels_list=[chans], **kw))(params, jq)
    attached = pint8.attach_qweights(
        pmodel, pint8.quantize_conv_params(pmodel, min_weight_bytes=0, min_weight_bytes_k1=0))
    assert attached > 10
    with torch.no_grad():
        out = pmodel(T(x), T(t), embedding=T(emb), channels_list=[T(chans)], **kw)
        pint8.clear_qweights(pmodel)
        fp = pmodel(T(x), T(t), embedding=T(emb), channels_list=[T(chans)], **kw)
    assert_close(out, ref, **TREE_BAR)
    assert (out - fp).abs().max().item() > 0  # the int8 path ran
