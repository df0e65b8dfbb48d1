"""Port parity of Snake (`use_snake`): jen1_tpu_torch's `ops/snake.py`, the
Snake UNet, whole `generate()` requests and a train step against jen1_tpu
on the CPU, fp32, with the JAX weights carried over by ckpt/from_jax.py
(every `alpha` drawn from U(0.5, 1.5)).

Bars: `snake` fp32 rtol 1e-6 / atol 1e-6 (the same fp32 formula); bf16
within one bf16 step of JAX's (rtol 2^-7: both round the same fp32 value,
whose sin may differ in its last fp32 bit); plain forward rtol 2e-3 / atol
2e-4; CFG forward 5e-3 / 5e-4; whole generate() 2e-2 / 2e-3; the train
step at tests/test_torch_train.py's bars (losses rtol 2e-3, every gradient
leaf, the alphas' included, within 5e-3 of its max|g|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jen1_tpu.api.generation import cast_weights_bf16 as jax_cast_bf16
from jen1_tpu.models.unet import unet_from_model_config as jax_unet
from jen1_tpu.ops.snake import Snake1d as JSnake1d, snake as jax_snake
from jen1_tpu_torch.api.generation import cast_weights_bf16, latent_length
from jen1_tpu_torch.diffusion import vdm as port_vdm
from jen1_tpu_torch.models.unet import unet_from_model_config as port_unet
from jen1_tpu_torch.ops.snake import Snake1d, snake
from test_torch_train import jax_and_port_step
from torch_port_util import (
    TINY_CODEC, assert_close, gdm_draws, inject_gdm_draws, jen1_pair, load, one_torch_thread,
    randn, random_params, rng, tiny_model_configs, unet_shapes, vdm_initial_noise, with_alphas,
)

PLAIN = dict(rtol=2e-3, atol=2e-4)
CFG = dict(rtol=5e-3, atol=5e-4)
GENERATE = dict(rtol=2e-2, atol=2e-3)


def snake_configs():
    return tiny_model_configs(use_snake=True)


@pytest.fixture(scope="module")
def models():
    jcfg, pcfg = snake_configs()
    jmodel = jax_unet(jcfg.model_config)
    params = with_alphas(random_params(unet_shapes(jmodel, jcfg.model_config), seed=3))
    pmodel = load(port_unet(pcfg.model_config), params)
    return jcfg, pcfg, jmodel, params, pmodel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_snake_matches_jax(dtype):
    g = rng(0)
    x = 3.0 * randn(g, 2, 16, 8)
    alpha = g.uniform(0.05, 2.0, 8).astype(np.float32)
    ref = jax_snake(jnp.asarray(x, dtype), jnp.asarray(alpha))
    out = snake(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(alpha))
    assert out.dtype == getattr(torch, dtype) and str(ref.dtype) == dtype
    if dtype == "float32":
        assert_close(out, ref, rtol=1e-6, atol=1e-6)
    else:
        assert_close(out.float(), np.asarray(ref, np.float32), rtol=2**-7, atol=1e-6)


def test_snake1d_matches_jax():
    g = rng(1)
    x = randn(g, 2, 10, 6)
    module = Snake1d(6)
    module.init_parameters(None)
    assert torch.equal(module.alpha.detach(), torch.ones(6))
    jm = JSnake1d()
    jparams = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(jparams["params"]["alpha"]), np.ones(6))
    alpha = g.uniform(0.5, 1.5, 6).astype(np.float32)
    load(module, {"alpha": alpha})
    ref = jm.apply({"params": {"alpha": jnp.asarray(alpha)}}, jnp.asarray(x))
    with torch.no_grad():
        assert_close(module(torch.from_numpy(x)), ref, rtol=1e-6, atol=1e-6)


def test_every_conv_block_has_snake(models):
    """Each ConvBlock1d of the UNet runs Snake over its input channels, named
    as the flax submodule `snake`, so the JAX tree loads leaf for leaf."""
    _, _, _, params, pmodel = models
    alphas = [n for n, _ in pmodel.named_parameters() if n.endswith("snake.alpha")]
    blocks = [n for n, m in pmodel.named_modules() if type(m).__name__ == "ConvBlock1d"]
    assert len(alphas) == len(blocks) > 20

    def count(tree):
        return sum(count(v) if hasattr(v, "items") else k == "alpha" for k, v in tree.items())

    assert count(params) == len(alphas)


def forward_inputs(mc, b, length, seed):
    g = rng(seed)
    m = mc.context_embedding_max_length
    mask = np.ones((b, m), bool)
    mask[-1, m // 2:] = False
    return (randn(g, b, length, mc.in_channels), g.uniform(size=(b,)).astype(np.float32),
            randn(g, b, m, mc.context_embedding_features), mask,
            randn(g, b, length, mc.context_channels[0]))


@pytest.mark.parametrize("kw,bar", [({}, PLAIN),
                                    (dict(embedding_scale=3.0, batch_cfg=True, scale_cfg=True),
                                     CFG)], ids=["plain", "cfg"])
def test_snake_unet_forward_matches_jax(models, kw, bar):
    jcfg, _, jmodel, params, pmodel = models
    x, t, emb, mask, ch = forward_inputs(jcfg.model_config, 2, 64, seed=4)
    ref = jax.jit(lambda p: jmodel.apply(p, x, t, embedding=emb, embedding_mask=mask,
                                         channels_list=[ch], **kw))(params)
    with torch.no_grad():
        out = pmodel(torch.from_numpy(x), torch.from_numpy(t), embedding=torch.from_numpy(emb),
                     embedding_mask=torch.from_numpy(mask),
                     channels_list=[torch.from_numpy(ch)], **kw)
    assert_close(out, ref, **bar)


@pytest.fixture(scope="module")
def pair():
    with one_torch_thread():
        yield jen1_pair(configs=snake_configs(), param_fn=with_alphas)


@pytest.mark.parametrize("use_gdm", [False, True], ids=["vdm", "ddim"])
def test_snake_generate_matches_jax(pair, use_gdm, monkeypatch):
    """Whole text_guided requests, 2 s (80 latent frames), 2 steps, with
    JAX's draws injected."""
    jj, pj = pair
    seed, seconds, steps = 7, 2, 2
    frames = latent_length(seconds * 1600, 40)
    shape = (1, frames, jj.config.model_config.in_channels)
    if use_gdm:
        x_t, noises = gdm_draws(jax.random.fold_in(jax.random.key(seed), 2), shape,
                                range(steps))
        inject_gdm_draws(monkeypatch, x_t, noises)
    else:
        noise = torch.from_numpy(vdm_initial_noise(seed, shape))
        monkeypatch.setattr(port_vdm, "initial_noise", lambda shape, generator, device: noise)
    kw = dict(seed=seed, steps=steps, seconds=seconds, use_gdm=use_gdm)
    ref = jj.generate("a snake charmer's flute", **kw)
    with one_torch_thread():
        out = pj.generate("a snake charmer's flute", **kw)
    assert out.shape == ref.shape == (1, 2, seconds * TINY_CODEC["sample_rate"])
    assert np.isfinite(out).all()
    assert_close(out, ref, **GENERATE)


def test_snake_train_step_matches_jax(models):
    """One multi-task GDM step (text_guided causal): losses, grad norm and
    every gradient leaf against jax.value_and_grad; the alphas' gradients
    are finite and nonzero."""
    model, _ = jax_and_port_step(models, 1)
    grads = {n: p.grad for n, p in model.named_parameters() if n.endswith("snake.alpha")}
    assert grads and all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads.values())


def test_bf16_weights_keep_alpha_fp32(models):
    """cast_weights_bf16 leaves every alpha fp32, as the JAX cast does, and
    under bf16 compute the output equals fp32 storage's bit for bit."""
    jcfg, pcfg, _, params, pmodel = models
    jcast = jax_cast_bf16(jax.tree.map(jnp.asarray, params))
    model = port_unet(pcfg.model_config)
    model.load_state_dict(pmodel.state_dict())
    cast = cast_weights_bf16(model)
    assert cast and not any("alpha" in n for n in cast)
    for name, p in model.named_parameters():
        if name.endswith("snake.alpha"):
            assert p.dtype == torch.float32
    leaf = jcast["params"]["unet"]["to_in"]["block"]["block1"]["snake"]["alpha"]
    assert leaf.dtype == jnp.float32
    x, t, emb, mask, ch = forward_inputs(jcfg.model_config, 1, 32, seed=5)
    args = (torch.from_numpy(x).bfloat16(), torch.from_numpy(t))
    kw = dict(embedding=torch.from_numpy(emb).bfloat16(), embedding_mask=torch.from_numpy(mask),
              channels_list=[torch.from_numpy(ch).bfloat16()])
    with torch.no_grad():
        assert torch.equal(model(*args, **kw), pmodel(*args, **kw))
