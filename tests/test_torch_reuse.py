"""Port parity of the UNet encoder cache and of encoder reuse
(Faster-Diffusion encoder propagation) in the GDM samplers: jen1_tpu_torch
against jen1_tpu on the same tiny UNet weights and numpy inputs.

* UNetCFG1d with `return_encoder_cache=True`: the output and every cache
  leaf (the pre-bottleneck feature, the skips of levels 1..n), plain and
  batch-CFG, then a decoder-only forward against the cache; the refusal of
  a cache under CFG without batch_cfg. Bars: rtol 2e-3 / atol 2e-4 plain,
  5e-3 / 5e-4 CFG (L = 520, so the level-1 transformer's 130 frames take
  the flash path: Pallas in interpret mode, the port's plain version).
* `GaussianDiffusion.sample(encoder_reuse=k)`, DDIM and DPM-Solver++, k in
  {2, 3} x S in {5, 6} (S % k == 0 and not), with the JAX draws injected:
  the sampler-trajectory bar, rtol 2e-2 / atol 2e-3. The JAX samplers run
  with their `lax.scan`s as Python loops around a UNet jitted once per call
  signature (`python_scan`, `jitted_unet`): the same operations, without
  compiling k to 2k UNet copies for each case.
* A whole `Jen1.generate(use_gdm=True, encoder_reuse=2)` against JAX, at
  the same bar.
* A counting model checks which steps run whole and which decoder-only
  against `reuse_schedule` and the JAX schedule it encodes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jen1_tpu.config import GDMConfig as JGDMConfig
from jen1_tpu.diffusion.gdm import create_gaussian_diffusion as jax_gdm
from jen1_tpu.models.unet import unet_from_model_config as jax_unet
from jen1_tpu_torch.api.generation import latent_length
from jen1_tpu_torch.config import GDMConfig
from jen1_tpu_torch.diffusion import gdm as port_gdm
from jen1_tpu_torch.models.unet import unet_from_model_config as port_unet
from torch_port_util import (
    assert_close, flash_model_configs, gdm_draws, inject_gdm_draws, jen1_pair, load,
    one_torch_thread, randn, random_params, rng,
)

PLAIN = dict(rtol=2e-3, atol=2e-4)
CFG = dict(rtol=5e-3, atol=5e-4)
TRAJECTORY = dict(rtol=2e-2, atol=2e-3)
FORWARD_LENGTH = 520  # the level-1 transformer sees 130 frames: flash path
SAMPLER_LENGTH = 48


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: the port's side is small, and on a CPU
    shared by several test workers more threads only wait for each other."""
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def unets():
    jcfg, pcfg = flash_model_configs()
    mc = jcfg.model_config
    jmodel = jax_unet(mc)
    shapes = jax.eval_shape(lambda r: jmodel.init(
        r, jnp.zeros((1, 40, mc.in_channels)), jnp.zeros((1,)),
        embedding=jnp.zeros((1, mc.context_embedding_max_length,
                             mc.context_embedding_features)),
        channels_list=[jnp.zeros((1, 40, mc.context_channels[0]))],
    ), jax.random.PRNGKey(0))
    params = random_params(shapes, seed=3)
    return jmodel, params, load(port_unet(pcfg.model_config), params), mc


def forward_inputs(mc, b, length, seed):
    g = rng(seed)
    m = mc.context_embedding_max_length
    mask = np.ones((b, m), bool)
    mask[-1, m // 2:] = False
    return dict(
        x=randn(g, b, length, mc.in_channels),
        t=g.uniform(size=(b,)).astype(np.float32),
        embedding=randn(g, b, m, mc.context_embedding_features),
        embedding_mask=mask,
        channels_list=[randn(g, b, length, mc.context_channels[0])],
    )


def leaves(cache):
    """The cache's tensors in order: the pre-bottleneck feature, then each
    level's skips."""
    x, skips = cache
    return [x] + [s for level in skips for s in level]


CFG_KW = {"plain": dict(), "cfg": dict(embedding_scale=0.8, batch_cfg=True, scale_cfg=True)}


def run_jax(jmodel, params, inp, cache=None, **kw):
    x, t = inp["x"], inp["t"]
    rest = {k: v for k, v in inp.items() if k not in ("x", "t")}
    return jax.jit(lambda p, c: jmodel.apply(
        p, x, t, encoder_cache=c, return_encoder_cache=True, **rest, **kw,
    ))(params, cache)


def run_port(pmodel, inp, cache=None, **kw):
    tensors = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                   else [torch.from_numpy(c) for c in v]) for k, v in inp.items()}
    x, t = tensors.pop("x"), tensors.pop("t")
    with torch.no_grad():
        return pmodel(x, t, encoder_cache=cache, return_encoder_cache=True, **tensors, **kw)


@pytest.mark.parametrize("mode", ["plain", "cfg"])
def test_forward_cache_and_decoder_match_jax(unets, mode):
    """A whole forward with its cache, then a decoder-only forward at the
    next step's x and time against that cache: JAX and the port each decode
    against their own cache, and the port also against JAX's."""
    jmodel, params, pmodel, mc = unets
    bar = PLAIN if mode == "plain" else CFG
    first = forward_inputs(mc, 2, FORWARD_LENGTH, seed=1)
    ref, ref_cache = run_jax(jmodel, params, first, **CFG_KW[mode])
    out, cache = run_port(pmodel, first, **CFG_KW[mode])
    assert_close(out, ref, **bar)
    got, want = leaves(cache), leaves(ref_cache)
    # the pre-bottleneck feature, then one resnet skip per down level and the
    # transformer skips of the two levels with attention (tiny_test_config)
    assert len(got) == len(want) == 1 + 1 + 2 + 2
    for a, b in zip(got, want):
        # the CFG cache lives in the doubled batch
        assert a.shape == b.shape and a.shape[0] == (2 if mode == "plain" else 4)
        assert_close(a, b, **bar)

    nxt = dict(first, **{k: v for k, v in forward_inputs(mc, 2, FORWARD_LENGTH, seed=2).items()
                         if k in ("x", "t")})
    ref, _ = run_jax(jmodel, params, nxt, cache=ref_cache, **CFG_KW[mode])
    out, again = run_port(pmodel, nxt, cache=cache, **CFG_KW[mode])
    assert again is cache  # a decoder-only forward returns the cache it was given
    assert_close(out, ref, **bar)
    shared = jax.tree_util.tree_map(np.array, ref_cache)
    torch_shared = (torch.from_numpy(shared[0]),
                    tuple(tuple(torch.from_numpy(s) for s in lv) for lv in shared[1]))
    out_shared, _ = run_port(pmodel, nxt, cache=torch_shared, **CFG_KW[mode])
    assert_close(out_shared, ref, **bar)
    # a decoder-only forward is not the whole forward at the new x
    whole, _ = run_port(pmodel, nxt, **CFG_KW[mode])
    assert not torch.allclose(out, whole, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("kw", [dict(return_encoder_cache=True), dict(encoder_cache="set")])
def test_cache_under_cfg_without_batch_cfg_raises(unets, kw):
    _, _, pmodel, mc = unets
    inp = forward_inputs(mc, 1, SAMPLER_LENGTH, seed=1)
    if kw.get("encoder_cache") == "set":
        kw = dict(encoder_cache=run_port(pmodel, inp)[1])
    tensors = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                   else [torch.from_numpy(c) for c in v]) for k, v in inp.items()}
    x, t = tensors.pop("x"), tensors.pop("t")
    with pytest.raises(ValueError, match="batch_cfg=True"):
        pmodel(x, t, embedding_scale=0.8, batch_cfg=False, **tensors, **kw)


def sampler_cond(mc, seed=5):
    g = rng(seed)
    m = mc.context_embedding_max_length
    mask = np.ones((1, m), bool)
    mask[:, 4:] = False
    return dict(
        cross_attn_cond=randn(g, 1, m, mc.context_embedding_features),
        cross_attn_masks=mask,
        input_concat_cond=randn(g, 1, SAMPLER_LENGTH, mc.context_channels[0]),
    )


def diffusions(steps, timesteps=12):
    kw = dict(noise_schedule="cosine", steps=timesteps)
    return (jax_gdm(dataclasses.replace(JGDMConfig(), **kw), sampling_steps=steps),
            port_gdm.create_gaussian_diffusion(dataclasses.replace(GDMConfig(), **kw),
                                               sampling_steps=steps))


def python_scan(f, init, xs):
    """`jax.lax.scan` by its definition, a loop over the leading axis, so
    that the block bodies of the JAX reuse samplers call a jitted UNet
    instead of compiling k to 2k copies of it for every (k, S, mode)."""
    carry, ys = init, []
    for i in range(xs.shape[0]):
        carry, y = f(carry, xs[i])
        ys.append(y)
    return carry, jnp.stack(ys)


@pytest.fixture(scope="module")
def jitted_unet(unets):
    """The JAX UNet's apply, jitted once per call signature (a whole forward
    returning its cache, a decoder-only one) for every sampler case."""
    jmodel, params, _, _ = unets
    return jax.jit(
        lambda x, t, **kw: jmodel.apply(params, x, t, **kw),
        static_argnames=("embedding_scale", "embedding_mask_proba", "batch_cfg",
                         "scale_cfg", "causal", "return_encoder_cache"))


@pytest.mark.parametrize("steps", [5, 6])
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("mode", ["scan", "dpm++"])
def test_sampler_with_encoder_reuse_matches_jax(unets, jitted_unet, monkeypatch, mode, k,
                                                steps):
    _, _, pmodel, mc = unets
    cond = sampler_cond(mc)
    shape = (1, SAMPLER_LENGTH, mc.in_channels)
    jdiff, pdiff = diffusions(steps)
    key = jax.random.key(23)
    with monkeypatch.context() as patch:
        patch.setattr(jax.lax, "scan", python_scan)
        ref = np.asarray(jdiff.sample(jitted_unet, shape, cond, key, mode=mode,
                                      encoder_reuse=k))
    x_t, noises = gdm_draws(key, shape, range(steps))
    inject_gdm_draws(monkeypatch, x_t, noises)
    out = pdiff.sample(lambda x, t, **kw: pmodel(x, t, **kw), shape,
                       {n: torch.from_numpy(v) for n, v in cond.items()},
                       torch.Generator().manual_seed(0), device="cpu", mode=mode,
                       encoder_reuse=k)
    assert out.shape == shape and torch.isfinite(out).all()
    assert_close(out, ref, **TRAJECTORY)


class CountingModel:
    """A model_fn that records, per call, whether it was whole or
    decoder-only, and returns (zeros, a token cache)."""

    def __init__(self):
        self.calls = []

    def __call__(self, x, t, *, encoder_cache=None, return_encoder_cache=False, **kw):
        assert return_encoder_cache
        self.calls.append(encoder_cache is None)
        return torch.zeros_like(x), (encoder_cache or ("cache", len(self.calls)))


def jax_schedule(steps, k, final_full):
    """Whole (True) or decoder-only per step, as the JAX block scans walk
    them (gdm.py:357-412 for DDIM, dpm_solver.py:90-133)."""
    n_blocks, tail = divmod(steps, k)
    if final_full and tail == 0 and n_blocks > 0:
        n_blocks, tail = n_blocks - 1, k
    calls = [j == 0 for _ in range(n_blocks) for j in range(k)]
    for r in range(tail):
        last = n_blocks * k + r == steps - 1
        calls.append((r % k == 0 or last) if final_full else True)
    return calls


@pytest.mark.parametrize("steps", [1, 5, 6, 7, 100])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("mode", ["scan", "dpm++"])
def test_reuse_schedule_counts_whole_and_decoder_calls(mode, k, steps):
    _, pdiff = diffusions(steps, timesteps=1000)
    want = jax_schedule(steps, k, final_full=mode == "scan")
    assert port_gdm.reuse_schedule(steps, k, final_full=mode == "scan") == want
    if k == 1:
        return
    model = CountingModel()
    pdiff.sample(model, (1, 4, 2), {"cross_attn_cond": torch.zeros(1, 1, 1)},
                 torch.Generator().manual_seed(0), device="cpu", mode=mode, encoder_reuse=k)
    assert model.calls == want
    if (mode, k, steps) == ("scan", 2, 100):
        assert (sum(want), len(want) - sum(want)) == (51, 49)  # 2 * 51 + 49 = 151 K1
    if (mode, k, steps) == ("dpm++", 2, 100):
        assert (sum(want), len(want) - sum(want)) == (50, 50)  # 150 K1


@pytest.mark.parametrize("kw,match", [
    (dict(mode="stepwise"), "requires mode='scan' or 'dpm\\+\\+'"),
    (dict(sampling=None), "implemented for DDIM sampling"),
    (dict(return_all_timesteps=True), "does not support return_all_timesteps"),
])
def test_encoder_reuse_refusals_match_jax(unets, kw, match):
    """The JAX package's ValueErrors: reuse needs DDIM, mode 'scan' or
    'dpm++', and no return_all_timesteps (DDPM walks all 12 timesteps)."""
    jmodel, params, pmodel, mc = unets
    kw = dict(kw)
    sampling = kw.pop("sampling", 4)
    jdiff, pdiff = diffusions(sampling)
    shape = (1, SAMPLER_LENGTH, mc.in_channels)
    cond = sampler_cond(mc)
    with pytest.raises(ValueError, match=match):
        jdiff.sample(lambda x, t, **a: jmodel.apply(params, x, t, **a), shape, cond,
                     jax.random.key(0), encoder_reuse=2, **kw)
    with pytest.raises(ValueError, match=match):
        pdiff.sample(lambda x, t, **a: pmodel(x, t, **a), shape,
                     {n: torch.from_numpy(v) for n, v in cond.items()},
                     torch.Generator().manual_seed(0), device="cpu", encoder_reuse=2, **kw)


def test_return_all_timesteps_matches_jax(unets, jitted_unet, monkeypatch):
    """DDIM's trajectory (x_T and each step) against JAX's."""
    _, _, pmodel, mc = unets
    cond = sampler_cond(mc)
    shape = (1, SAMPLER_LENGTH, mc.in_channels)
    jdiff, pdiff = diffusions(3)
    key = jax.random.key(29)
    with monkeypatch.context() as patch:
        patch.setattr(jax.lax, "scan", python_scan)
        ref = np.asarray(jdiff.sample(jitted_unet, shape, cond, key,
                                      return_all_timesteps=True))
    x_t, noises = gdm_draws(key, shape, range(3))
    inject_gdm_draws(monkeypatch, x_t, noises)
    out = pdiff.sample(lambda x, t, **kw: pmodel(x, t, **kw), shape,
                       {n: torch.from_numpy(v) for n, v in cond.items()},
                       torch.Generator().manual_seed(0), device="cpu",
                       return_all_timesteps=True)
    assert out.shape == (4, *shape)
    assert_close(out, ref, **TRAJECTORY)


@pytest.fixture(scope="module")
def pair():
    return jen1_pair()


def test_generate_with_encoder_reuse_matches_jax(pair, monkeypatch):
    """The whole request, 13 s (520 latent frames, the flash path), 3 DDIM
    steps of 8 at k = 2: whole, decoder-only, whole (the last step)."""
    jj, pj = pair
    seed, prompt, steps, seconds = 6, "a beautiful song", 3, 13
    ref = jj.generate(prompt, seed=seed, steps=steps, seconds=seconds, use_gdm=True,
                      encoder_reuse=2)
    frames = latent_length(seconds * 1600, 40)
    x_t, noises = gdm_draws(jax.random.fold_in(jax.random.key(seed), 2), (1, frames, 8),
                            range(steps))
    inject_gdm_draws(monkeypatch, x_t, noises)
    out = pj.generate(prompt, seed=seed, steps=steps, seconds=seconds, use_gdm=True,
                      encoder_reuse=2)
    plain = pj.generate(prompt, seed=seed, steps=steps, seconds=seconds, use_gdm=True)
    assert out.shape == ref.shape == (1, 2, seconds * 1600)
    assert np.isfinite(out).all()
    assert_close(out, ref, **TRAJECTORY)
    assert not np.allclose(out, plain, rtol=1e-3, atol=1e-4)
