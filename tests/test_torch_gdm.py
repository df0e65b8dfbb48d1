"""Port parity of the GDM samplers: jen1_tpu_torch's DDIM, DDPM and
DPM-Solver++(2M) loops against jen1_tpu's `GaussianDiffusion.sample` (one
lax.scan each), driven by the same tiny UNet weights with batch CFG at
scale 0.8 and scale_cfg on (the GDMConfig defaults). The port's x_T and
step noise are replaced by the JAX streams rebuilt on the host
(`torch_port_util.gdm_draws`), so both walk the same trajectory. Bar: rtol
2e-2 / atol 2e-3, the sampler-trajectory bar; the schedule helpers are
compared at 1e-5 (the same fp32 formulas).
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
from jen1_tpu_torch.config import GDMConfig
from jen1_tpu_torch.diffusion import gdm as port_gdm
from jen1_tpu_torch.models.unet import unet_from_model_config as port_unet
from torch_port_util import (
    assert_close, flash_model_configs, gdm_draws, inject_gdm_draws, load, randn,
    random_params, rng,
)

BAR = dict(rtol=2e-2, atol=2e-3)
B, LENGTH = 1, 48
# (name, GDMConfig overrides, sampling steps, mode): DDIM is any sampling
# count below the timesteps; DDPM walks all of them
CASES = [
    ("ddim_eta1", dict(steps=8), 3, "scan"),
    ("ddim_eta0", dict(steps=8, ddim_sampling_eta=0.0), 3, "scan"),
    ("ddpm", dict(steps=10), None, "scan"),
    ("dpm++", dict(steps=8), 4, "dpm++"),
]


def configs(overrides):
    kw = dict(noise_schedule="cosine", **overrides)
    return dataclasses.replace(JGDMConfig(), **kw), dataclasses.replace(GDMConfig(), **kw)


@pytest.fixture(scope="module")
def unets():
    jcfg, pcfg = flash_model_configs()
    mc = jcfg.model_config
    jmodel = jax_unet(mc)
    m = mc.context_embedding_max_length
    shapes = jax.eval_shape(lambda r: jmodel.init(
        r, jnp.zeros((B, LENGTH, mc.in_channels)), jnp.zeros((B,)),
        embedding=jnp.zeros((B, m, mc.context_embedding_features)),
        channels_list=[jnp.zeros((B, LENGTH, mc.context_channels[0]))],
    ), jax.random.PRNGKey(0))
    params = random_params(shapes, seed=5)
    pmodel = load(port_unet(pcfg.model_config), params)
    g = rng(5)
    mask = np.ones((B, m), bool)
    mask[:, 4:] = False
    cond = dict(
        cross_attn_cond=randn(g, B, m, mc.context_embedding_features),
        cross_attn_masks=mask,
        input_concat_cond=randn(g, B, LENGTH, mc.context_channels[0]),
    )
    return jmodel, params, pmodel, cond, (B, LENGTH, mc.in_channels)


def port_cond(cond):
    return {k: torch.from_numpy(v) for k, v in cond.items()}


@pytest.mark.parametrize("name,overrides,sampling,mode", CASES, ids=[c[0] for c in CASES])
def test_trajectory_matches_jax(unets, monkeypatch, name, overrides, sampling, mode):
    jmodel, params, pmodel, cond, shape = unets
    jconf, pconf = configs(overrides)
    jdiff = jax_gdm(jconf, sampling_steps=sampling)
    pdiff = port_gdm.create_gaussian_diffusion(pconf, sampling_steps=sampling)
    assert pdiff.is_ddim_sampling == jdiff.is_ddim_sampling == (name != "ddpm")
    key = jax.random.key(17)
    ref = jax.jit(lambda p, c: jdiff.sample(
        lambda x, t, **kw: jmodel.apply(p, x, t, **kw), shape, c, key, mode=mode,
    ))(params, cond)

    steps = pdiff.sampling_timesteps
    # DDIM folds the step index into the loop key, DDPM the timestep
    folds = list(range(steps)) if name != "ddpm" else list(range(steps - 1, -1, -1))
    x_t, noises = gdm_draws(key, shape, folds)
    inject_gdm_draws(monkeypatch, x_t, noises)
    out = pdiff.sample(lambda x, t, **kw: pmodel(x, t, **kw), shape, port_cond(cond),
                       torch.Generator().manual_seed(0), device="cpu", mode=mode)
    assert out.shape == shape and torch.isfinite(out).all()
    assert_close(out, ref, **BAR)


def test_stepwise_is_the_scan_loop(unets):
    """DDIM's 'stepwise' (the host writes each step's index into the
    sampler's static input) and 'scan' (the step advances it on the device)
    give equal results, as the JAX package's two modes do."""
    _, _, pmodel, cond, shape = unets
    _, pconf = configs(dict(steps=8))
    pdiff = port_gdm.create_gaussian_diffusion(pconf, sampling_steps=2)
    outs = [pdiff.sample(lambda x, t, **kw: pmodel(x, t, **kw), shape, port_cond(cond),
                         torch.Generator().manual_seed(3), device="cpu", mode=mode)
            for mode in ("scan", "stepwise")]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_unported_and_invalid_modes_raise():
    """encoder_reuse is refused where JAX refuses it (stepwise mode, DDPM),
    with JAX's ValueErrors, as is an unknown mode."""
    _, pconf = configs(dict(steps=8))
    pdiff = port_gdm.create_gaussian_diffusion(pconf, sampling_steps=2)
    with pytest.raises(ValueError, match="requires mode='scan' or 'dpm\\+\\+'"):
        pdiff.sample(None, (1, 4, 2), {}, None, device="cpu", mode="stepwise",
                     encoder_reuse=2)
    ddpm = port_gdm.create_gaussian_diffusion(pconf, sampling_steps=8)
    with pytest.raises(ValueError, match="implemented for DDIM sampling"):
        ddpm.sample(None, (1, 4, 2), {}, None, device="cpu", encoder_reuse=2)
    with pytest.raises(ValueError):
        pdiff.sample(None, (1, 4, 2), {}, None, device="cpu", mode="euler")


@pytest.mark.parametrize("objective", ["noise", "x0", "v"])
def test_prediction_helpers_match_jax(objective):
    jconf, pconf = configs(dict(steps=8, objective=objective))
    jdiff, pdiff = jax_gdm(jconf, 3), port_gdm.create_gaussian_diffusion(pconf, 3)
    g = rng(1)
    x, out, x0 = randn(g, 2, 5, 3), randn(g, 2, 5, 3), randn(g, 2, 5, 3)
    t = np.array([7, 2], np.int32)
    tt = torch.from_numpy(t).long()
    T = torch.from_numpy
    for clip in (False, True):
        for a, b in zip(pdiff._predictions_from_out(T(out), T(x), tt, clip),
                        jdiff._predictions_from_out(jnp.asarray(out), x, t, clip)):
            assert_close(a, b, rtol=1e-5, atol=1e-6)
    for a, b in zip(pdiff.q_posterior(T(x0), T(x), tt), jdiff.q_posterior(x0, x, t)):
        assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert_close(pdiff.predict_start_from_v(T(x), tt, T(out)),
                 jdiff.predict_start_from_v(x, t, out), rtol=1e-6, atol=1e-6)

