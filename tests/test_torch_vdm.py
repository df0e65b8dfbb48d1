"""Port parity: the VDM v-space sampler trajectory. The same tiny UNet
weights drive jen1_tpu's `VDM.p_sample_loop` (one lax.scan) and
jen1_tpu_torch's Python loop; the port's initial noise is replaced by the
JAX stream rebuilt on the host (fold_in(key(seed), 2), split, normal), so
both start from the same x_T. Bar: rtol 2e-2 / atol 2e-3 for a sampler
trajectory (tests/test_reference_parity.py:280).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jen1_tpu.diffusion.vdm import create_variational_diffusion as jax_vdm
from jen1_tpu.models.unet import unet_from_model_config as jax_unet
from jen1_tpu_torch.diffusion import vdm as port_vdm
from jen1_tpu_torch.models.unet import unet_from_model_config as port_unet
from torch_port_util import (
    assert_close, flash_model_configs, load, randn, random_params, rng, vdm_initial_noise,
)


def test_alpha_sigma_matches():
    from jen1_tpu.diffusion.vdm import alpha_sigma as jax_alpha_sigma

    t = np.linspace(1.0, 0.0, 11, dtype=np.float32)
    for a, b in zip(port_vdm.alpha_sigma(torch.from_numpy(t)), jax_alpha_sigma(jnp.asarray(t))):
        assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [3, 8])
def test_trajectory_matches_jax(seed, monkeypatch):
    run_trajectory(seed, monkeypatch)


def test_trajectory_with_dropout_during_sampling_matches_jax(monkeypatch):
    """VDM(dropout_during_sampling=True) (jen1_tpu/diffusion/vdm.py:48, 179):
    every step's UNet call keeps CFG dropout; the port draws its bits from
    the request's generator, replaced here by JAX's bernoulli(fold_in(
    rng_loop, i)) bits, which drop some examples' prompts at some steps."""
    run_trajectory(2, monkeypatch, dropout=True)


def run_trajectory(seed, monkeypatch, dropout=False):
    jcfg, pcfg = flash_model_configs()
    mc = jcfg.model_config
    jmodel = jax_unet(mc)
    b, length, m = (2 if dropout else 1), 64, mc.context_embedding_max_length
    shapes = jax.eval_shape(lambda r: jmodel.init(
        r, jnp.zeros((b, length, mc.in_channels)), jnp.zeros((b,)),
        embedding=jnp.zeros((b, m, mc.context_embedding_features)),
        channels_list=[jnp.zeros((b, length, mc.context_channels[0]))],
    ), jax.random.PRNGKey(0))
    params = random_params(shapes, seed=seed)
    pmodel = load(port_unet(pcfg.model_config), params)

    g = rng(seed)
    mask = np.ones((b, m), bool)
    mask[:, 4:] = False
    cond = dict(
        cross_attn_cond=randn(g, b, m, mc.context_embedding_features),
        cross_attn_masks=mask,
        input_concat_cond=randn(g, b, length, mc.context_channels[0]),
    )
    shape = (b, length, mc.in_channels)
    steps = 3

    jdiff = jax_vdm(jcfg.diffusion_config.variational_diffusion)
    key = jax.random.fold_in(jax.random.key(seed), 2)
    if dropout:
        from jen1_tpu_torch.models import unet as port_unet_module

        proba = 0.5
        jdiff.dropout_during_sampling, jdiff.cfg_dropout_proba = True, proba
        rng_loop = jax.random.split(key)[1]
        bits = [torch.from_numpy(np.array(jax.random.bernoulli(
            jax.random.fold_in(rng_loop, i), proba, (b, 1, 1)))) for i in range(steps)]
        assert 0 < sum(int(x.sum()) for x in bits) < b * steps
        drawn = iter(bits)
        monkeypatch.setattr(port_unet_module, "rand_bool",
                            lambda generator, shape, p, device: next(drawn))
    ref = jax.jit(lambda p, c: jdiff.p_sample_loop(
        lambda x, t, **kw: jmodel.apply(p, x, t, **kw), shape, c, key, step=steps,
    ))(params, cond)

    noise = torch.from_numpy(vdm_initial_noise(seed, shape))
    monkeypatch.setattr(port_vdm, "initial_noise", lambda shape, generator, device: noise)
    pdiff = port_vdm.create_variational_diffusion(pcfg.diffusion_config.variational_diffusion)
    if dropout:
        pdiff.dropout_during_sampling, pdiff.cfg_dropout_proba = True, proba
    out = pdiff.p_sample_loop(
        lambda x, t, **kw: pmodel(x, t, **kw), shape,
        {k: torch.from_numpy(v) for k, v in cond.items()},
        torch.Generator().manual_seed(seed), device="cpu", step=steps,
    )
    assert out.shape == shape
    assert_close(out, ref, rtol=2e-2, atol=2e-3)
    if dropout:
        assert next(drawn, None) is None  # one draw per step, all used
