"""Port parity: jen1_tpu_torch UNetCFG1d vs jen1_tpu UNetCFG1d at
tiny_test_config() widths, with use_flash_attention=True and
flash_min_seq_len=128 so both packages take their flash path where a
transformer level sees N >= 128 (L = 520 -> 130 frames at L/4; JAX runs
the Pallas kernel in interpret mode, the port its plain version).

Bars (tests/test_reference_parity.py:128-145): rtol 2e-3 / atol 2e-4 for
the plain forward, rtol 5e-3 / atol 5e-4 for the CFG paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jen1_tpu.models.unet import unet_from_model_config as jax_unet
from jen1_tpu_torch.models.unet import unet_from_model_config as port_unet
from jen1_tpu_torch.ops import flash_attention as port_fa
from torch_port_util import (
    assert_close, flash_model_configs, load, randn, random_params, rng,
)

PLAIN = dict(rtol=2e-3, atol=2e-4)
CFG = dict(rtol=5e-3, atol=5e-4)


@pytest.fixture(scope="module")
def models():
    jcfg, pcfg = flash_model_configs()
    jmodel = jax_unet(jcfg.model_config)
    mc = jcfg.model_config
    shapes = jax.eval_shape(lambda r: jmodel.init(
        r,
        jnp.zeros((1, 40, mc.in_channels)),
        jnp.zeros((1,)),
        embedding=jnp.zeros((1, mc.context_embedding_max_length,
                             mc.context_embedding_features)),
        embedding_mask=jnp.ones((1, mc.context_embedding_max_length), bool),
        channels_list=[jnp.zeros((1, 40, mc.context_channels[0]))],
    ), jax.random.PRNGKey(0))
    params = random_params(shapes, seed=0)
    pmodel = load(port_unet(pcfg.model_config), params)
    return jmodel, params, pmodel, mc


_JITTED = {}


def inputs(mc, b, length, seed):
    g = rng(seed)
    m = mc.context_embedding_max_length
    mask = np.ones((b, m), bool)
    mask[-1, m // 2:] = False
    return dict(
        x=randn(g, b, length, mc.in_channels),
        t=g.uniform(size=(b,)).astype(np.float32),
        embedding=randn(g, b, m, mc.context_embedding_features),
        embedding_mask=mask,
        channels=randn(g, b, length, mc.context_channels[0]),
    )


def run_both(models, inp, **kw):
    jmodel, params, pmodel, _ = models
    key = tuple(sorted(kw.items()))
    if key not in _JITTED:
        _JITTED[key] = jax.jit(lambda p, x, t, e, m, c: jmodel.apply(
            p, x, t, embedding=e, embedding_mask=m, channels_list=[c], **kw))
    fn = _JITTED[key]
    ref = fn(params, inp["x"], inp["t"], inp["embedding"], inp["embedding_mask"],
             inp["channels"])
    with torch.no_grad():
        out = pmodel(
            torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"]),
            embedding=torch.from_numpy(inp["embedding"]),
            embedding_mask=torch.from_numpy(inp["embedding_mask"]),
            channels_list=[torch.from_numpy(inp["channels"])], **kw,
        )
    return out, np.asarray(ref)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward(models, causal):
    out, ref = run_both(models, inputs(models[3], 2, 520, 1), causal=causal)
    assert out.shape == ref.shape == (2, 520, 8)
    assert_close(out, ref, **PLAIN)


@pytest.mark.parametrize(
    "causal,batch_cfg,scale_cfg",
    [(False, True, True), (True, True, True), (False, False, True), (True, False, False)],
)
def test_cfg_forward(models, causal, batch_cfg, scale_cfg):
    """Batch-CFG (one doubled forward) and two-forward CFG, with and
    without the std rescale."""
    out, ref = run_both(
        models, inputs(models[3], 2, 520, 2), causal=causal,
        embedding_scale=0.8, batch_cfg=batch_cfg, scale_cfg=scale_cfg,
    )
    assert_close(out, ref, **CFG)


def test_length_not_divisible_by_factors(models):
    """L = 40 with a factor product of 8 exercises the centre crops."""
    out, ref = run_both(models, inputs(models[3], 2, 40, 4),
                        embedding_scale=0.8, batch_cfg=True, scale_cfg=True)
    assert out.shape == (2, 40, 8)
    assert_close(out, ref, **CFG)


def test_flash_path_engaged_on_cpu(models, monkeypatch):
    """At L = 520 the level-1 transformer goes through the flash dispatcher,
    which on a CPU tensor takes the plain version and launches nothing."""
    calls = []
    orig = port_fa.flash_attention_reference

    def spy(q, k, v, causal=False):
        calls.append(tuple(q.shape))
        return orig(q, k, v, causal)

    monkeypatch.setattr(port_fa, "flash_attention_reference", spy)
    before = port_fa.LAUNCHES
    run_both(models, inputs(models[3], 2, 520, 5), causal=False,
             embedding_scale=0.8, batch_cfg=True, scale_cfg=True)
    assert (4, 2, 130, 8) in calls
    assert port_fa.LAUNCHES == before
