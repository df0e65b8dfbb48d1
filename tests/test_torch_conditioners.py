"""Port parity of the int and number conditioners, the multi-conditioner
and global conditioning (`context_features`) against jen1_tpu on the CPU.

Weights come over from the JAX conditioners through ckpt/from_jax.py.
Bars: int embeddings equal exactly (a table lookup); number embeddings
rtol 1e-5 / atol 1e-5 (fp32 sin and cos of the same arguments); the
UNetCFG1d with global features at the CFG bar, rtol 5e-3 / atol 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jen1_tpu.conditioning import conditioners as jcond
from jen1_tpu.config import ConditionerConfig as JCondConfig, IntConfig as JInt
from jen1_tpu.config import NumberConfig as JNumber, T5Config as JT5
from jen1_tpu.models.unet import unet_from_model_config as jax_unet
from jen1_tpu.ops.embeddings import NumberEmbedder as JNumberEmbedder
from jen1_tpu_torch.api.generation import Jen1
from jen1_tpu_torch.conditioning import conditioners as pcond
from jen1_tpu_torch.config import ConditionerConfig, IntConfig, NumberConfig, T5Config
from jen1_tpu_torch.models.unet import unet_from_model_config as port_unet
from jen1_tpu_torch.ops.embeddings import NumberEmbedder
from torch_port_util import (
    assert_close, load, randn, random_params, rng, tiny_model_configs,
)

NUMBER = dict(rtol=1e-5, atol=1e-5)
CFG = dict(rtol=5e-3, atol=5e-4)


def test_int_conditioner_matches_jax():
    jc = jcond.IntConditioner(output_dim=8, min_val=-3, max_val=10)
    pc = load(pcond.IntConditioner(8, -3, 10, device="cpu"), jc.params)
    ints = [-7, -3, 0, 5, 10, 99]  # -7 clamps to -3, 99 to 10
    ref, ref_mask = jc(ints)
    emb, mask = pc(ints)
    assert emb.shape == (6, 1, 8) and mask.shape == (6, 1) and mask.dtype == torch.float32
    np.testing.assert_array_equal(emb.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    assert torch.equal(emb[0], emb[1]) and torch.equal(emb[4], emb[5])


def test_number_embedder_matches_jax():
    x = rng(0).uniform(-2.0, 2.0, (3, 4)).astype(np.float32)
    jm = JNumberEmbedder(features=12)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1,)))
    pm = load(NumberEmbedder(12), params)
    ref = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    assert out.shape == ref.shape == (3, 4, 12)
    assert_close(out, ref, **NUMBER)


def test_number_conditioner_matches_jax():
    jc = jcond.NumberConditioner(output_dim=8, min_val=5.0, max_val=100.0)
    pc = pcond.NumberConditioner(8, 5.0, 100.0, device="cpu")
    load(pc.embedder, jc.params)
    floats = [-3.0, 5.0, 50.5, 100.0, 250.0]  # clamped to [5, 100]
    ref, ref_mask = jc(floats)
    emb, mask = pc(floats)
    assert emb.shape == (5, 1, 8)
    assert_close(emb, ref, **NUMBER)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    assert torch.equal(emb[0], emb[1]) and torch.equal(emb[3], emb[4])


def configs():
    kw = dict(cond_dim=16, conditioning_type=("t5", "int", "number"),
              default_keys={"seconds_total": "duration"})
    jcfg = JCondConfig(t5_config=JT5(t5_model_name="tiny-test", max_length=8),
                       int_config=JInt(max_val=16), number_config=JNumber(max_val=100), **kw)
    pcfg = ConditionerConfig(t5_config=T5Config(t5_model_name="tiny-test", max_length=8),
                             int_config=IntConfig(max_val=16),
                             number_config=NumberConfig(max_val=100), **kw)
    return jcfg, pcfg


@pytest.fixture(scope="module")
def multi():
    """create_multi_conditioner of all three types in both packages, the
    port's holding the JAX weights."""
    jcfg, pcfg = configs()
    jm = jcond.create_multi_conditioner(jcfg)
    pm = pcond.create_multi_conditioner(pcfg, device="cpu")
    assert list(pm.conditioners) == list(jm.conditioners) == [
        "prompt", "seconds_start", "seconds_total"]
    assert isinstance(pm.conditioners["seconds_start"], pcond.IntConditioner)
    assert isinstance(pm.conditioners["seconds_total"], pcond.NumberConditioner)
    assert pm.fill_values == jm.fill_values == {"seconds_start": 0, "seconds_total": 0}
    t5 = jm.conditioners["prompt"]
    load(pm.conditioners["prompt"], {"encoder": t5.params["encoder"], "proj": t5.params["proj"]})
    load(pm.conditioners["seconds_start"], jm.conditioners["seconds_start"].params)
    load(pm.conditioners["seconds_total"].embedder, jm.conditioners["seconds_total"].params)
    return jm, pm


@pytest.mark.parametrize("metadata", [
    [{"prompt": "a song", "seconds_start": 3, "seconds_total": 60.0},
     {"prompt": ["wrapped"], "seconds_start": [1], "seconds_total": 30.0}],
    [{"prompt": "a song"}, {"prompt": "", "seconds_start": 40}],  # fills; 40 clamps to 16
    [{"prompt": "x", "duration": 12.5}, {"prompt": "y", "seconds_total": 7.0}],  # default key
], ids=["explicit", "fill", "default-key"])
def test_multi_conditioner_matches_jax(multi, metadata):
    jm, pm = multi
    ref, out = jm(metadata), pm(metadata)
    assert set(out) == set(ref)
    for key in ref:
        assert out[key][0].shape == tuple(ref[key][0].shape)
        assert_close(out[key][0], ref[key][0], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(out[key][1].numpy(), np.asarray(ref[key][1]))


def test_fill_equals_min_val_and_missing_key_raises(multi):
    _, pm = multi
    filled = pm([{"prompt": "a"}])
    explicit = pm([{"prompt": "a", "seconds_start": 0, "seconds_total": 0.0}])
    for key in ("seconds_start", "seconds_total"):
        assert torch.equal(filled[key][0], explicit[key][0])
    with pytest.raises(ValueError, match="prompt not found in metadata"):
        pm([{"seconds_start": 1}])
    with pytest.raises(ValueError, match="no fill value"):
        pcond.MultiConditioner({"seconds_start": pm.conditioners["seconds_start"]})([{}])


def test_global_features_unet_matches_jax(multi):
    """A tiny UNetCFG1d with context_features = 2 x cond_dim, its features
    the int and number embeddings assembled as global conditioning, under
    batch CFG."""
    jm, pm = multi
    jcfg, pcfg = tiny_model_configs(context_features=32)
    mc = jcfg.model_config
    jmodel = jax_unet(mc)
    m, length = mc.context_embedding_max_length, 48
    shapes = jax.eval_shape(lambda r: jmodel.init(
        r, jnp.zeros((1, length, mc.in_channels)), jnp.zeros((1,)),
        embedding=jnp.zeros((1, m, mc.context_embedding_features)),
        features=jnp.zeros((1, 32)),
        channels_list=[jnp.zeros((1, length, mc.context_channels[0]))]), jax.random.PRNGKey(0))
    params = random_params(shapes, seed=4)
    pmodel = load(port_unet(pcfg.model_config), params)
    assert pmodel.unet.to_features.weight.shape == (mc.channels * 4, 32)

    metadata = [{"prompt": "a", "seconds_start": 2, "seconds_total": 30.0},
                {"prompt": "b", "seconds_start": 9, "seconds_total": 95.0}]
    ids = dict(cross_attn_cond_ids=(), global_cond_ids=("seconds_start", "seconds_total"),
               input_concat_ids=())
    feats = np.asarray(jcond.assemble_conditioning(jm(metadata), **ids)["global_cond"])
    pfeats = pcond.assemble_conditioning(pm(metadata), **ids)["global_cond"]
    assert pfeats.shape == feats.shape == (2, 32)
    assert_close(pfeats, feats, **NUMBER)

    g = rng(5)
    x = randn(g, 2, length, mc.in_channels)
    t = g.uniform(size=(2,)).astype(np.float32)
    emb = randn(g, 2, m, mc.context_embedding_features)
    ch = randn(g, 2, length, mc.context_channels[0])
    kw = dict(embedding_scale=2.5, batch_cfg=True, scale_cfg=True)
    ref = jax.jit(lambda p: jmodel.apply(p, x, t, embedding=emb, features=feats,
                                         channels_list=[ch], **kw))(params)
    with torch.no_grad():
        out = pmodel(torch.from_numpy(x), torch.from_numpy(t), embedding=torch.from_numpy(emb),
                     features=torch.from_numpy(feats), channels_list=[torch.from_numpy(ch)],
                     **kw)
    assert_close(out, ref, **CFG)


def test_jen1_global_features_need_a_checkpoint():
    """jen1_tpu's Jen1 initialises random weights without global features
    and fails; the port refuses such a random model up front."""
    _, pcfg = tiny_model_configs(context_features=32)
    with pytest.raises(ValueError, match="context_features.*needs ckpt_path"):
        Jen1(config=pcfg, global_cond_ids=("seconds_start", "seconds_total"), device="cpu")
