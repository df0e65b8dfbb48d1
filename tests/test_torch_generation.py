"""Port parity of the whole slice: jen1_tpu_torch `Jen1.generate` vs
jen1_tpu `Jen1.generate`, text_guided, VDM, chunked decode.

The fixture is tests/test_api.py's tiny model and codec with the flash path
engaged (use_flash_attention=True, flash_min_seq_len=128): 13 s at 1600 Hz
with a 40-sample hop is 520 latent frames, so the L/4 transformer sees 130
frames (Pallas interpret mode in JAX, the plain version in the port) and
the decode takes the chunked branch with 4 chunks. Both packages get the
same UNet, T5 and codec weights (ckpt/from_jax.py) and the same initial
noise (the JAX stream, rebuilt on the host). The waveform is compared at
rtol 2e-2 / atol 2e-3, the sampler-trajectory bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jen1_tpu.api.generation import Jen1 as JJen1
from jen1_tpu.codec.model import EncodecConfig as JCodecConfig, EncodecModel as JCodec
from jen1_tpu.conditioning import conditioners as jcond
from jen1_tpu_torch.api.generation import Jen1, latent_length
from jen1_tpu_torch.codec.model import EncodecConfig, EncodecModel
from jen1_tpu_torch.conditioning import conditioners as pcond
from jen1_tpu_torch.diffusion import vdm as port_vdm
from torch_port_util import (
    assert_close, flash_model_configs, load, random_params, vdm_initial_noise,
)

CODEC = dict(sample_rate=1600, channels=2, dimension=8, n_filters=2, ratios=(5, 4, 2))
RVQ = dict(n_q=2, bins=16)  # the JAX model also builds its quantizer
SECONDS, STEPS = 13, 2
BAR = dict(rtol=2e-2, atol=2e-3)


@pytest.fixture(scope="module")
def pair():
    jcfg, pcfg = flash_model_configs()
    mc = jcfg.model_config
    jcodec = JCodec(JCodecConfig(**CODEC, **RVQ))
    jt5 = jcond.T5Conditioner(output_dim=mc.context_embedding_features,
                              t5_model_name="tiny-test",
                              max_length=mc.context_embedding_max_length)
    jj = JJen1(ckpt_path=None, sample_rate=1600, config=jcfg, codec=jcodec,
               conditioner=jcond.MultiConditioner({"prompt": jt5}))
    shapes = jax.eval_shape(lambda r: jj.model.init(
        r, jnp.zeros((1, 40, mc.in_channels)), jnp.zeros((1,)),
        embedding=jnp.zeros((1, mc.context_embedding_max_length,
                             mc.context_embedding_features)),
        channels_list=[jnp.zeros((1, 40, mc.context_channels[0]))],
    ), jax.random.PRNGKey(0))
    params = random_params(shapes, seed=1)
    jj._params = params  # the weights generate() samples with

    pcodec = EncodecModel(EncodecConfig(**CODEC), device="cpu")
    load(pcodec.decoder, jcodec.params["decoder"])
    pt5 = pcond.T5Conditioner(mc.context_embedding_features, "tiny-test",
                              mc.context_embedding_max_length, device="cpu")
    load(pt5, {"encoder": jt5.params["encoder"], "proj": jt5.params["proj"]})
    pj = Jen1(sample_rate=1600, config=pcfg, codec=pcodec,
              conditioner=pcond.MultiConditioner({"prompt": pt5}), device="cpu")
    load(pj.model, params)
    return jj, pj


@pytest.mark.parametrize("seed,prompt", [(5, "a beautiful song")])
def test_generate_matches_jax(pair, seed, prompt, monkeypatch):
    jj, pj = pair
    ref = jj.generate(prompt, seed=seed, steps=STEPS, batch_size=1, seconds=SECONDS)
    frames = latent_length(SECONDS * 1600, 40)
    assert frames == 520
    noise = torch.from_numpy(vdm_initial_noise(seed, (1, frames, 8)))
    monkeypatch.setattr(port_vdm, "initial_noise", lambda shape, generator, device: noise)
    out = pj.generate(prompt, seed=seed, steps=STEPS, batch_size=1, seconds=SECONDS)
    assert out.shape == ref.shape == (1, 2, SECONDS * 1600)
    assert np.isfinite(out).all()
    assert_close(out, ref, **BAR)
    assert set(pj.last_timings) == {"prep", "conditioner", "assemble", "sampler",
                                    "decode", "fetch"}


def test_int16_output_and_seed_dependence(pair):
    _, pj = pair
    f32 = pj.generate("quiet strings", seed=2, steps=1, seconds=1)
    pcm = pj.generate("quiet strings", seed=2, steps=1, seconds=1, output_dtype="int16")
    assert pcm.dtype == np.int16 and pcm.shape == f32.shape == (1, 2, 1600)
    np.testing.assert_array_equal(pcm, (np.clip(f32, -1, 1) * 32767.0).astype(np.int16))
    other = pj.generate("quiet strings", seed=3, steps=1, seconds=1)
    assert not np.array_equal(f32, other)


def test_unported_arguments_raise(pair):
    _, pj = pair
    for kw in ({"use_gdm": True}, {"task": "music_inpaint"}, {"decode_mode": "whole"}):
        with pytest.raises(NotImplementedError):
            pj.generate("x", seed=1, steps=1, seconds=1, **kw)
    with pytest.raises(ValueError):
        pj.generate("x", seed=1, steps=1, seconds=1, output_dtype="int8")


def test_latent_length_matches_jax_encoder_shape():
    """text_guided derives the latent grid without encoding; the JAX
    package gets it from eval_shape of its chunked encoder."""
    jcodec = JCodec(JCodecConfig(**CODEC, **RVQ))
    for samples in (1600, 1620, 20800, 20810):
        want = jax.eval_shape(jcodec.encode_latent_chunked,
                              jax.ShapeDtypeStruct((1, samples, 2), jnp.float32)).shape[1]
        assert latent_length(samples, 40) == want
