"""Port parity of the whole slice: jen1_tpu_torch `Jen1.generate` vs
jen1_tpu `Jen1.generate`, text_guided, chunked decode, with the VDM
sampler and with the GDM (DDIM, DPM-Solver++, and DDIM over int8 weights).

The fixture (`torch_port_util.jen1_pair`) is tests/test_api.py's tiny
model and codec with the flash path engaged (use_flash_attention=True,
flash_min_seq_len=128): 13 s at 1600 Hz with a 40-sample hop is 520
latent frames, so the L/4 transformer sees 130
frames (Pallas interpret mode in JAX, the plain version in the port) and
the decode takes the chunked branch with 4 chunks. Both packages get the
same UNet, T5 and codec weights (ckpt/from_jax.py) and the same draws
(the JAX streams, rebuilt on the host). The waveform is compared at
rtol 2e-2 / atol 2e-3, the sampler-trajectory bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jen1_tpu.codec.model import EncodecConfig as JCodecConfig, EncodecModel as JCodec
from jen1_tpu.ops import int8_matmul as jint8
from jen1_tpu_torch.api.generation import latent_length
from jen1_tpu_torch.diffusion import vdm as port_vdm
from jen1_tpu_torch.ops.int8_matmul import (
    attach_qweights, clear_qweights, quantize_conv_params,
)
from torch_port_util import (
    TINY_CODEC, assert_close, gdm_draws, inject_gdm_draws, jen1_pair, one_torch_thread,
    vdm_initial_noise,
)

SECONDS, STEPS = 13, 2
BAR = dict(rtol=2e-2, atol=2e-3)


@pytest.fixture(scope="module")
def pair():
    with one_torch_thread():
        yield jen1_pair()


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
    assert set(pj.last_timings) == {"prep", "encode", "conditioner", "assemble", "sampler",
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
    for kw in ({"use_gdm": True, "encoder_reuse": 2}, {"output_transport": "device"}):
        with pytest.raises(NotImplementedError):
            pj.generate("x", seed=1, steps=1, seconds=1, **kw)
    for kw in ({"output_dtype": "int8"}, {"sampler_mode": "dpm++"},
               {"sampler_mode": "euler", "use_gdm": True}, {"encoder_reuse": 2},
               {"decode_mode": "chunked_fp16"}, {"encode_mode": "segmented"}):
        with pytest.raises(ValueError):
            pj.generate("x", seed=1, steps=1, seconds=1, **kw)


@pytest.mark.parametrize("mode,quantized", [("scan", False), ("dpm++", False), ("scan", True)])
def test_generate_gdm_matches_jax(pair, mode, quantized, monkeypatch):
    """use_gdm=True: DDIM (2 of the tiny config's 8 timesteps) or
    DPM-Solver++, optionally with every UNet conv quantized (thresholds 0;
    JAX gets the same weights' `qweights` collection beside its params).

    fp32 weights: the VDM request's bar. int8 weights: every int8 conv
    rounds its input to bf16, so the request is as sensitive to a 1e-6
    change upstream as to a bf16 step. Measured on this fixture, a relative
    1e-6 perturbation of x_T moves the port's own waveform by max 0.027-0.030
    and mean 1.45e-3 (rms of the waveform ~1.0), and the two packages differ
    by max 0.020-0.030 and mean 1.3e-3. The bar is twice that spread: mean
    |diff| <= 3e-3 and max |diff| <= 6e-2. A kernel8 read in the wrong
    order or without its scale changes every conv's output, far beyond it."""
    jj, pj = pair
    seed, prompt, steps = 6, "a beautiful song", 2
    params = jj._params
    if quantized:
        q = jint8.quantize_conv_params(params, min_weight_bytes=0, min_weight_bytes_k1=0)
        jj._params = {"params": params["params"], "qweights": q}
        assert attach_qweights(pj.model, quantize_conv_params(
            pj.model, min_weight_bytes=0, min_weight_bytes_k1=0)) > 10
    try:
        ref = jj.generate(prompt, seed=seed, steps=steps, seconds=SECONDS, use_gdm=True,
                          sampler_mode=mode)
        frames = latent_length(SECONDS * 1600, 40)
        x_t, noises = gdm_draws(jax.random.fold_in(jax.random.key(seed), 2), (1, frames, 8),
                                range(steps))
        inject_gdm_draws(monkeypatch, x_t, noises)
        out = pj.generate(prompt, seed=seed, steps=steps, seconds=SECONDS, use_gdm=True,
                          sampler_mode=mode)
    finally:
        jj._params = params
        clear_qweights(pj.model)
    assert out.shape == ref.shape == (1, 2, SECONDS * 1600)
    assert np.isfinite(out).all()
    if quantized:
        diff = np.abs(out - ref)
        assert diff.mean() <= 3e-3 and diff.max() <= 6e-2, (diff.mean(), diff.max())
    else:
        assert_close(out, ref, **BAR)


def test_latent_length_matches_jax_encoder_shape():
    """text_guided derives the latent grid without encoding; the JAX
    package gets it from eval_shape of its chunked encoder."""
    jcodec = JCodec(JCodecConfig(**TINY_CODEC))
    for samples in (1600, 1620, 20800, 20810):
        want = jax.eval_shape(jcodec.encode_latent_chunked,
                              jax.ShapeDtypeStruct((1, samples, 2), jnp.float32)).shape[1]
        assert latent_length(samples, 40) == want
