"""Port parity of the inpainting and continuation slice: jen1_tpu_torch
`Jen1.generate(task=..., init_audio=...)` vs jen1_tpu `Jen1.generate` on the
same seeded clip, weights (`torch_port_util.jen1_pair`: the tiny model with
its flash path, the tiny codec with encoder and RVQ) and draws (the JAX
streams, rebuilt on the host).

13 s at 1600 Hz are 520 latent frames from the chunked encoder (526 from the
segmented one); `music_cont` gets the first 6 s and runs the causal UNet.
The waveform (or latent) is held at rtol 2e-2 / atol 2e-3, the sampler
bar; the conditioning both packages assemble is held too: the latent mask
(`_get_mask` and its nearest resize to latent frames) equal, the masked
encoded latent at the codec bar 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jen1_tpu.api.generation as jax_generation
from jen1_tpu.api.generation import Jen1 as JJen1
from jen1_tpu_torch.api import generation as port_generation
from jen1_tpu_torch.api.generation import Jen1
from jen1_tpu_torch.diffusion import vdm as port_vdm
from torch_port_util import (
    assert_close, gdm_draws, inject_gdm_draws, jen1_pair, one_torch_thread, synthetic_clip,
    vdm_initial_noise,
)

SR, SECONDS, STEPS, SEED = 1600, 13, 2, 5
PROMPT = "a beautiful song"
BAR = dict(rtol=2e-2, atol=2e-3)
CLIP = synthetic_clip(21, SECONDS, SR)  # (20800, 2)
INPAINT = dict(task="music_inpaint", init_audio=CLIP, inpainting_scope=(4.0, 9.0))
CONT = dict(task="music_cont", init_audio=CLIP[: 6 * SR])
CASES = {
    "inpaint-vdm": INPAINT,
    "cont-vdm": CONT,
    "cont-ddim": dict(CONT, use_gdm=True),
    "cont-dpm++": dict(CONT, use_gdm=True, sampler_mode="dpm++"),
    # at 1000 Hz, so generate() resamples it to the model's rate first
    "text_guided-init_audio": dict(task="text_guided", init_audio=CLIP[:13000],
                                   init_audio_sr=1000),
    "inpaint-decode_false": dict(INPAINT, decode=False),
    "inpaint-decode_whole": dict(INPAINT, decode_mode="whole"),
}


@pytest.fixture(scope="module")
def pair():
    with one_torch_thread():
        yield jen1_pair()


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def run_pair(pair, monkeypatch, kw, frames: int):
    """JAX generate, then the port's with the JAX draws injected. Returns
    (ref, out, {package: (mask, masked_input)}) as the two packages
    assembled their conditioning."""
    jj, pj = pair
    seen = {}
    for name, module in (("jax", jax_generation), ("port", port_generation)):
        def spy(cond, _orig=module.assemble_conditioning, _name=name, **k):
            seen[_name] = (to_np(cond["mask"]), to_np(cond["masked_input"]))
            return _orig(cond, **k)
        monkeypatch.setattr(module, "assemble_conditioning", spy)
    ref = jj.generate(PROMPT, seed=SEED, steps=STEPS, seconds=SECONDS, **kw)
    shape = (1, frames, 8)
    if kw.get("use_gdm"):
        x_t, noises = gdm_draws(jax.random.fold_in(jax.random.key(SEED), 2), shape,
                                range(STEPS))
        inject_gdm_draws(monkeypatch, x_t, noises)
    else:
        noise = torch.from_numpy(vdm_initial_noise(SEED, shape))
        monkeypatch.setattr(port_vdm, "initial_noise", lambda s, generator, device: noise)
    out = pj.generate(PROMPT, seed=SEED, steps=STEPS, seconds=SECONDS, **kw)
    return np.asarray(ref), out, seen


def check(ref, out, seen, shape) -> None:
    assert out.shape == ref.shape == shape
    assert np.isfinite(out).all()
    assert_close(out, ref, **BAR)
    (jmask, jin), (pmask, pin) = seen["jax"], seen["port"]
    np.testing.assert_array_equal(pmask, jmask)
    assert_close(pin, jin, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_generate_task_matches_jax(pair, monkeypatch, case):
    kw = CASES[case]
    ref, out, seen = run_pair(pair, monkeypatch, kw, frames=520)
    check(ref, out, seen, (1, 8, 520) if kw.get("decode") is False else (1, 2, SECONDS * SR))
    mask = seen["port"][0][0, :, 0]
    if kw["task"] == "music_inpaint":  # frames 160-359 (4 s to 9 s) are regenerated
        assert mask[:160].all() and not mask[160:360].any() and mask[360:].all()
    elif kw["task"] == "music_cont":  # the first 6 s are kept
        assert mask[:240].all() and not mask[240:].any()
    else:
        assert not mask.any()


def test_generate_segmented_latents_matches_jax(pair, monkeypatch):
    """config.codec_segmented_latents: the reference's segmented encode, a
    526-frame latent, so a 21,040-sample waveform."""
    jj, pj = pair
    jj.config.codec_segmented_latents = pj.config.codec_segmented_latents = True
    try:
        ref, out, seen = run_pair(pair, monkeypatch, INPAINT, frames=526)
    finally:
        jj.config.codec_segmented_latents = pj.config.codec_segmented_latents = False
    check(ref, out, seen, (1, 2, 526 * 40))


def test_generate_chunked_bf16_decode(pair, monkeypatch):
    """decode_mode="chunked_bf16". Bar: twice what the bf16 decoder weights
    alone move the JAX request (its chunked_bf16 output against its chunked
    fp32 output, same seed), held against the JAX chunked_bf16 output."""
    jj, _ = pair
    ref32 = np.asarray(jj.generate(PROMPT, seed=SEED, steps=STEPS, seconds=SECONDS, **INPAINT))
    ref, out, _ = run_pair(pair, monkeypatch, dict(INPAINT, decode_mode="chunked_bf16"), 520)
    bar = 2 * np.abs(ref - ref32).max()
    diff = np.abs(out - ref).max()
    assert out.shape == ref.shape == (1, 2, SECONDS * SR)
    assert 0 < diff <= bar, (diff, bar)


@pytest.mark.parametrize("start,end", [(0.0, 13.0), (4.0, 9.0), (6.0, 13.0), (0.3, 0.7001)])
def test_get_mask_matches_jax(start, end):
    out = Jen1._get_mask(SECONDS * SR, start, end, 2, SR)
    np.testing.assert_array_equal(out, JJen1._get_mask(SECONDS * SR, start, end, 2, SR))
    assert out.shape == (2, SECONDS * SR, 1) and out.dtype == np.float32


@pytest.mark.parametrize("mode", ["chunked", "whole", "segmented"])
def test_latent_frames_match_jax_encoders(pair, mode):
    """text_guided without init_audio skips the encoder and needs only its
    latent grid; the JAX package takes it from eval_shape of the encoder."""
    jj, pj = pair
    fn = {"chunked": jj.codec.encode_latent_chunked, "whole": jj.codec.encode_latent,
          "segmented": jj.codec.encode_latent_segmented}[mode]
    pj.config.codec_segmented_latents = mode == "segmented"
    try:
        for samples in (1600, 1620, 20800, 20810, 47_999):
            want = jax.eval_shape(fn, jax.ShapeDtypeStruct((1, samples, 2), jnp.float32))
            assert pj.latent_frames(samples, "whole" if mode == "whole" else "chunked") \
                == want.shape[1], samples
    finally:
        pj.config.codec_segmented_latents = False


@pytest.mark.parametrize("kw,exc", [
    (dict(task="music_inpaint", init_audio=CLIP), AssertionError),
    (dict(task="music_remix"), ValueError),
    (dict(encode_mode="segmented"), ValueError),
    (dict(use_gdm=True, encoder_reuse=2, sampler_mode="stepwise"), ValueError),
    (dict(encoder_reuse=2), ValueError),
])
def test_generate_refusals(pair, kw, exc):
    """A missing inpainting_scope, an unknown task or encode mode, and
    encoder_reuse outside GDM 'scan' / 'dpm++' fail as in the JAX package."""
    _, pj = pair
    with pytest.raises(exc):
        pj.generate(PROMPT, seed=1, steps=1, seconds=1, **kw)
