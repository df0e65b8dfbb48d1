"""Port parity of long-form output: jen1_tpu_torch `Jen1.generate_long` /
`generate_long_stream` vs jen1_tpu's, on the tiny pair of
`torch_port_util.jen1_pair` (flash path at flash_min_seq_len 128) with
every window's JAX draws injected, and `save_audio` / `write_wav` /
`write_flac` / `read_wav` against the JAX writers.

Long-form: 13 s windows at 1600 Hz (520 latent frames, so the level-1
transformer attends over 130 frames through the flash path), 4 s of
context, 29 s in all: three windows, the last cropped. Bar: rtol 2e-2 /
atol 2e-3, the whole-generate() bar.
"""

import io
import wave

import numpy as np
import pytest
import torch

from jen1_tpu.api.generation import save_audio as jax_save_audio
from jen1_tpu.data.audio_io import write_wav as jax_write_wav
from jen1_tpu.data.flac_write import write_flac as jax_write_flac
from jen1_tpu_torch.api.generation import save_audio
from jen1_tpu_torch.data.audio_io import read_wav, write_wav
from jen1_tpu_torch.data.flac_write import write_flac
from jen1_tpu_torch.diffusion import vdm as port_vdm
from jen1_tpu_torch.ops import attention as port_attention
from torch_port_util import assert_close, jen1_pair, one_torch_thread, rng, vdm_initial_noise

SR, SEED, STEPS = 1600, 9, 2
LONG = dict(total_seconds=29, window_seconds=13, context_seconds=4, fade_seconds=0.05,
            seed=SEED, steps=STEPS)
WINDOWS, FRAMES = 3, 520
BAR = dict(rtol=2e-2, atol=2e-3)


@pytest.fixture(scope="module")
def pair():
    with one_torch_thread():
        yield jen1_pair()


def inject_windows(monkeypatch, n_windows: int, runs: int = 1) -> None:
    """Window i of the JAX package samples from vdm_initial_noise(seed + i):
    give the port's windows the same x_T, in call order, for `runs` runs."""
    noises = iter([torch.from_numpy(vdm_initial_noise(SEED + i, (1, FRAMES, 8)))
                   for i in range(n_windows)] * runs)
    monkeypatch.setattr(port_vdm, "initial_noise", lambda shape, generator, device: next(noises))


@pytest.fixture(scope="module")
def jax_long(pair):
    jj, _ = pair
    with one_torch_thread():
        return np.asarray(jj.generate_long("an endless tune", **LONG))


def test_generate_long_matches_jax(pair, jax_long, monkeypatch):
    _, pj = pair
    inject_windows(monkeypatch, WINDOWS)
    calls = []

    def counting_flash(q, k, v, causal=False, **kw):
        calls.append(causal)
        return flash(q, k, v, causal=causal, **kw)

    flash = port_attention.flash_attention
    monkeypatch.setattr(port_attention, "flash_attention", counting_flash)
    with one_torch_thread():
        out = pj.generate_long("an endless tune", **LONG)
    assert out.shape == jax_long.shape == (1, 2, 29 * SR)
    assert np.isfinite(out).all()
    assert_close(out, jax_long, **BAR)
    # K1's dispatches: two per UNet forward (the level-1 transformers of the
    # down and up paths; batch CFG makes one forward per step), so 2 * STEPS
    # per window; the continuation windows' all causal
    per_window = 2 * STEPS
    assert calls == [False] * per_window + [True] * (WINDOWS - 1) * per_window


def test_stream_concatenates_exactly(pair, monkeypatch):
    """The chunks concatenate to generate_long's output exactly; every chunk
    but the last holds back the fade region for the next window."""
    _, pj = pair
    inject_windows(monkeypatch, WINDOWS, runs=2)
    with one_torch_thread():
        whole = pj.generate_long("an endless tune", **LONG)
        chunks = list(pj.generate_long_stream("an endless tune", **LONG))
    assert len(chunks) == WINDOWS
    assert np.array_equal(np.concatenate(chunks, axis=-1), whole)
    fade = int(0.05 * SR)
    step = (13 - 4) * SR
    assert [c.shape[-1] for c in chunks] == [13 * SR - fade, step, 29 * SR - 22 * SR + fade]


def test_total_shorter_than_one_window(pair, monkeypatch):
    """One text_guided window, cropped to total_seconds, as in the JAX package."""
    jj, pj = pair
    ref = np.asarray(jj.generate_long("short", **dict(LONG, total_seconds=5)))
    inject_windows(monkeypatch, 1)
    with one_torch_thread():
        out = pj.generate_long("short", **dict(LONG, total_seconds=5))
    assert out.shape == ref.shape == (1, 2, 5 * SR)
    assert_close(out, ref, **BAR)


def test_context_must_be_shorter_than_window(pair):
    jj, pj = pair
    with pytest.raises(AssertionError):
        jj.generate_long("x", total_seconds=20, window_seconds=13, context_seconds=13)
    with pytest.raises(ValueError, match="context_seconds"):
        pj.generate_long("x", total_seconds=20, window_seconds=13, context_seconds=13)


# ------------------------------------------------------------- writers


def clip(seed: int, frames: int = 5000) -> np.ndarray:
    """A seeded (T, 2) float clip that overshoots [-1, 1] now and then."""
    return (0.6 * rng(seed).standard_normal((frames, 2))).astype(np.float32)


def test_write_wav_bytes_equal_jax(tmp_path):
    audio = clip(1)
    write_wav(str(tmp_path / "port.wav"), audio, SR)
    jax_write_wav(str(tmp_path / "jax.wav"), audio, SR)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()


@pytest.mark.parametrize("kw", [{}, dict(stereo="mid_side", subframe="lpc")],
                         ids=["default", "mid_side-lpc"])
def test_write_flac_bytes_equal_jax(tmp_path, kw):
    audio = clip(2)
    write_flac(str(tmp_path / "port.flac"), audio, SR, **kw)
    jax_write_flac(str(tmp_path / "jax.flac"), audio, SR, **kw)
    assert (tmp_path / "port.flac").read_bytes() == (tmp_path / "jax.flac").read_bytes()


def test_read_wav_round_trip(tmp_path):
    audio = clip(3)
    path = str(tmp_path / "a.wav")
    write_wav(path, audio, SR)
    back, sr = read_wav(path)
    assert sr == SR and back.shape == audio.shape and back.dtype == np.float32
    want = (np.clip(audio, -1, 1) * 32767.0).astype(np.int16).astype(np.float32) / 32768.0
    np.testing.assert_array_equal(back, want)
    part, _ = read_wav(path, start_frame=100, num_frames=50)
    np.testing.assert_array_equal(part, want[100:150])


def flac_streaminfo(data: bytes):
    """(sample rate, channels, bits, total samples) of a FLAC's STREAMINFO."""
    assert data[:4] == b"fLaC" and data[4] & 0x7F == 0  # first block: STREAMINFO
    bits = int.from_bytes(data[8 + 10:8 + 18], "big")
    return bits >> 44, ((bits >> 41) & 7) + 1, ((bits >> 36) & 31) + 1, bits & ((1 << 36) - 1)


@pytest.mark.parametrize("ext", ["wav", "flac"])
@pytest.mark.parametrize("ndim", [3, 2])
def test_save_audio_matches_jax(tmp_path, ext, ndim):
    """(B, ch, T) takes example 0, (ch, T) is written as is; the bytes equal
    the JAX save_audio's."""
    audio = np.stack([clip(4, 3000).T, clip(5, 3000).T])  # (2, 2, 3000)
    if ndim == 2:
        audio = audio[1]
    port, ref = tmp_path / f"port.{ext}", tmp_path / f"jax.{ext}"
    save_audio(audio, str(port), SR)
    jax_save_audio(audio, str(ref), SR)
    data = port.read_bytes()
    assert data == ref.read_bytes()
    if ext == "flac":
        assert flac_streaminfo(data) == (SR, 2, 16, 3000)
    else:
        with wave.open(io.BytesIO(data)) as w:
            assert (w.getframerate(), w.getnchannels(), w.getnframes()) == (SR, 2, 3000)
