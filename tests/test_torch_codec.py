"""Port parity: EnCodec. The weights of a jen1_tpu EncodecModel (the tiny
config of tests/test_api.py: encoder, decoder and a 2 x 16-entry RVQ) go
through ckpt/from_jax.py into jen1_tpu_torch's EncodecModel, and both get the
same latents or audio. Bars: the decoder, the SEANet encoder and every
encode path 1e-4; RVQ codes equal, the dequantized latent 1e-5;
`convert_audio` 1e-6; the bf16 chunked decode twice what the bf16 weights
alone move the JAX decode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jen1_tpu.codec.model import EncodecConfig as JConfig, EncodecModel as JModel
from jen1_tpu.codec.rvq import ResidualVectorQuantizer as JRVQ
from jen1_tpu.data.audio_io import convert_audio as jax_convert_audio
from jen1_tpu_torch.ckpt.from_jax import load_encodec
from jen1_tpu_torch.codec.model import EncodecConfig, EncodecModel
from jen1_tpu_torch.codec.rvq import ResidualVectorQuantizer
from jen1_tpu_torch.data.audio_io import convert_audio
from torch_port_util import (
    TINY_CODEC, assert_close, np_tree, one_torch_thread, randn, rng, synthetic_clip,
)

BAR = dict(rtol=1e-4, atol=1e-4)
SR = TINY_CODEC["sample_rate"]


@pytest.fixture(scope="module")
def codecs():
    jcodec = JModel(JConfig(**TINY_CODEC))
    pcodec = EncodecModel(EncodecConfig(**TINY_CODEC), device="cpu")
    load_encodec(pcodec, np_tree(jcodec.params))
    with one_torch_thread():
        yield jcodec, pcodec.eval()


def clip(seed: int, samples: int, batch: int = 1) -> np.ndarray:
    return np.stack([synthetic_clip(seed + i, samples / SR, SR) for i in range(batch)])


@pytest.mark.parametrize("batch,frames", [(2, 37), (1, 2)])
def test_decode_latent(codecs, batch, frames):
    """frames = 2 is shorter than the first conv's reflect pad, which takes
    EnCodec's zero-extension branch."""
    jcodec, pcodec = codecs
    z = randn(rng(frames), batch, frames, 8)
    ref = jcodec.decode_latent(z)
    out = pcodec.decode_latent(torch.from_numpy(z))
    assert out.shape == (batch, frames * 40, 2)
    assert_close(out, ref, **BAR)


@pytest.mark.parametrize("frames", [520, 100])
def test_decode_latent_chunked(codecs, frames):
    """520 frames: four 150-frame chunks with a 148-frame hop and triangular
    overlap-add; 100 frames: one chunk, the whole-latent path."""
    jcodec, pcodec = codecs
    z = randn(rng(frames), 1, frames, 8)
    ref = jcodec.decode_latent_chunked(jax.numpy.asarray(z))
    out = pcodec.decode_latent_chunked(torch.from_numpy(z))
    assert out.shape == (1, frames * 40, 2)
    assert_close(out, np.asarray(ref), **BAR)


def test_decode_latent_chunked_bf16(codecs):
    """The cached bf16 decoder (decode_mode="chunked_bf16"). Bar: twice what
    casting the decoder weights to bf16 moves the JAX decode (JAX bf16
    against JAX fp32 on the same latent), held against the JAX bf16 decode."""
    jcodec, pcodec = codecs
    z = jnp.asarray(randn(rng(7), 1, 520, 8))
    ref32 = np.asarray(jcodec.decode_latent_chunked(z))
    ref16 = np.asarray(jcodec.decode_latent_chunked(z, dtype=jnp.bfloat16))
    out = pcodec.decode_latent_chunked(torch.from_numpy(np.array(z)), dtype=torch.bfloat16)
    bar = 2 * np.abs(ref16 - ref32).max()
    diff = np.abs(out.numpy() - ref16).max()
    assert out.dtype == torch.float32 and out.shape == ref16.shape
    assert 0 < diff <= bar, (diff, bar)
    with pytest.raises(ValueError):
        pcodec.decode_latent_chunked(torch.from_numpy(np.array(z)), dtype=torch.float16)


@pytest.mark.parametrize("quantize", [False, True])
def test_encode_latent(codecs, quantize):
    """The whole-clip encoder: quantize=False is the SEANet encoder alone;
    37.25 frames of audio round up to 38 in its strided convs."""
    jcodec, pcodec = codecs
    audio = clip(1, 1490, batch=2)
    ref = np.asarray(jcodec.encode_latent(jnp.asarray(audio), quantize=quantize))
    out = pcodec.encode_latent(torch.from_numpy(audio), quantize=quantize)
    assert out.shape == ref.shape == (2, 38, 8)
    if quantize:
        check_code_gap(pcodec, pcodec.encode_latent(torch.from_numpy(audio), quantize=False))
    assert_close(out, ref, **BAR)


def check_code_gap(pcodec, latent: torch.Tensor) -> None:
    """The quantized encode paths are compared elementwise, which holds only
    if both packages pick the same codes: the test audio keeps every
    nearest entry at least 1e-3 closer than the second nearest, far above
    what the packages' 1e-6-level latent differences move a distance."""
    gap = min_code_gap(pcodec.quantizer, latent)
    print(f"smallest best-to-second-best distance gap {gap:.3e}")
    assert gap > 1e-3


def min_code_gap(rvq: ResidualVectorQuantizer, x: torch.Tensor) -> float:
    """The smallest distance from the nearest codebook entry to the second
    nearest, over every frame and stage of `x`'s encode."""
    residual, gaps = x.float(), []
    for i in range(rvq.n_q):
        d = rvq.distances(residual, i)
        two = d.topk(2, dim=-1, largest=False).values
        gaps.append((two[..., 1] - two[..., 0]).min().item())
        residual = residual - rvq.codebooks[i][d.argmin(-1)]
    return min(gaps)


@pytest.mark.parametrize("n_q", [None, 1])
def test_rvq_codes_and_dequantize(n_q):
    """RVQ codes equal to the JAX ones, the dequantized latent within 1e-5.
    The data keeps every nearest entry at least 1e-3 closer than the
    second nearest, far above the fp32 rounding of the distances (~1e-6
    here), so the order of the sums cannot flip a code."""
    g = rng(11)
    books = randn(g, 4, 64, 8)
    x = randn(g, 2, 300, 8) * 1.5
    jrvq = JRVQ(jnp.asarray(books), frame_rate=40.0)
    prvq = ResidualVectorQuantizer(torch.from_numpy(books), frame_rate=40.0)
    gap = min_code_gap(prvq, torch.from_numpy(x))
    print(f"smallest best-to-second-best distance gap {gap:.3e}")
    assert gap > 1e-3
    ref = np.asarray(jrvq.encode(jnp.asarray(x), n_q))
    codes = prvq.encode(torch.from_numpy(x), n_q)
    assert codes.dtype == torch.int32 and codes.shape == ref.shape == (2, n_q or 4, 300)
    np.testing.assert_array_equal(codes.numpy(), ref)
    assert_close(prvq.decode(codes), np.asarray(jrvq.decode(jnp.asarray(ref))),
                 rtol=1e-5, atol=1e-5)
    assert_close(prvq.quantize_latent(torch.from_numpy(x), n_q),
                 np.asarray(jrvq.quantize_latent(jnp.asarray(x), n_q)), rtol=1e-5, atol=1e-5)
    for bw in (None, 0.0, 0.3, 1.0, 100.0):
        assert prvq.num_quantizers_for_bandwidth(bw) == jrvq.num_quantizers_for_bandwidth(bw)


@pytest.mark.parametrize("frames", [520, 298])
def test_encode_latent_chunked(codecs, frames):
    """520 frames: four 150-frame chunks; 298 frames lands exactly on the
    chunk grid (two chunks, no padding), with a 13-sample tail that is cut
    before padding (jen1_tpu/codec/model.py:312-317)."""
    jcodec, pcodec = codecs
    audio = clip(2, frames * 40 + 13)
    ref = np.asarray(jcodec.encode_latent_chunked(jnp.asarray(audio)))
    out = pcodec.encode_latent_chunked(torch.from_numpy(audio))
    assert out.shape == ref.shape == (1, frames, 8)
    check_code_gap(pcodec, pcodec.encode_latent_chunked(torch.from_numpy(audio),
                                                        quantize=False))
    assert_close(out, ref, **BAR)


def test_encode_latent_segmented(codecs):
    """1 s segments with 1 % overlap: 13 s give 14 segments (the last one 208
    samples, 6 frames), whose codes concatenate to 526 frames."""
    jcodec, pcodec = codecs
    audio = clip(3, 13 * SR)
    ref = np.asarray(jcodec.encode_latent_segmented(jnp.asarray(audio)))
    out = pcodec.encode_latent_segmented(torch.from_numpy(audio))
    assert out.shape == ref.shape == (1, 526, 8)
    assert_close(out, ref, **BAR)


@pytest.mark.parametrize("samples", [3 * SR + 100, SR])
def test_segment_bounds_and_encode_decode(codecs, samples):
    """_segment_bounds with a trailing remainder (4 segments, the last 148
    samples) and at exactly one segment (EnCodec's no-early-break loop
    gives two); encode's codes equal, decode(encode(...)) within 1e-4."""
    jcodec, pcodec = codecs
    bounds = pcodec._segment_bounds(samples)
    assert bounds == jcodec._segment_bounds(samples)
    assert len(bounds) == (4 if samples > SR else 2)
    audio = clip(4, samples)
    jframes = jcodec.encode(jnp.asarray(audio))
    pframes = pcodec.encode(torch.from_numpy(audio))
    for (jc, js), (pc, ps) in zip(jframes, pframes):
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
        assert_close(ps, np.asarray(js), rtol=1e-6, atol=0)
    ref = np.asarray(jcodec.decode(jframes))
    out = pcodec.decode(pframes)
    assert out.shape == ref.shape
    assert_close(out, ref, **BAR)


@pytest.mark.parametrize("channels,src_sr,dst_sr,dst_channels", [
    (1, 1600, 1600, 2), (2, 1600, 1600, 1), (3, 1600, 1600, 2), (2, 1000, 1600, 2),
    (1, 2205, 1600, 2),
])
def test_convert_audio(channels, src_sr, dst_sr, dst_channels):
    audio = randn(rng(channels), 1234, channels)
    if channels == 1:
        audio = audio[:, 0]  # (T,) mono
    ref = jax_convert_audio(audio, src_sr, dst_sr, dst_channels)
    out = convert_audio(audio, src_sr, dst_sr, dst_channels)
    assert out.dtype == np.float32 and out.shape == ref.shape
    assert_close(out, ref, rtol=1e-6, atol=1e-6)
