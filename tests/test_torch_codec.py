"""Port parity: EnCodec decode. The decoder weights of a jen1_tpu
EncodecModel (the tiny config of tests/test_api.py) go through
ckpt/from_jax.py into jen1_tpu_torch's EncodecModel; `decode_latent` and
`decode_latent_chunked` are compared on the same latents at 1e-4."""

import jax
import numpy as np
import pytest
import torch

from jen1_tpu.codec.model import EncodecConfig as JConfig, EncodecModel as JModel
from jen1_tpu_torch.codec.model import EncodecConfig, EncodecModel
from torch_port_util import assert_close, load, randn, rng

TINY = dict(sample_rate=1600, channels=2, dimension=8, n_filters=2, ratios=(5, 4, 2))
RVQ = dict(n_q=2, bins=16)  # the JAX model also builds its quantizer
BAR = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def codecs():
    jcodec = JModel(JConfig(**TINY, **RVQ))
    pcodec = EncodecModel(EncodecConfig(**TINY), device="cpu")
    load(pcodec.decoder, jcodec.params["decoder"])
    return jcodec, pcodec


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
