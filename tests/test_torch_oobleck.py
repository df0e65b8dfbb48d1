"""The Oobleck VAE decoder of jen1_tpu_torch (codec/oobleck.py) against the
plain fp32 reference (reference/stable_audio_open.py) on seeded weights,
the published topology on the meta device, and a planted DAC Snake.

Tolerance: both sides compute in fp32 on the CPU and differ only in the
order of sums (cuDNN-style channels-last views against (B, C, T) convs),
about 1e-6 of the norm, so `FP32_REL` = 1e-4 in relative L2; the planted
Snake changes the activation of every layer and must move the audio by
more than `FAULT_REL` = 1e-2.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from jen1_tpu_torch.codec.oobleck import OobleckCodec, OobleckDecoder
from jen1_tpu_torch.config import OobleckConfig, stable_audio_open_config
from jen1_tpu_torch.ops import snake
from reference import stable_audio_open as ref

FP32_REL = 1e-4
FAULT_REL = 1e-2
TINY = OobleckConfig(dimension=8, base_channels=8, c_mults=(1, 2, 4), strides=(2, 4, 2))


def rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture(scope="module")
def pair():
    """The codec on seeded weights (SnakeBeta's log-scale parameters drawn
    too, so that neither starts at e^0 = 1) and the reference holding them."""
    codec = OobleckCodec(TINY, device="cpu", generator=torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, p in codec.decoder.named_parameters():
            if name.endswith(("alpha", "beta")):
                p.uniform_(-0.5, 0.5, generator=g)
    decoder = ref.OobleckDecoder(dataclasses.asdict(TINY))
    decoder.load_state_dict(codec.decoder.state_dict(), strict=True)
    return codec, decoder


def latent(frames=12, batch=3):
    return torch.randn(batch, frames, 8, generator=torch.Generator().manual_seed(6))


def test_decoder_matches_reference(pair):
    codec, decoder = pair
    z = latent()
    out = codec.decode_latent(z)
    with torch.no_grad():
        want = decoder(z.transpose(1, 2)).transpose(1, 2)
    assert out.shape == want.shape == (3, 12 * 16, 2)
    assert rel(out, want) < FP32_REL


def test_a_clip_at_a_time(pair):
    """The batch is decoded clip by clip (the published iterate_batch): each
    row equals its own decode."""
    codec, _ = pair
    z = latent()
    out = codec.decode_latent(z)
    for i in range(3):
        assert rel(out[i:i + 1], codec.decode_latent(z[i:i + 1])) < 1e-6
    assert codec.decode_latent_chunked == codec.decode_latent
    assert codec.latent_frames(12 * 16 + 15) == 12


def test_bf16_decode_is_close(pair):
    """dtype bfloat16 runs the convs in bf16 (weights cast at use): within
    a few bf16 steps of the fp32 decode, not equal to it."""
    codec, _ = pair
    z = latent()
    a, b = codec.decode_latent(z), codec.decode_latent(z, dtype=torch.bfloat16)
    assert b.dtype == torch.float32 and 0 < rel(b, a) < 0.05


def test_planted_dac_snake_fails(pair, monkeypatch):
    """DAC's Snake (one alpha, x + sin^2(alpha x) / alpha) in place of
    SnakeBeta (log-scale alpha and beta)."""
    codec, decoder = pair
    z = latent()
    with torch.no_grad():
        want = decoder(z.transpose(1, 2)).transpose(1, 2)
    monkeypatch.setattr(snake.SnakeBeta, "forward", lambda self, x: snake.snake(x, self.alpha))
    assert rel(codec.decode_latent(z), want) > FAULT_REL


def test_published_decoder_topology():
    """Stable Audio Open's decoder on the meta device: 64 -> 2048 channels,
    blocks to 1024, 512, 256, 128, 128 at strides 8, 8, 4, 4, 2, a hop of
    2048 and stereo out."""
    oc = stable_audio_open_config().oobleck_config
    with torch.device("meta"):
        dec = OobleckDecoder(oc)
        out = dec(torch.empty(1, 4, 64))
    assert tuple(out.shape) == (1, 4 * 2048, 2)
    assert dec.conv_in.weight.shape == (2048, 64, 7) and dec.conv_out.bias is None
    widths = [(b.up.weight.shape[0], b.up.weight.shape[1], b.up.stride) for b in dec.blocks]
    assert widths == [(2048, 1024, 8), (1024, 512, 8), (512, 256, 4), (256, 128, 4),
                      (128, 128, 2)]
    assert [u.conv1.dilation for u in dec.blocks[0].res] == [1, 3, 9]
