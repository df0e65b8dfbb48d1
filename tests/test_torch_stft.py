"""Port parity of the STFT (`ops/stft.py`) and the UNet's STFT mode
(`use_stft`, `use_stft_context`) against jen1_tpu on the CPU, fp32.

Waves mix a DC offset with tones and noise, and frames with a negative DC
component are asserted to occur: the phase of such a bin is +pi in JAX
(its rfft gives the DC imaginary part as +0.0), and a port that gave -pi
would differ from it by a 2 pi step in a UNet input channel.

Bars: encode (magnitude, real and imaginary parts) and decode rtol 1e-4 /
atol 1e-4 relative to the largest magnitude (the fp32 FFTs of two
libraries); phase within 1e-3 + 1e-4 pi where the magnitude exceeds 1e-3
of the largest (a phase is as sensitive as its bin is small), the DC
phase exactly, at even N modulo 2 pi (see the test); the round
trip at atol 1e-5 of the signal's peak; the UNet forwards at rtol 2e-3 /
atol 2e-4; the gradient at the train bars (every leaf within 5e-3 of its
max|g|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jen1_tpu.models.unet import unet_from_model_config as jax_unet
from jen1_tpu.ops.stft import STFT as JSTFT
from jen1_tpu_torch.models.unet import unet_from_model_config as port_unet
from jen1_tpu_torch.ops.stft import STFT
from torch_port_util import assert_close, load, randn, random_params, rng, tiny_model_configs

PLAIN = dict(rtol=2e-3, atol=2e-4)
LEAF_RTOL = 5e-3


def waves(seed, b, c, t):
    """(B, C, T) tones and noise on a per-channel DC offset of 0.5-2, of
    alternating sign (channel 0 negative)."""
    g = rng(seed)
    n = np.arange(t)
    tones = np.sin(2 * np.pi * g.uniform(0.001, 0.2, (b, c, 1)) * n)
    sign = np.where(np.arange(c) % 2 == 0, -1.0, 1.0)[None, :, None]
    offset = sign * g.uniform(0.5, 2.0, (b, c, 1))
    return (offset + tones + 0.3 * g.standard_normal((b, c, t))).astype(np.float32)


@pytest.mark.parametrize("num_fft,hop,use_complex", [(1023, 256, False), (1023, 256, True),
                                                     (63, 16, False), (64, 16, False)])
def test_encode_matches_jax(num_fft, hop, use_complex):
    x = waves(0, 2, 2, 4000)
    ja, jb = JSTFT(num_fft, hop, use_complex=use_complex).encode(jnp.asarray(x))
    pa, pb = STFT(num_fft, hop, use_complex=use_complex).encode(torch.from_numpy(x))
    ja, jb = np.asarray(ja), np.asarray(jb)
    assert pa.shape == ja.shape and pb.shape == jb.shape and pa.dtype == torch.float32
    scale = np.abs(ja).max()
    assert_close(pa, ja, rtol=1e-4, atol=1e-4 * scale)
    if use_complex:
        assert_close(pb, jb, rtol=1e-4, atol=1e-4 * np.abs(jb).max())
        return
    # frames whose DC bin is negative occur, and their phase is +pi as in JAX
    dc_phase = jb[:, :, 0, :]
    assert (dc_phase == np.float32(np.pi)).sum() > 10
    np.testing.assert_array_equal(pb[:, :, 0, :].numpy(), dc_phase)
    big = ja > 1e-3 * scale
    diff = pb.numpy()[big] - jb[big]
    if num_fft % 2 == 0:
        # at even N the centre-padded first and last frames are symmetric
        # about their middle sample, so every bin is real up to rounding and
        # its phase is +-pi by the rounding's sign: compared modulo 2 pi
        diff = (diff + np.pi) % (2 * np.pi) - np.pi
    np.testing.assert_allclose(diff, 0.0, atol=1e-3 + 1e-4 * np.pi)


@pytest.mark.parametrize("use_complex", [False, True])
@pytest.mark.parametrize("length", [None, 3000])
def test_decode_matches_jax(use_complex, length):
    """Decode of arbitrary (not STFT-consistent) pairs, as a UNet's output
    is, DC and phase channels included."""
    g = rng(1)
    a = np.abs(randn(g, 2, 2, 32, 40)) if not use_complex else randn(g, 2, 2, 32, 40)
    b = g.uniform(-np.pi, np.pi, (2, 2, 32, 40)).astype(np.float32)
    ref = JSTFT(63, 16, use_complex=use_complex).decode(jnp.asarray(a), jnp.asarray(b),
                                                          length=length)
    out = STFT(63, 16, use_complex=use_complex).decode(torch.from_numpy(a), torch.from_numpy(b),
                                                         length=length)
    assert out.shape == ref.shape
    assert_close(out, ref, rtol=1e-4, atol=1e-4 * np.abs(np.asarray(ref)).max())


@pytest.mark.parametrize("num_fft,hop", [(1023, 256), (63, 16)])
def test_encode1d_decode1d_match_jax_and_round_trip(num_fft, hop):
    x = waves(2, 1, 2, 5000)
    ref = JSTFT(num_fft, hop).encode1d(jnp.asarray(x))
    stft = STFT(num_fft, hop)
    pair = stft.encode1d(torch.from_numpy(x))
    assert pair.shape == ref.shape == (1, 2 * 2 * (num_fft // 2 + 1), pair.shape[-1])
    half = pair.shape[1] // 2
    scale = float(np.abs(np.asarray(ref)[:, :half]).max())
    assert_close(pair[:, :half], np.asarray(ref)[:, :half], rtol=1e-4, atol=1e-4 * scale)
    back = stft.decode1d(pair, length=x.shape[-1])
    jback = JSTFT(num_fft, hop).decode1d(ref, length=x.shape[-1])
    assert back.shape == x.shape
    peak = np.abs(x).max()
    assert_close(back, x, rtol=0, atol=1e-5 * peak)
    assert_close(back, jback, rtol=0, atol=1e-5 * peak)


def stft_configs(use_stft_context):
    return tiny_model_configs(
        in_channels=2, out_channels=2, context_channels=(3,), use_stft=True,
        use_stft_context=use_stft_context, stft_num_fft=63, stft_hop_length=16)


def stft_models(use_stft_context, seed):
    """The JAX and port tiny STFT UNets with the same random weights, on
    1008-sample stereo waves (63 STFT frames)."""
    jcfg, pcfg = stft_configs(use_stft_context)
    mc = jcfg.model_config
    jmodel = jax_unet(mc)
    ctx_len = 1008 if use_stft_context else 63
    shapes = jax.eval_shape(lambda r: jmodel.init(
        r, jnp.zeros((1, 1008, 2)), jnp.zeros((1,)),
        embedding=jnp.zeros((1, mc.context_embedding_max_length, mc.context_embedding_features)),
        channels_list=[jnp.zeros((1, ctx_len, 3))]), jax.random.PRNGKey(0))
    params = random_params(shapes, seed=seed)
    return jmodel, params, load(port_unet(pcfg.model_config), params), mc, ctx_len


def stft_inputs(mc, ctx_len, seed):
    g = rng(seed)
    m = mc.context_embedding_max_length
    return dict(x=np.transpose(waves(seed, 2, 2, 1008), (0, 2, 1)).copy(),
                t=g.uniform(size=(2,)).astype(np.float32),
                embedding=randn(g, 2, m, mc.context_embedding_features),
                embedding_mask=np.ones((2, m), bool),
                channels=np.transpose(waves(seed + 1, 2, 3, ctx_len), (0, 2, 1)).copy())


@pytest.mark.parametrize("use_stft_context", [False, True])
def test_stft_unet_forward_matches_jax(use_stft_context):
    """Waveform in, waveform out, at the input's length; without
    use_stft_context the context channels sit at the STFT frame rate."""
    jmodel, params, pmodel, mc, ctx_len = stft_models(use_stft_context, seed=5)
    inp = stft_inputs(mc, ctx_len, seed=6)
    ref = jax.jit(lambda p, x, t, e, m, c: jmodel.apply(
        p, x, t, embedding=e, embedding_mask=m, channels_list=[c]))(
        params, inp["x"], inp["t"], inp["embedding"], inp["embedding_mask"], inp["channels"])
    with torch.no_grad():
        out = pmodel(torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"]),
                     embedding=torch.from_numpy(inp["embedding"]),
                     embedding_mask=torch.from_numpy(inp["embedding_mask"]),
                     channels_list=[torch.from_numpy(inp["channels"])])
    assert out.shape == inp["x"].shape
    assert_close(out, ref, **PLAIN)


def test_stft_unet_gradient_matches_jax():
    """d/d(x, params) of sum(out * w) through encode, the UNet and decode,
    against jax.grad."""
    jmodel, params, pmodel, mc, ctx_len = stft_models(True, seed=7)
    inp = stft_inputs(mc, ctx_len, seed=8)
    w = randn(rng(9), *inp["x"].shape)

    def loss(p, x):
        out = jmodel.apply(p, x, inp["t"], embedding=inp["embedding"],
                           embedding_mask=inp["embedding_mask"], channels_list=[inp["channels"]])
        return jnp.sum(out * w)

    ref_p, ref_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, inp["x"])
    x = torch.from_numpy(inp["x"]).requires_grad_()
    out = pmodel(x, torch.from_numpy(inp["t"]), embedding=torch.from_numpy(inp["embedding"]),
                 embedding_mask=torch.from_numpy(inp["embedding_mask"]),
                 channels_list=[torch.from_numpy(inp["channels"])])
    (out * torch.from_numpy(w)).sum().backward()
    ref_x = np.asarray(ref_x)
    assert_close(x.grad, ref_x, rtol=0, atol=LEAF_RTOL * np.abs(ref_x).max())
    refs = dict(load(port_unet(stft_configs(True)[1].model_config), ref_p).named_parameters())
    floor = 1e-5 * max(float(r.detach().abs().max()) for r in refs.values())
    for name, p in pmodel.named_parameters():
        ref = refs[name].detach()
        grad = torch.zeros_like(p) if p.grad is None else p.grad  # the unused null embedding
        bar = LEAF_RTOL * max(float(ref.abs().max()), floor)
        assert float((grad - ref).abs().max()) <= bar, name
