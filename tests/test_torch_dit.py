"""Stable Audio Open in jen1_tpu_torch against the plain fp32 reference
(reference/stable_audio_open.py) at test widths, on seeded weights: the
DiT forward under guidance (both self-attention routes, batched and
unbatched CFG), the two number conditioners, a whole 4-step `generate`
(T5, numbers, the guided VDM sampler, the Oobleck decode), the published
parameter count, and planted faults that each must fail a tolerance.

Tolerances. Both sides compute in fp32 on the CPU; they differ only in the
order of sums (the port is channels-last, the reference (B, C, T)), which
moves a result by about 1e-6 of its norm, so `FP32_REL` = 1e-4 in relative
L2. A planted fault changes the mathematics and moves it by far more
(each case asserts the distance exceeds `FAULT_REL` = 1e-2, a hundred
times the tolerance).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from jen1_tpu_torch.api.generation import Jen1
from jen1_tpu_torch.config import (
    Config,
    stable_audio_open_config,
    tiny_stable_audio_test_config,
    tiny_test_config,
)
from jen1_tpu_torch.models import dit
from reference import stable_audio_open as ref

FP32_REL = 1e-4
FAULT_REL = 1e-2
PUBLISHED_PARAMS = 1_056_828_544


def rel(a, b) -> float:
    a, b = torch.as_tensor(np.asarray(a)).double(), torch.as_tensor(np.asarray(b)).double()
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def pair():
    """A tiny Stable Audio Open Jen1 (fp32) and the reference holding its
    weights."""
    torch.manual_seed(0)
    cfg = tiny_stable_audio_test_config()
    jen1 = Jen1(config=cfg, device="cpu")
    models = ref.build(cfg.to_dict(), "cpu")
    models["dit"].load_state_dict(jen1.model.state_dict(), strict=True)
    models["decoder"].load_state_dict(jen1.codec.decoder.state_dict(), strict=True)
    conds = jen1.conditioner.conditioners
    models["t5"].load_state_dict(conds["prompt"].state_dict(), strict=True)
    for key in ("seconds_start", "seconds_total"):
        models[key].load_state_dict(conds[key].state_dict(), strict=True)
    return jen1, models


def inputs(frames: int, seed: int = 1):
    """x (B, L, C), t, context tokens whose last three are padding (zero
    vectors, as the T5 conditioner makes them), global condition."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, frames, 8, generator=g)
    t = torch.rand(2, generator=g)
    ctx = torch.randn(2, 12, 128, generator=g)
    ctx[:, -3:] = 0.0
    mask = torch.ones(2, 12, dtype=torch.bool)
    mask[:, -3:] = False
    glob = torch.randn(2, 256, generator=g)
    return x, t, ctx, mask, glob


def port(pair, frames=40, scale=7.0, batch_cfg=True):
    x, t, ctx, mask, glob = inputs(frames)
    with torch.no_grad():
        return pair[0].model(x, t, embedding=ctx, embedding_mask=mask, features=glob,
                             embedding_scale=scale, batch_cfg=batch_cfg)


def reference(pair, frames=40, scale=7.0):
    x, t, ctx, _, glob = inputs(frames)
    with torch.no_grad():
        return pair[1]["dit"].guided(x.transpose(1, 2), t, ctx, glob, scale).transpose(1, 2)


@pytest.mark.parametrize("frames,route", [(40, "SELF_ATTN_PLAIN"), (130, "SELF_ATTN_FLASH")])
@pytest.mark.parametrize("batch_cfg", [True, False])
def test_dit_forward_matches_reference(pair, frames, route, batch_cfg):
    """Below 128 tokens (flash_attention_supported) the plain route, above
    it the flash one (its plain version on the CPU); guidance batched or as two
    forwards."""
    before = getattr(dit, route)
    out, want = port(pair, frames, batch_cfg=batch_cfg), reference(pair, frames)
    assert rel(out, want) < FP32_REL
    assert getattr(dit, route) - before == 2 * (1 if batch_cfg else 2)


def test_dit_unguided_forward_matches_reference(pair):
    jen1, models = pair
    x, t, ctx, _, glob = inputs(33)
    with torch.no_grad():
        out = jen1.model(x, t, embedding=ctx, features=glob)
        want = models["dit"](x.transpose(1, 2), t, ctx, glob).transpose(1, 2)
    assert rel(out, want) < FP32_REL


def _rotary_all_dims(model):
    model.rotary_dim = model.layers[0].self_attn.head_dim


def _rotary_interleaved(monkeypatch):
    def interleaved(t, cos, sin):
        r = cos.shape[-1]
        rot = t[..., :r].float()
        pairs = torch.stack([-rot[..., 1::2], rot[..., 0::2]], dim=-1).flatten(-2)
        c = cos[..., : r // 2].repeat_interleave(2, dim=-1)
        s = sin[..., : r // 2].repeat_interleave(2, dim=-1)
        return torch.cat([(rot * c + pairs * s).to(t.dtype), t[..., r:]], dim=-1)

    monkeypatch.setattr(dit, "apply_rotary", interleaved)


def _kv_heads_tiled(monkeypatch):
    """Each query head paired with the wrong kv head: the kv heads tiled
    (0, 1, 0, 1) where repeat_interleave gives (0, 0, 1, 1)."""
    def forward(self, x, context):
        b, n, c = x.shape
        d, rep = self.head_dim, self.heads // self.kv_heads
        q = self.to_q(x).reshape(b, n, self.heads, d).transpose(1, 2)
        k, v = self.to_kv(context).reshape(b, -1, 2, self.kv_heads, d).permute(2, 0, 3, 1, 4).unbind(0)
        out = dit.dot_product_attention(q, k.repeat(1, rep, 1, 1), v.repeat(1, rep, 1, 1))
        return self.to_out(out.transpose(1, 2).reshape(b, n, c))

    monkeypatch.setattr(dit.CrossAttention, "forward", forward)


def _context_mask(monkeypatch, mask):
    """The cross-attention's padded tokens masked out of the softmax."""
    def forward(self, x, context):
        b, n, c = x.shape
        d, rep = self.head_dim, self.heads // self.kv_heads
        q = self.to_q(x).reshape(b, n, self.heads, d).transpose(1, 2)
        k, v = self.to_kv(context).reshape(b, -1, 2, self.kv_heads, d).permute(2, 0, 3, 1, 4).unbind(0)
        k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
        keep = torch.cat([mask, mask])[: b, None, None, :]
        logits = (q @ k.transpose(-1, -2)) * d ** -0.5
        probs = torch.softmax(logits.masked_fill(~keep, float("-inf")), dim=-1)
        return self.to_out((probs @ v).transpose(1, 2).reshape(b, n, c))

    monkeypatch.setattr(dit.CrossAttention, "forward", forward)


def _learned_null(monkeypatch):
    """The unconditional rows given a learned (here: fixed random) null
    embedding in place of zeros."""
    null = torch.randn(12, 128, generator=torch.Generator().manual_seed(9))
    # torch.zeros_like makes the DiT's null tokens; only the port runs under the patch
    monkeypatch.setattr(torch, "zeros_like", lambda e: null.expand_as(e).to(e.dtype))


@pytest.mark.parametrize("fault", ["rotary_all_dims", "rotary_interleaved", "kv_heads_tiled",
                                   "context_mask", "learned_null"])
def test_planted_dit_fault_fails_the_tolerance(pair, monkeypatch, fault):
    """Each fault planted in the port alone; the reference runs first."""
    jen1, _ = pair
    want = reference(pair, 40)
    _, _, _, mask, _ = inputs(40)
    if fault == "rotary_all_dims":
        monkeypatch.setattr(jen1.model, "rotary_dim", jen1.model.rotary_dim)
        _rotary_all_dims(jen1.model)
    elif fault == "rotary_interleaved":
        _rotary_interleaved(monkeypatch)
    elif fault == "kv_heads_tiled":
        _kv_heads_tiled(monkeypatch)
    elif fault == "context_mask":
        _context_mask(monkeypatch, mask)
    else:
        _learned_null(monkeypatch)
    assert rel(port(pair, 40), want) > FAULT_REL


@pytest.mark.parametrize("key,values", [("seconds_start", [0.0, 10.5, 47.0, 600.0]),
                                        ("seconds_total", [-3.0, 1.0, 47.0, 511.9])])
def test_number_conditioners_match_reference(pair, key, values):
    """Clamped to [0, 512], normalised, Fourier features, Linear."""
    jen1, models = pair
    emb, mask = jen1.conditioner.conditioners[key](values)
    with torch.no_grad():
        want = models[key](values)
    assert emb.shape == want.shape == (4, 1, 128)
    assert rel(emb, want) < FP32_REL and bool(mask.all())


def test_generate_matches_reference(pair):
    """A whole 4-step request: T5, the number conditioners (tokens and the
    global condition), the VDM sampler with CFG 7 on zeroed null tokens,
    the Oobleck decode a clip at a time; x_T drawn as the sampler draws it."""
    jen1, models = pair
    caps, steps, frames = ["a slow piano", "drums and a bass line at 120 bpm"], 4, 50
    out = jen1.generate(caps, seed=5, steps=steps, batch_size=2, seconds=frames * 8 / 44_100,
                        seconds_start=3, seconds_total=47)
    noise = torch.randn((2, frames, 8), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = ref.generate(models, jen1.config.to_dict(), caps, noise.transpose(1, 2), steps,
                            3, 47).numpy()
    assert out.shape == want.shape == (2, 2, frames * 8)
    assert rel(out, want) < FP32_REL
    fp8 = None
    with torch.no_grad(), ref.lower_precision():
        fp8 = ref.generate(models, jen1.config.to_dict(), caps, noise.transpose(1, 2), steps,
                           3, 47).numpy()
    assert rel(fp8, want) > FAULT_REL  # the control the benchmark's limit has to fail


def test_generate_defaults_feed_seconds(pair):
    """Without seconds_start / seconds_total Stable Audio Open takes 0 and
    the clip's length, as given explicitly."""
    jen1, _ = pair
    kw = dict(seed=2, steps=2, batch_size=1, seconds=40 * 8 / 44_100)
    a = jen1.generate("rain", **kw)
    b = jen1.generate("rain", seconds_start=0, seconds_total=40 * 8 / 44_100, **kw)
    c = jen1.generate("rain", seconds_start=0, seconds_total=47, **kw)
    np.testing.assert_array_equal(a, b)
    assert rel(c, b) > 10 * FP32_REL  # the number reaches the audio


@pytest.mark.parametrize("kw", [dict(task="music_inpaint", inpainting_scope=(0.0, 0.001)),
                                dict(task="music_cont"), dict(task="text_guided")])
def test_tasks_that_need_the_encoder_are_refused(pair, kw):
    jen1, _ = pair
    clip = np.zeros((160, 2), np.float32)
    with pytest.raises(NotImplementedError, match="encoder"):
        jen1.generate("x", steps=1, seconds=320 / 44_100, init_audio=clip, **kw)


def test_published_widths_parameter_count():
    """1,056,828,544 DiT parameters at the published widths (the LayerNorm
    shifts and the rotary frequencies are no parameters), on the meta
    device."""
    with torch.device("meta"):
        model = dit.DiffusionTransformer(stable_audio_open_config().dit_config)
        ref_model = ref.DiT(stable_audio_open_config().to_dict()["dit_config"])
    assert sum(p.numel() for p in model.parameters()) == PUBLISHED_PARAMS
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {k: tuple(v.shape) for k, v in ref_model.state_dict().items()}
    assert model.rotary_dim == 32 and model.layers[0].cross_attn.kv_heads == 12


def test_preset_builds_the_published_conditioning():
    cfg = stable_audio_open_config()
    assert (cfg.denoiser, cfg.codec_type, cfg.oobleck_config.sample_rate) == (
        "dit", "oobleck", 44_100)
    assert cfg.oobleck_config.hop_length == 2048
    assert cfg.diffusion_config.variational_diffusion.embedding_scale == 7.0
    roundtrip = Config.from_dict(cfg.to_dict())
    assert roundtrip == cfg


def test_jen1_configs_build_the_unet_and_encodec():
    """A JEN-1 config builds what it built before: the CFG UNet, EnCodec
    48 kHz, the masked-input concat conditioning."""
    from jen1_tpu_torch.codec.model import EncodecModel
    from jen1_tpu_torch.models.unet import UNetCFG1d

    jen1 = Jen1(config=tiny_test_config(), device="cpu")
    assert isinstance(jen1.model, UNetCFG1d) and isinstance(jen1.codec, EncodecModel)
    assert jen1.sample_rate == 48_000 and jen1.compute_dtype == torch.float32
    assert (jen1.cross_attn_cond_ids, jen1.global_cond_ids, jen1.input_concat_ids) == (
        ("prompt",), (), ("masked_input", "mask"))


def test_graph_counters_include_the_dit():
    from jen1_tpu_torch.utils import cuda_graphs

    names = {name for (mod, name) in cuda_graphs._counters() if mod is dit}
    assert names == set(dit.COUNTERS)


def test_rotary_matches_published_rotate_half():
    """Half-split pairs (i, i + 16) over the first 32 dims, base 10000;
    the rest passes unchanged."""
    from jen1_tpu_torch.ops.rotary import apply_rotary, rotary_tables

    t = torch.randn(1, 2, 5, 64, generator=torch.Generator().manual_seed(3))
    cos, sin = rotary_tables(5, 32, 10_000.0, "cpu")
    inv = 1.0 / 10_000 ** (torch.arange(0, 32, 2).float() / 32)
    freqs = torch.arange(5).float()[:, None] * inv[None]
    want = ref._rotary(t, torch.cat([freqs, freqs], dim=-1))
    out = apply_rotary(t, cos, sin)
    assert rel(out, want) < 1e-6 and torch.equal(out[..., 32:], t[..., 32:])
    assert not torch.allclose(out[..., :32], t[..., :32])
    assert F.cosine_similarity(out[0, 0, 0], t[0, 0, 0], dim=0) > 0.999  # position 0
