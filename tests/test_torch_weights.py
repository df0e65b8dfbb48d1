"""Port parity of weight loading: jen1_tpu_torch `Jen1(ckpt_path=...)` with a
reference JEN-1 `.pth` and with a checkpoint directory of the port's trainer
(`use_ema_params`), `weights_dtype="bfloat16"`, the T5 conditioner's
`weights_path` and the codec's `codec_weights_path`, against jen1_tpu on
the same files.

Bars: UNet forward rtol 2e-3 / atol 2e-4; whole generate() rtol 2e-2 /
atol 2e-3 with the JAX draws injected; T5 embeddings and the codec's
encode and decode 1e-4, masks and RVQ codes equal; a checkpoint
directory's weights, and bf16 storage under bf16 compute, bit-identical.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jen1_tpu.api.generation import cast_weights_bf16 as jax_cast_weights_bf16
from jen1_tpu.ckpt.checkpoint import CheckpointManager as JaxCheckpointManager
from jen1_tpu.codec import model as jax_codec
from jen1_tpu.codec import torch_keys as jax_torch_keys
from jen1_tpu.conditioning import conditioners as jax_cond
from jen1_tpu.conditioning import t5 as jax_t5
from jen1_tpu.models.unet import unet_from_model_config as jax_unet
from jen1_tpu_torch.api.generation import Jen1, cast_weights_bf16
from jen1_tpu_torch.ckpt.checkpoint import CheckpointManager
from jen1_tpu_torch.ckpt.from_jax import _target
from jen1_tpu_torch.ckpt.torch_export import save_reference_checkpoint
from jen1_tpu_torch.codec import model as port_codec
from jen1_tpu_torch.codec import torch_keys as port_torch_keys
from jen1_tpu_torch.conditioning import conditioners as port_cond
from jen1_tpu_torch.conditioning import t5 as port_t5
from jen1_tpu_torch.config import tiny_test_config
from jen1_tpu_torch.diffusion import vdm as port_vdm
from jen1_tpu_torch.models.unet import unet_from_model_config as port_unet
from jen1_tpu_torch.train.train import build_trainer
from torch_port_util import (
    TINY_CODEC, assert_close, flash_model_configs, hf_t5_state_dict, jen1_pair, load,
    one_torch_thread, randn, random_params, rng, synthetic_clip, unet_shapes,
    vdm_initial_noise,
)

PLAIN = dict(rtol=2e-3, atol=2e-4)
SAMPLER = dict(rtol=2e-2, atol=2e-3)
CODEC = dict(rtol=1e-4, atol=1e-4)
SR, SECONDS, STEPS, SEED = 1600, 13, 2, 3


# ------------------------------------------------- reference .pth file


@pytest.fixture(scope="module")
def reference_pth(tmp_path_factory):
    """A reference-format .pth of random weights for the tiny flash model,
    written by the port's exporter (tied transformer projections)."""
    jcfg, _ = flash_model_configs()
    mc = dataclasses.replace(jcfg.model_config, tie_transformer_projections=True)
    params = random_params(unet_shapes(jax_unet(mc), mc), seed=4)
    path = tmp_path_factory.mktemp("ref") / "Jen1_step_10_loss_0.1.pth"
    save_reference_checkpoint(str(path), params, mc, epoch=3, learning_rate=1e-4)
    return str(path)


@pytest.fixture(scope="module")
def reference_pair(reference_pth):
    with pytest.warns(UserWarning, match="tie_transformer_projections"):
        with one_torch_thread():
            yield jen1_pair(ckpt_path=reference_pth)


def test_reference_pth_switches_flags_as_jax(reference_pair):
    jj, pj = reference_pair
    for j in (jj, pj):
        assert j.config.model_config.tie_transformer_projections
        assert j.config.codec_segmented_latents


def test_reference_pth_unet_forward_matches_jax(reference_pair):
    jj, pj = reference_pair
    mc = pj.config.model_config
    g = rng(5)
    m = mc.context_embedding_max_length
    x, t = randn(g, 2, 48, mc.in_channels), g.uniform(size=(2,)).astype(np.float32)
    emb, ch = randn(g, 2, m, mc.context_embedding_features), randn(g, 2, 48, 9)
    ref = jax.jit(lambda p: jj.model.apply(p, x, t, embedding=emb, channels_list=[ch]))(
        jj._load_params(48))
    with torch.no_grad():
        out = pj.model(torch.from_numpy(x), torch.from_numpy(t),
                       embedding=torch.from_numpy(emb), channels_list=[torch.from_numpy(ch)])
    assert_close(out, np.asarray(ref), **PLAIN)


def test_reference_pth_generate_matches_jax(reference_pair, monkeypatch):
    jj, pj = reference_pair
    ref = np.asarray(jj.generate("a reference song", seed=SEED, steps=STEPS, seconds=SECONDS))
    frames = pj.latent_frames(SECONDS * SR)  # the segmented encoder's grid
    noise = torch.from_numpy(vdm_initial_noise(SEED, (1, frames, 8)))
    monkeypatch.setattr(port_vdm, "initial_noise", lambda shape, generator, device: noise)
    with one_torch_thread():
        out = pj.generate("a reference song", seed=SEED, steps=STEPS, seconds=SECONDS)
    assert out.shape == ref.shape == (1, 2, frames * 40)
    assert np.isfinite(out).all()
    assert_close(out, ref, **SAMPLER)


# ------------------------------------------- port checkpoint directory


def tiny_config(use_ema: bool, dtype: str = "float32"):
    cfg = tiny_test_config()
    cfg.model_config = dataclasses.replace(cfg.model_config, dtype=dtype)
    cfg.conditioner_config.t5_config.t5_model_name = "tiny-test"
    cfg.conditioner_config.t5_config.max_length = cfg.model_config.context_embedding_max_length
    cfg.use_ema, cfg.ema_decay = use_ema, 0.5
    return cfg


def trained_dir(tmp_path, use_ema: bool):
    """Two steps of a tiny trainer, saved: (directory, trainer, state)."""
    cfg = tiny_config(use_ema)
    trainer = build_trainer(cfg, device="cpu")
    state = trainer.init_state()
    g = rng(6)
    latents = randn(g, 3, 48, 8)
    meta = [{"prompt": f"song {i}"} for i in range(3)]
    batch = trainer.prepare_batch(latents, meta)
    for i in range(2):
        state, _ = trainer.train_step(state, batch, torch.Generator().manual_seed(i),
                                      np.random.default_rng(i))
    path = tmp_path / "ckpts"
    CheckpointManager(str(path)).save(state.step, trainer.state_dict(state), loss=1.0)
    return str(path), trainer, state


def tiny_jen1(path, cfg, **kw):
    return Jen1(path, sample_rate=SR, config=cfg, codec=port_codec.EncodecModel(
        port_codec.EncodecConfig(**TINY_CODEC), device="cpu"), device="cpu", **kw)


@pytest.mark.parametrize("use_ema_params", [False, True], ids=["params", "ema_params"])
def test_checkpoint_dir_loads_bit_identical(tmp_path, use_ema_params):
    path, trainer, state = trained_dir(tmp_path, use_ema=True)
    jen1 = tiny_jen1(path, tiny_config(True), use_ema_params=use_ema_params)
    want = state.ema_params if use_ema_params else trainer.params
    assert not all(torch.equal(a, b) for a, b in zip(state.ema_params, trainer.params))
    for (name, p), w in zip(jen1.model.named_parameters(), want):
        assert torch.equal(p, w), name


def test_ema_params_missing_raises(tmp_path):
    path, _, _ = trained_dir(tmp_path, use_ema=False)
    with pytest.raises(ValueError, match="no ema_params"):
        tiny_jen1(path, tiny_config(False), use_ema_params=True)


@pytest.mark.parametrize("kind", ["orbax_run_dir", "empty_dir", "missing"])
def test_foreign_directory_raises(tmp_path, kind):
    """What is neither a port checkpoint directory nor a reference file
    raises a ValueError that names the two formats the port reads."""
    path = tmp_path / "run"
    if kind == "orbax_run_dir":
        JaxCheckpointManager(str(path)).save(1, {"params": {"w": np.ones(2, np.float32)}},
                                             loss=0.1)
    elif kind == "empty_dir":
        path.mkdir()
    with pytest.raises(ValueError, match=r"state\.pt.*\.pth.*Orbax"):
        tiny_jen1(str(path), tiny_config(False))


# --------------------------------------------------------- bf16 weights


def test_bf16_weights_are_bit_identical_under_bf16_compute(tmp_path):
    path, _, _ = trained_dir(tmp_path, use_ema=False)
    cfg = tiny_config(False, dtype="bfloat16")
    a, b = tiny_jen1(path, cfg), tiny_jen1(path, cfg, weights_dtype="bfloat16")
    dtypes = {p.dtype for p in b.model.parameters()}
    assert dtypes == {torch.float32, torch.bfloat16}
    mc = cfg.model_config
    g = rng(7)
    x = torch.from_numpy(randn(g, 2, 48, mc.in_channels)).bfloat16()
    t = torch.from_numpy(g.uniform(size=(2,)).astype(np.float32))
    emb = torch.from_numpy(randn(g, 2, 6, mc.context_embedding_features)).bfloat16()
    ch = torch.from_numpy(randn(g, 2, 48, 9)).bfloat16()
    with torch.no_grad():
        fa, fb = (j.model(x, t, embedding=emb, channels_list=[ch]) for j in (a, b))
    assert fa.dtype == torch.bfloat16 and torch.equal(fa, fb)
    kw = dict(seed=5, steps=2, seconds=2)
    with one_torch_thread():
        out_a, out_b = a.generate("same song", **kw), b.generate("same song", **kw)
    assert np.isfinite(out_a).all() and np.array_equal(out_a, out_b)


def test_bf16_cast_set_matches_jax():
    """The port casts the parameters whose JAX leaves `cast_weights_bf16`
    makes bf16, under ckpt/from_jax.py's name map."""
    jcfg, pcfg = flash_model_configs()
    mc = jcfg.model_config
    params = random_params(unet_shapes(jax_unet(mc), mc), seed=8)
    cast = jax_cast_weights_bf16(jax.tree.map(jnp.asarray, params))  # {"params": ...}
    model = load(port_unet(pcfg.model_config), params)
    want = set()
    for keypath, leaf in jax.tree_util.tree_flatten_with_path(cast)[0]:
        if leaf.dtype == jnp.bfloat16:
            # from_jax's map: the leaf's module path, its torch parameter name
            mod_path, name = ".".join(str(k.key) for k in keypath[1:]).rsplit(".", 1)
            target, _ = _target(model.get_submodule(mod_path), name,
                                np.asarray(leaf, np.float32))
            want.add(f"{mod_path}.{target}")
    got = set(cast_weights_bf16(model))
    assert want and got == want
    assert {n for n, p in model.named_parameters() if p.dtype == torch.bfloat16} == want


# ------------------------------------------------------------ T5 weights


@pytest.mark.parametrize("ffn,embed_key", [("gated-gelu", "shared.weight"),
                                           ("relu", "encoder.embed_tokens.weight")])
def test_t5_weights_path_matches_jax(tmp_path, monkeypatch, ffn, embed_key):
    """Both FFN forms and both embedding names: the JAX and the port
    T5Conditioner(weights_path=...) give the same embeddings and masks."""
    for module in (jax_t5, port_t5):
        tiny = module.T5EncoderConfig.tiny_test
        monkeypatch.setattr(module.T5EncoderConfig, "tiny_test", classmethod(
            lambda cls, _tiny=tiny: dataclasses.replace(_tiny(), feed_forward_proj=ffn,
                                                        vocab_size=259)))
    cfg = port_t5.T5EncoderConfig.tiny_test()
    path = tmp_path / "t5.bin"
    torch.save({"state_dict": hf_t5_state_dict(9, cfg, embed_key)}, path)
    jt5 = jax_cond.T5Conditioner(output_dim=16, t5_model_name="tiny-test", max_length=8,
                                 weights_path=str(path))
    pt5 = port_cond.T5Conditioner(16, "tiny-test", 8, weights_path=str(path), device="cpu")
    load(pt5.proj, jt5.params["proj"])
    texts = ["a calm piano melody", "techno"]
    jemb, jmask = jt5(texts)
    pemb, pmask = pt5(texts)
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
    assert_close(pemb, np.asarray(jemb), **CODEC)
    assert pt5.encoder.embedding.shape == (259, cfg.d_model)


# --------------------------------------------------------- codec weights

CODEC_CFG = dict(TINY_CODEC, normalize=True, segment=1.0, overlap=0.01)


def codec_outputs(jcodec, pcodec, seed: int):
    """(JAX, port) pairs of the whole-clip latent, the decode of a latent
    and the per-segment RVQ codes of a seeded clip."""
    clip = synthetic_clip(seed, 2.5, SR)[None]  # 4000 samples, three segments
    z = randn(rng(seed), 1, 30, 8)
    with one_torch_thread():
        pairs = {
            "encode_latent": (jcodec.encode_latent(jnp.asarray(clip)),
                              pcodec.encode_latent(torch.from_numpy(clip))),
            "decode_latent": (jcodec.decode_latent(jnp.asarray(z)),
                              pcodec.decode_latent(torch.from_numpy(z))),
        }
        jframes, pframes = jcodec.encode(jnp.asarray(clip)), pcodec.encode(torch.from_numpy(clip))
    codes = [(np.asarray(j[0]), p[0].numpy()) for j, p in zip(jframes, pframes)]
    return pairs, codes


def check_codecs(path, norm: str, n_q: int = TINY_CODEC["n_q"]):
    kw = dict(CODEC_CFG, norm=norm, n_q=n_q)
    jcfg, pcfg = jax_codec.EncodecConfig(**kw), port_codec.EncodecConfig(**kw)
    jcodec = jax_codec.make_codec(str(path), jcfg)
    pcodec = port_codec.make_codec(str(path), pcfg, device="cpu")
    pairs, codes = codec_outputs(jcodec, pcodec, 11)
    for name, (ref, out) in pairs.items():
        assert out.shape == tuple(ref.shape), name
        assert_close(out, np.asarray(ref), **CODEC)
    assert len(codes) == 3
    for ref, out in codes:
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("norm,spelling", [
    ("weight_norm", "weight_g"), ("weight_norm", "parametrizations"),
    ("time_group_norm", "weight_g"),
])
def test_fb_encodec_weights_match_jax(tmp_path, norm, spelling):
    """tests/encodec_torch_mock.py's facebookresearch-layout model at tiny
    widths: weight-normalized convs fused, GroupNorm params, the
    `parametrizations.weight.original0/1` spelling renamed."""
    from encodec_torch_mock import MockEncodec

    torch.manual_seed(0)
    mock = MockEncodec(**{k: v for k, v in CODEC_CFG.items() if k != "sample_rate"},
                       sample_rate=SR, norm=norm)
    sd = mock.state_dict()
    if spelling == "parametrizations":
        sd = {re.sub(r"\.weight_g$", ".parametrizations.weight.original0",
                     re.sub(r"\.weight_v$", ".parametrizations.weight.original1", k)): v
              for k, v in sd.items()}
        assert any(".parametrizations.weight.original0" in k for k in sd)
    path = tmp_path / "encodec.pt"
    torch.save(sd, path)
    check_codecs(path, norm)


@pytest.mark.parametrize("norm_type", ["time_group_norm", "weight_norm"])
def test_hf_encodec_weights_match_jax(tmp_path, norm_type):
    """The HF `transformers` EncodecModel layout, as tests/
    test_hf_codec_parity.py builds it, detected and remapped by both."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.EncodecConfig(
        sampling_rate=SR, audio_channels=2, hidden_size=8, num_filters=2,
        num_residual_layers=1, upsampling_ratios=[5, 4, 2], codebook_size=16,
        codebook_dim=8, target_bandwidths=[0.5, 1.0], normalize=True, chunk_length_s=1.0,
        overlap=0.01, norm_type=norm_type, use_causal_conv=False)
    torch.manual_seed(0)
    sd = transformers.EncodecModel(hf_cfg).eval().state_dict()
    n_q = len({k.split(".")[2] for k in sd if k.startswith("quantizer.layers.")})
    path = tmp_path / "hf_encodec.bin"
    torch.save(sd, path)
    check_codecs(path, norm_type, n_q)


@pytest.mark.parametrize("n_stages,n_q,norm", [(4, 16, "time_group_norm"),
                                               (3, 2, "weight_norm"), (2, 4, "none")])
def test_expected_torch_keys_equal_jax(n_stages, n_q, norm):
    assert port_torch_keys.expected_torch_keys(n_stages, n_q, norm) == \
        jax_torch_keys.expected_torch_keys(n_stages, n_q, norm)


def test_coverage_report_equals_jax():
    from encodec_torch_mock import MockEncodec

    mock = MockEncodec(**{k: v for k, v in CODEC_CFG.items() if k != "sample_rate"},
                       sample_rate=SR, norm="weight_norm")
    keys = list(mock.state_dict()) + ["stray.key"]
    cfg = port_codec.EncodecConfig(**CODEC_CFG, norm="weight_norm")
    recorded = port_codec._RecordingDict(mock.state_dict())
    port_codec.convert_torch_encodec(recorded, cfg)
    args = (keys, recorded.consumed, 3, 2)
    report = port_torch_keys.coverage_report(*args)
    assert report == jax_torch_keys.coverage_report(*args)
    assert report["unexplained"] == ["stray.key"] and report["norm"] == "weight_norm"
