"""Port parity of Composer (multi-track): jen1_tpu_torch's models/composer.py,
models/normalizer.py, the track_gen task, the Composer presets and
`Jen1.generate_tracks` against jen1_tpu on the CPU.

The track_gen keep-bits, like every other draw, are rebuilt from JAX's keys
and injected. Bars: masks and split/stacked latents equal exactly; the
Normalizer's moments rtol 1e-6; the train step at the train bars of
tests/test_torch_train.py; generate_tracks at the sampler-trajectory bar
(rtol 2e-2, atol 2e-3) of tests/test_torch_generation.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jen1_tpu.config import composer_config as jax_composer_config
from jen1_tpu.config import tiny_composer_test_config as jax_tiny_composer
from jen1_tpu.diffusion.gdm import create_gaussian_diffusion as jax_gdm
from jen1_tpu.models import composer as jax_composer
from jen1_tpu.models.normalizer import Normalizer as JaxNormalizer
from jen1_tpu.models.unet import unet_from_model_config as jax_unet
from jen1_tpu.train.tasks import random_task_mask as jax_random_task_mask
from jen1_tpu.train.trainer import UnifiedMultiTaskTrainer as JaxTrainer
from jen1_tpu_torch.config import composer_config, tiny_composer_test_config
from jen1_tpu_torch.diffusion.gdm import create_gaussian_diffusion
from jen1_tpu_torch.models import composer
from jen1_tpu_torch.models.normalizer import Normalizer
from jen1_tpu_torch.models.unet import unet_from_model_config as port_unet
from jen1_tpu_torch.train import tasks
from jen1_tpu_torch.train.trainer import UnifiedMultiTaskTrainer
from test_torch_train import (
    LOSS, Coin, assert_grads_close, jax_mask_draws, jax_step_draws, shared_fields, step_batch,
)
from torch_port_util import (
    TINY_CODEC, assert_close, gdm_draws, inject_gdm_draws, load, np_tree, one_torch_thread,
    random_params, randn, rng, synthetic_clip, unet_shapes,
)

TRACK_CODEC = dict(TINY_CODEC, dimension=4)
SECONDS, STEPS = 4, 2  # 160 latent frames: two chunks in the chunked codec
BAR = dict(rtol=2e-2, atol=2e-3)


def jax_bits(key, n_tracks):
    return np.array(jax.random.bernoulli(key, 0.5, (n_tracks,)))


@pytest.mark.parametrize("keep", [(), (1,), (0, 2), (0, 1, 2)])
def test_track_mask_matches_jax(keep):
    ref = np.asarray(jax_composer.track_mask(2, 7, 3, keep))
    out = composer.track_mask(2, 7, 3, keep)
    assert out.shape == (2, 7, 3)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_random_track_mask_matches_jax_given_its_bits():
    """The bits JAX draws from a key, injected, give JAX's mask; an
    all-kept draw becomes all-hidden; random_task_mask('track_gen') equals
    random_track_mask."""
    seen_all_kept = False
    for seed in range(120):
        key = jax.random.PRNGKey(seed)
        bits = jax_bits(key, 3)
        seen_all_kept |= bool(bits.all())
        ref = np.asarray(jax_composer.random_track_mask(key, 2, 5, 3))
        out = composer.track_bits_mask(torch.from_numpy(bits), 2, 5)
        np.testing.assert_array_equal(out.numpy(), ref)
        np.testing.assert_array_equal(
            tasks.task_mask("track_gen", 2, 5, n_tracks=3, track_bits=torch.from_numpy(bits))
            .numpy(), np.asarray(jax_random_task_mask(key, 2, 5, "track_gen", n_tracks=3)))
    assert seen_all_kept
    assert not composer.track_bits_mask(torch.ones(3, dtype=torch.bool), 1, 2).any()
    gen = torch.Generator().manual_seed(0)
    m = tasks.random_task_mask(gen, 2, 5, "track_gen", n_tracks=4)
    assert m.shape == (2, 5, 4) and not m.all()
    with pytest.raises(ValueError, match="n_tracks > 1"):
        tasks.task_mask("track_gen", 2, 5, track_bits=torch.ones(1))


def test_temporal_masks_tile_over_tracks():
    key = jax.random.PRNGKey(3)
    for task in ("music_inpaint", "music_cont"):
        ref = np.asarray(jax_random_task_mask(key, 2, 30, task, n_tracks=3))
        out = tasks.task_mask(task, 2, 30, *jax_mask_draws(key, 30, task), n_tracks=3)
        np.testing.assert_array_equal(out.numpy(), ref)
    assert tasks.task_is_causal("track_gen", True) is False
    assert tasks.COMPOSER_TASKS == ("text_guided", "music_inpaint", "music_cont", "track_gen")


def test_stack_split_and_conditioning_match_jax():
    g = rng(0)
    tracks = [randn(g, 2, 6, 4) for _ in range(3)]
    ref = np.asarray(jax_composer.stack_tracks([jnp.asarray(t) for t in tracks]))
    out = composer.stack_tracks([torch.from_numpy(t) for t in tracks])
    np.testing.assert_array_equal(out.numpy(), ref)
    for a, b in zip(composer.split_tracks(out, 3), jax_composer.split_tracks(jnp.asarray(ref), 3)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    mask = jax_composer.track_mask(2, 6, 3, (1,))
    mi, mc = jax_composer.composer_conditioning(jnp.asarray(ref), mask, 4)
    pmi, pmc = composer.composer_conditioning(out, torch.from_numpy(np.array(mask)), 4)
    np.testing.assert_array_equal(pmi.numpy(), np.asarray(mi))
    np.testing.assert_array_equal(pmc.numpy(), np.asarray(mc))


def test_normalizer_matches_jax_and_files_cross_load(tmp_path):
    g = rng(1)
    batches = [(3.0 + 2.0 * randn(g, 2, 9, 5)) for _ in range(3)]
    port, ref = Normalizer.fit(batches), JaxNormalizer.fit(batches)
    assert_close(port.mean, np.asarray(ref.mean), rtol=1e-6, atol=0)
    assert_close(port.std, np.asarray(ref.std), rtol=1e-6, atol=0)
    x = randn(g, 2, 4, 5)
    assert_close(port(torch.from_numpy(x)), ref(jnp.asarray(x)), rtol=1e-6, atol=1e-6)
    assert_close(port.inverse(torch.from_numpy(x)), ref.inverse(jnp.asarray(x)),
                 rtol=1e-6, atol=1e-6)
    port.save(str(tmp_path / "port.npz"))
    ref.save(str(tmp_path / "jax.npz"))
    from_port, from_jax = JaxNormalizer.load(str(tmp_path / "port.npz")), Normalizer.load(
        str(tmp_path / "jax.npz"))
    np.testing.assert_array_equal(np.asarray(from_port.mean), port.mean.numpy())
    np.testing.assert_array_equal(from_jax.std.numpy(), np.asarray(ref.std))
    with pytest.raises(ValueError, match="not fitted"):
        Normalizer()(torch.zeros(1, 5))


@pytest.mark.parametrize("which", ["composer_config", "tiny_composer_test_config"])
@pytest.mark.parametrize("n_tracks", [2, 4])
def test_presets_equal_jax(which, n_tracks):
    port = (composer_config if which == "composer_config" else tiny_composer_test_config)(n_tracks)
    ref = (jax_composer_config if which == "composer_config" else jax_tiny_composer)(n_tracks)
    shared_fields(port, ref)


@pytest.fixture(scope="module")
def composer_models():
    jcfg, pcfg = jax_tiny_composer(3), tiny_composer_test_config(3)
    jmodel = jax_unet(jcfg.model_config)
    params = random_params(unet_shapes(jmodel, jcfg.model_config), seed=21)
    return jcfg, pcfg, jmodel, params, load(port_unet(pcfg.model_config), params)


def test_track_gen_train_step_matches_jax(composer_models, coin=1):
    """One Composer step (3 tracks, the four tasks, batch 4; text_guided
    causal, so track_gen shares the bidirectional forward with
    music_inpaint): JAX's value_and_grad of _multi_task_loss against the
    port's train_step with JAX's draws, the track_gen keep-bits among them."""
    jcfg, pcfg, jmodel, params, pmodel = composer_models
    jtrainer = JaxTrainer(jcfg, jmodel, jax_gdm(jcfg.diffusion_config.gaussian_diffusion))
    model = port_unet(pcfg.model_config)
    model.load_state_dict(pmodel.state_dict())
    ptrainer = UnifiedMultiTaskTrainer(
        pcfg, model, create_gaussian_diffusion(pcfg.diffusion_config.gaussian_diffusion),
        device="cpu")
    g = rng(coin)
    mc = jcfg.model_config
    batch = step_batch(mc, 48, seed=coin)
    batch = {"latents": randn(g, 4, 48, mc.in_channels),
             "text_emb": np.concatenate([batch["text_emb"], batch["text_emb"][:1]]),
             "text_mask": np.concatenate([batch["text_mask"], batch["text_mask"][:1]])}
    key = jax.random.PRNGKey(60 + coin)
    flags = jtrainer._causal_flags(Coin(coin))

    def loss_fn(p):
        return jtrainer._multi_task_loss(p, batch["latents"], batch["text_emb"],
                                         batch["text_mask"], key, flags)

    (total, per_task), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params["params"])
    draws = jax_step_draws(ptrainer, key, flags, batch["latents"].shape)
    k_mask = jax.random.split(jax.random.fold_in(key, 3), 3)[0]
    draws.track_bits["track_gen"] = torch.from_numpy(jax_bits(k_mask, 3))
    ptrainer.draw_randoms = lambda *args: draws
    _, metrics = ptrainer.train_step(
        ptrainer.init_state(), {k: torch.from_numpy(v) for k, v in batch.items()}, None,
        Coin(coin))
    assert set(per_task) == {"text_guided", "music_inpaint", "music_cont", "track_gen"}
    assert_close(metrics["loss/train"], total, **LOSS)
    for task, value in per_task.items():
        assert_close(metrics[f"loss_{task}/train"], value, **LOSS)
    assert_close(metrics["grad_norm"], optax.global_norm(grads), **LOSS)
    ref_grads = load(port_unet(pcfg.model_config), {"params": grads})
    assert_grads_close(model, dict(ref_grads.named_parameters()))


def test_draw_randoms_draws_track_bits(composer_models):
    _, pcfg, _, _, pmodel = composer_models
    trainer = UnifiedMultiTaskTrainer(
        pcfg, pmodel, create_gaussian_diffusion(pcfg.diffusion_config.gaussian_diffusion),
        device="cpu")
    draws = trainer.draw_randoms(torch.Generator().manual_seed(0), (False,) * 4, (4, 20, 12))
    assert set(draws.track_bits) == {"track_gen"}
    assert draws.track_bits["track_gen"].shape == (3,)
    assert "track_gen" not in draws.mask_len


@pytest.fixture(scope="module")
def composer_pair(composer_models):
    """JAX and port Jen1s of the tiny Composer config (3 tracks of 4
    latent dims) with the same UNet, T5 and codec weights."""
    from jen1_tpu.api.generation import Jen1 as JJen1
    from jen1_tpu.codec.model import EncodecConfig as JCodecConfig, EncodecModel as JCodec
    from jen1_tpu.conditioning import conditioners as jcond
    from jen1_tpu_torch.api.generation import Jen1
    from jen1_tpu_torch.ckpt.from_jax import load_encodec
    from jen1_tpu_torch.codec.model import EncodecConfig, EncodecModel
    from jen1_tpu_torch.conditioning import conditioners as pcond

    jcfg, pcfg, _, params, pmodel = composer_models
    mc = jcfg.model_config
    jcodec = JCodec(JCodecConfig(**TRACK_CODEC))
    jt5 = jcond.T5Conditioner(output_dim=mc.context_embedding_features,
                              t5_model_name="tiny-test",
                              max_length=mc.context_embedding_max_length)
    jj = JJen1(None, sample_rate=1600, config=jcfg, codec=jcodec,
               conditioner=jcond.MultiConditioner({"prompt": jt5}))
    jj._params = params
    pcodec = EncodecModel(EncodecConfig(**TRACK_CODEC), device="cpu")
    load_encodec(pcodec, np_tree(jcodec.params))
    pt5 = pcond.T5Conditioner(mc.context_embedding_features, "tiny-test",
                              mc.context_embedding_max_length, device="cpu")
    load(pt5, {"encoder": jt5.params["encoder"], "proj": jt5.params["proj"]})
    pj = Jen1(sample_rate=1600, config=pcfg, codec=pcodec.eval(),
              conditioner=pcond.MultiConditioner({"prompt": pt5}), device="cpu")
    pj.model.load_state_dict(pmodel.state_dict())
    with one_torch_thread():
        yield jj, pj


@pytest.mark.parametrize("context,decode", [(True, True), (False, False)],
                         ids=["context_decoded", "no_context_latent"])
def test_generate_tracks_matches_jax(composer_pair, context, decode, monkeypatch):
    """GDM DDIM, 2 steps, 4 s: with track 1 given as a stereo clip (encoded
    chunked) and decoded as one batched decode of the 3 tracks, and with no
    context as the latent."""
    jj, pj = composer_pair
    ctx = {1: synthetic_clip(5, SECONDS, 1600)} if context else None
    kw = dict(seed=7, steps=STEPS, batch_size=1, seconds=SECONDS, context_tracks=ctx,
              decode=decode)
    ref = jj.generate_tracks("three stems", **kw)
    x_t, noises = gdm_draws(jax.random.fold_in(jax.random.key(7), 2), (1, 160, 12),
                            range(STEPS))
    inject_gdm_draws(monkeypatch, x_t, noises)
    out = pj.generate_tracks("three stems", **kw)
    want = (1, 3, 2, SECONDS * 1600) if decode else (1, 12, 160)
    assert out.shape == np.shape(ref) == want and np.isfinite(out).all()
    assert_close(out, np.asarray(ref), **BAR)


def test_generate_tracks_refusals(composer_pair):
    _, pj = composer_pair
    with pytest.raises(ValueError, match="out of range"):
        pj.generate_tracks("x", steps=1, seconds=1, context_tracks={3: np.zeros((1600, 2))})
    with pytest.raises(ValueError, match="prompts"):
        pj.generate_tracks(["a", "b"], steps=1, seconds=1)
    mc = pj.config.model_config
    pj.config.model_config = dataclasses.replace(mc, n_tracks=1)
    try:
        with pytest.raises(ValueError, match="composer config"):
            pj.generate_tracks("x", steps=1, seconds=1)
    finally:
        pj.config.model_config = mc
