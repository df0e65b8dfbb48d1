"""Port parity of LoRA fine-tuning: jen1_tpu_torch's train/lora.py and
`Jen1(lora_path=...)` against jen1_tpu/train/lora.py on the CPU.

The adapter is the JAX layout ({flax path: {"a": (fan_in, r), "b": (r,
fan_out)}}), so one numpy adapter goes into both packages. Bars: target
paths equal as sets and in order; merged weights rtol 1e-6 (one fp32
product and sum); the train step at the train bars of
tests/test_torch_train.py (losses rtol 2e-3, each adapter gradient leaf
within 5e-3 * max|g| of the leaf, floored at 1e-5 of the largest leaf's),
with JAX's draws injected; the base bit-unchanged; a resumed run
bit-equal; `generate` at the sampler-trajectory bar (rtol 2e-2, atol
2e-3) of tests/test_torch_generation.py.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jen1_tpu.diffusion.gdm import create_gaussian_diffusion as jax_gdm
from jen1_tpu.train import lora as jax_lora
from jen1_tpu_torch.api.generation import Jen1
from jen1_tpu_torch.ckpt.checkpoint import CheckpointManager
from jen1_tpu_torch.diffusion import vdm as port_vdm
from jen1_tpu_torch.diffusion.gdm import create_gaussian_diffusion
from jen1_tpu_torch.models.unet import unet_from_model_config as port_unet
from jen1_tpu_torch.train import lora
from test_torch_train import LOSS, Coin, jax_step_draws, models, step_batch  # noqa: F401
from torch_port_util import (
    assert_close, jen1_pair, load, one_torch_thread, rng, unet_shapes,
    vdm_initial_noise,
)

# a conv (k, c_in, c_out) kernel and a transposed conv's beside the Linears
CONV_TARGETS = (r"(attention|cross_attention)\.to_q\.kernel$"
                r"|upsample1\.block0\.block1\.project\.kernel$|upsample0\.upsample\.kernel$")
MERGE = dict(rtol=1e-6, atol=1e-7)
L_STEP = 48


def jax_tree_paths(tree):
    return [jax_lora._path_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def np_adapter(params, rank, pattern, seed, b_scale=0.05):
    """A numpy adapter over JAX's target paths with a nonzero b, so every
    factor gets a gradient."""
    g = rng(seed)
    by_path = dict(zip(jax_tree_paths(params), jax.tree_util.tree_leaves(params)))
    out = {}
    for path in jax_lora.lora_target_paths(params, pattern):
        shape = np.shape(by_path[path])
        fan_in = int(np.prod(shape[:-1]))
        out[path] = {"a": (g.standard_normal((fan_in, rank)) / np.sqrt(fan_in)).astype(np.float32),
                     "b": (b_scale * g.standard_normal((rank, shape[-1]))).astype(np.float32)}
    return out


def torch_adapter(adapter):
    return {p: {k: torch.from_numpy(v.copy()) for k, v in ab.items()} for p, ab in adapter.items()}


def test_flax_paths_and_targets_match_jax(models):
    """Every port parameter's flax path is a leaf of the JAX tree (in tree
    order), and both packages select the same targets, default and conv."""
    _, _, _, params, pmodel = models
    assert list(lora.flax_paths(pmodel)) == jax_tree_paths(params["params"])
    for pattern in (lora.DEFAULT_TARGETS, CONV_TARGETS):
        want = jax_lora.lora_target_paths(params["params"], pattern)
        assert lora.lora_target_paths(pmodel, pattern) == want
    conv = [p for p in lora.lora_target_paths(pmodel, CONV_TARGETS) if "attention" not in p]
    assert conv == ["unet.upsample0.upsample.kernel",
                    "unet.upsample1.block0.block1.project.kernel"]


@pytest.mark.parametrize("pattern", [lora.DEFAULT_TARGETS, CONV_TARGETS],
                         ids=["default", "with_conv"])
def test_merge_lora_matches_jax(models, pattern):
    """merge_lora on the port module equals JAX's merge_lora tree loaded
    into a port module: the Linear transpose and the conv permute."""
    _, pcfg, _, params, pmodel = models
    adapter = np_adapter(params["params"], 3, pattern, seed=1)
    ref = jax_lora.merge_lora(params["params"], adapter, 2.5)
    want = load(port_unet(pcfg.model_config), {"params": ref})
    model = port_unet(pcfg.model_config)
    model.load_state_dict(pmodel.state_dict())
    lora.merge_lora(model, torch_adapter(adapter), 2.5)
    for (name, p), (_, q) in zip(model.named_parameters(), want.named_parameters()):
        assert_close(p, q.detach(), **MERGE)
    assert lora.lora_param_count(torch_adapter(adapter)) == jax_lora.lora_param_count(adapter)
    assert lora.adapter_rank(torch_adapter(adapter)) == 3


def test_init_lora_starts_at_the_base(models):
    _, _, _, params, pmodel = models
    adapter = lora.init_lora(pmodel, 4, generator=torch.Generator().manual_seed(0))
    assert list(adapter) == jax_lora.lora_target_paths(params["params"])
    for path, ab in adapter.items():
        fan_in = ab["a"].shape[0]
        assert ab["a"].shape[1] == ab["b"].shape[0] == 4 and not ab["b"].any()
        assert 0.5 < float(ab["a"].std() * np.sqrt(fan_in)) < 1.5, path
    with pytest.raises(ValueError, match="matched no"):
        lora.init_lora(pmodel, 4, r"nothing\.kernel$")


def lora_trainer(pcfg, pmodel, adapter, remat=False, rank=4, alpha=8.0):
    cfg = copy.deepcopy(pcfg)
    cfg.lora_config.rank, cfg.lora_config.alpha = rank, alpha
    cfg.model_config = dataclasses.replace(cfg.model_config, remat=remat)
    model = port_unet(cfg.model_config)
    model.load_state_dict(pmodel.state_dict())
    return lora.LoRATrainer(
        cfg, model, create_gaussian_diffusion(cfg.diffusion_config.gaussian_diffusion),
        device="cpu", adapter=torch_adapter(adapter))


def jax_lora_step(jcfg, jmodel, params, adapter, batch, key, flags, scale):
    jtrainer = jax_lora.LoRATrainer(
        dataclasses.replace(jcfg, lora_config=dataclasses.replace(
            jcfg.lora_config, rank=4, alpha=4 * scale)),
        jmodel, jax_gdm(jcfg.diffusion_config.gaussian_diffusion))

    def loss_fn(ad):
        merged = jax_lora.merge_lora(params["params"], ad, jtrainer.scale)
        return jtrainer._multi_task_loss(merged, batch["latents"], batch["text_emb"],
                                         batch["text_mask"], key, flags)

    (total, per_task), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, adapter))
    return jtrainer, total, per_task, grads


def assert_adapter_grads(trainer, ref_grads):
    leaves = {f"{p}.{k}": np.asarray(ab[k]) for p, ab in ref_grads.items() for k in ("a", "b")}
    floor = 1e-5 * max(np.abs(v).max() for v in leaves.values())
    for name, p in zip(trainer._names(), trainer.params):
        ref = leaves[name]
        bar = 5e-3 * max(np.abs(ref).max(), floor)
        assert float(np.abs(p.grad.numpy() - ref).max()) <= bar, name


def test_lora_step_matches_jax(models, coin=1):
    """One LoRA step (GDM, L = 48, text_guided causal: both causal groups
    run) of both packages with the same base, adapter and draws: losses,
    the gradient of every adapter leaf, the global norm; the base is
    bit-unchanged and holds no gradient."""
    jcfg, pcfg, jmodel, params, pmodel = models
    adapter = np_adapter(params["params"], 4, lora.DEFAULT_TARGETS, seed=2 + coin)
    batch = step_batch(jcfg.model_config, L_STEP, seed=coin)
    key = jax.random.PRNGKey(40 + coin)
    trainer = lora_trainer(pcfg, pmodel, adapter)
    flags = trainer._causal_flags(Coin(coin))
    jtrainer, total, per_task, grads = jax_lora_step(jcfg, jmodel, params, adapter, batch, key,
                                                     flags, trainer.scale)
    assert jtrainer.scale == trainer.scale == 2.0
    draws = jax_step_draws(trainer, key, flags, batch["latents"].shape)
    trainer.draw_randoms = lambda *args: draws
    base = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    state = trainer.init_state()
    assert len(state.opt_state.mu) == 2 * len(adapter)
    _, metrics = trainer.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                    None, Coin(coin))
    assert_close(metrics["loss/train"], total, **LOSS)
    for task, value in per_task.items():
        assert_close(metrics[f"loss_{task}/train"], value, **LOSS)
    assert_close(metrics["grad_norm"], jnp.sqrt(sum(jnp.sum(x**2) for x in
                                                    jax.tree.leaves(grads))), **LOSS)
    assert_adapter_grads(trainer, grads)
    for n, p in trainer.model.named_parameters():
        assert torch.equal(p, base[n]) and p.grad is None and not p.requires_grad, n
    assert all(float(p.grad.abs().max()) > 0 for p in trainer.params)


def test_lora_remat_step_equals_plain(models):
    """With remat, each checkpointed block merges again from the same a
    and b in its recompute: losses and adapter gradients equal the plain
    step's at the train bars."""
    _, pcfg, _, params, pmodel = models
    adapter = np_adapter(params["params"], 4, lora.DEFAULT_TARGETS, seed=7)
    batch = {k: torch.from_numpy(v) for k, v in step_batch(pcfg.model_config, L_STEP).items()}
    results = {}
    for remat in (False, True):
        trainer = lora_trainer(pcfg, pmodel, adapter, remat=remat)
        draws = trainer.draw_randoms(torch.Generator().manual_seed(3), (True, False, True),
                                     tuple(batch["latents"].shape))
        trainer.draw_randoms = lambda *args: draws
        with one_torch_thread():
            _, metrics = trainer.train_step(trainer.init_state(), batch, None, Coin(1))
        results[remat] = (trainer, metrics)
    (plain, m_plain), (remat, m_remat) = results[False], results[True]
    for k in m_plain:
        assert_close(m_remat[k], m_plain[k], **LOSS)
    for name, a, b in zip(plain._names(), plain.params, remat.params):
        bar = 5e-3 * float(a.grad.abs().max())
        assert float((a.grad - b.grad).abs().max()) <= bar, name


def test_checkpoint_holds_the_adapter_and_resumes_bit_equal(models, tmp_path):
    """The train state of a LoRA run (with EMA) is the adapter alone; a
    trainer restored from its checkpoint takes the next step bit-equal to
    the one that saved it."""
    _, pcfg, _, params, pmodel = models
    adapter = np_adapter(params["params"], 4, lora.DEFAULT_TARGETS, seed=9)
    cfg = copy.deepcopy(pcfg)
    cfg.use_ema = True
    batch = {k: torch.from_numpy(v) for k, v in step_batch(cfg.model_config, L_STEP).items()}
    first = lora_trainer(cfg, pmodel, adapter)
    state = first.init_state()
    for i in range(2):
        state, _ = first.train_step(state, batch, torch.Generator().manual_seed(i), Coin(i))
    flat = first.state_dict(state)
    names = {f"{p}.{k}" for p in adapter for k in ("a", "b")}
    assert {k.split("/", 1)[1] for k in flat if k.startswith("params/")} == names
    assert not any(k.endswith((".weight", ".bias")) for k in flat)
    CheckpointManager(str(tmp_path)).save(state.step, flat, loss=1.0)
    second = lora_trainer(cfg, pmodel, np_adapter(params["params"], 4, lora.DEFAULT_TARGETS, 0))
    restored = second.load_state_dict(CheckpointManager(str(tmp_path)).restore()[0])
    assert restored.step == 2
    out = []
    for tr, st in ((first, state), (second, restored)):
        st, m = tr.train_step(st, batch, torch.Generator().manual_seed(5), Coin(1))
        out.append((m, [p.detach().clone() for p in tr.params], st.ema_params))
    assert all(torch.equal(out[0][0][k], out[1][0][k]) for k in out[0][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    assert all(torch.equal(a, b) for a, b in zip(out[0][2], out[1][2]))


def test_load_base_params(models, tmp_path):
    """A checkpoint directory's params load into the frozen base; a shape
    mismatch, missing names or a directory of another format raise."""
    _, pcfg, _, _, pmodel = models
    good = tmp_path / "good"
    CheckpointManager(str(good)).save(
        3, {f"params/{n}": p for n, p in pmodel.named_parameters()}, loss=0.0)
    model = port_unet(pcfg.model_config)
    lora.load_base_params(str(good), model, pcfg.model_config)
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), pmodel.parameters()))
    other = dataclasses.replace(pcfg.model_config, channels=16)
    with pytest.raises(ValueError, match="shape-mismatch=\\[.+\\]"):
        lora.load_base_params(str(good), port_unet(other), other)
    (tmp_path / "orbax" / "0").mkdir(parents=True)
    with pytest.raises(ValueError, match="Orbax"):
        lora.load_base_params(str(tmp_path / "orbax"), model, pcfg.model_config)
    cfg = copy.deepcopy(pcfg)
    cfg.lora_config.rank, cfg.lora_config.base_ckpt = 2, str(good)
    trainer = lora.LoRATrainer(
        cfg, port_unet(cfg.model_config),
        create_gaussian_diffusion(cfg.diffusion_config.gaussian_diffusion), device="cpu",
        generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(p, q) for p, q in zip(trainer.model.parameters(),
                                                  pmodel.parameters()))


@pytest.fixture(scope="module")
def lora_pair(tmp_path_factory):
    """The tiny Jen1 pair, a base checkpoint of its UNet (params and an
    equal EMA) and an adapter run (params and a different EMA)."""
    with one_torch_thread():
        jj, pj = jen1_pair()
        d = tmp_path_factory.mktemp("lora")
        base = {n: p.detach() for n, p in pj.model.named_parameters()}
        CheckpointManager(str(d / "base")).save(
            1, {**{f"params/{n}": t for n, t in base.items()},
                **{f"ema_params/{n}": t for n, t in base.items()}}, loss=0.0)
        params = jj._params["params"]
        adapters = [np_adapter(params, 4, lora.DEFAULT_TARGETS, seed=s) for s in (11, 12)]
        run = {}
        for prefix, ad in zip(("params/", "ema_params/"), adapters):
            run.update({f"{prefix}{p}.{k}": torch.from_numpy(v) for p, ab in ad.items()
                        for k, v in ab.items()})
        CheckpointManager(str(d / "run")).save(4, run, loss=0.5)
        yield jj, pj, d, adapters


def lora_jen1(pj, d, **kw):
    return Jen1(str(d / "base"), sample_rate=1600, config=pj.config, codec=pj.codec,
                conditioner=pj.conditioner, lora_path=str(d / "run"), device="cpu", **kw)


@pytest.mark.parametrize("use_ema,scale", [(False, None), (True, 0.75)])
def test_jen1_lora_path_merges_like_jax(lora_pair, use_ema, scale):
    """Jen1(ckpt_path=base, lora_path=run) merges the run's adapter (its
    EMA with use_ema_params) at alpha / rank (16 / 4) or at `lora_scale`:
    the UNet equals JAX's merge_lora of the same base and adapter."""
    jj, pj, d, adapters = lora_pair
    with one_torch_thread():
        pl = lora_jen1(pj, d, use_ema_params=use_ema, lora_scale=scale)
    want_scale = 4.0 if scale is None else scale
    assert pl.lora_scale == want_scale
    ref = jax_lora.merge_lora(jj._params["params"], adapters[int(use_ema)], want_scale)
    want = load(port_unet(pj.config.model_config), {"params": ref})
    for (name, p), q in zip(pl.model.named_parameters(), want.parameters()):
        assert_close(p, q.detach(), **MERGE)


def test_jen1_lora_generate_matches_jax(lora_pair, monkeypatch):
    """generate() of the merged model against the JAX Jen1 holding JAX's
    merged weights, with the same initial noise."""
    jj, pj, d, adapters = lora_pair
    with one_torch_thread():
        pl = lora_jen1(pj, d)
        base = jj._params
        jj._params = {"params": jax_lora.merge_lora(base["params"], adapters[0], 4.0)}
        try:
            ref = jj.generate("a merged song", seed=3, steps=2, batch_size=1, seconds=13)
        finally:
            jj._params = base
        noise = torch.from_numpy(vdm_initial_noise(3, (1, 520, 8)))
        monkeypatch.setattr(port_vdm, "initial_noise", lambda shape, generator, device: noise)
        out = pl.generate("a merged song", seed=3, steps=2, batch_size=1, seconds=13)
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert_close(out, ref, rtol=2e-2, atol=2e-3)


def test_jen1_lora_path_refuses_other_directories(tmp_path):
    (tmp_path / "orbax" / "0").mkdir(parents=True)
    with pytest.raises(ValueError, match="Orbax"):
        Jen1(lora_path=str(tmp_path / "orbax"), device="cpu")


def test_unet_shapes_helper_matches(models):
    """The adapter's (fan_in, fan_out) follow the flax kernel shapes."""
    jcfg, _, jmodel, params, pmodel = models
    shapes = unet_shapes(jmodel, jcfg.model_config)
    by_path = dict(zip(jax_tree_paths(shapes["params"]), jax.tree_util.tree_leaves(
        shapes["params"])))
    adapter = lora.init_lora(pmodel, 2, CONV_TARGETS)
    for path, ab in adapter.items():
        shape = by_path[path].shape
        assert ab["a"].shape == (int(np.prod(shape[:-1])), 2) and ab["b"].shape == (2, shape[-1])
