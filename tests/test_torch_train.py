"""Port parity of the training slice: jen1_tpu_torch's task masks, diffusion
losses, optimizers, train step, CLI and config against jen1_tpu on the CPU.

Torch and JAX draw different numbers from the same seed, so every random
draw the port makes is rebuilt here from JAX's keys (the way
`torch_port_util.vdm_initial_noise` rebuilds the sampler's x_T) and handed
to the port. The JAX side runs as its own tests run it: fp32, jitted, and
the Pallas flash kernels (forward and backward) in interpret mode.

Bars:
  * task masks: equal exactly, given the same drawn lengths and starts;
  * per-example diffusion losses, total and per-task step losses and the
    global gradient norm: rtol 2e-3;
  * every gradient leaf within 5e-3 * max|g_ref| of that leaf, that scale
    floored at 1e-5 of the largest leaf's (biases that feed a GroupNorm
    have an analytically zero gradient: rounding noise, 1e-10 to 1e-8 of
    the largest leaf on the CPU and on the card);
  * optimizers over 3 updates (with a skipped non-finite step): rtol 1e-5.
"""

import copy
import dataclasses
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jen1_tpu.config import Config as JaxConfig, OptimizerConfig as JaxOptimizerConfig
from jen1_tpu.config import longform_config as jax_longform
from jen1_tpu.diffusion.gdm import create_gaussian_diffusion as jax_gdm
from jen1_tpu.diffusion.vdm import create_variational_diffusion as jax_vdm
from jen1_tpu.models.unet import unet_from_model_config as jax_unet
from jen1_tpu.train import fused_optim as jax_fused
from jen1_tpu.train.optim import make_optimizer as jax_make_optimizer
from jen1_tpu.train.tasks import random_task_mask as jax_random_task_mask
from jen1_tpu.train.trainer import UnifiedMultiTaskTrainer as JaxTrainer
from jen1_tpu_torch.config import Config, OptimizerConfig, longform_config
from jen1_tpu_torch.diffusion.gdm import create_gaussian_diffusion
from jen1_tpu_torch.diffusion.vdm import create_variational_diffusion
from jen1_tpu_torch.models.unet import unet_from_model_config as port_unet
from jen1_tpu_torch.ops.initializers import init_module
from jen1_tpu_torch.train import fused_optim, tasks
from jen1_tpu_torch.train import train as train_cli
from jen1_tpu_torch.train.optim import make_optimizer
from jen1_tpu_torch.train.trainer import StepDraws, UnifiedMultiTaskTrainer
from torch_port_util import (
    assert_close, flash_model_configs, load, one_torch_thread, randn, random_params, rng,
)

LOSS = dict(rtol=2e-3, atol=0.0)
LEAF_RTOL = 5e-3
LEAF_FLOOR = 1e-5
OPT = dict(rtol=1e-5, atol=1e-8)
L_FLASH = 520  # the level-1 transformer sees 130 frames >= flash_min_seq_len 128


# ----------------------------------------------------------- JAX draws


def jax_mask_draws(key, length, task):
    """(mask_len, start) exactly as jen1_tpu.train.tasks.random_task_mask
    draws them from `key` (None where it draws none)."""
    lo, hi = tasks.mask_length_bounds(length)
    if task == "music_inpaint":
        k_len, k_start = jax.random.split(key)
        mask_len = int(jax.random.randint(k_len, (), lo, hi + 1))
        return mask_len, int(jax.random.randint(k_start, (), 0, length - mask_len + 1))
    if task == "music_cont":
        return int(jax.random.randint(key, (), lo, hi + 1)), None
    return None, None


def jax_step_draws(trainer, rng_key, flags, shape):
    """The draws of jen1_tpu's _multi_task_loss for `rng_key`
    (trainer.py:249-317, gdm.py:250-255, vdm.py:119-126,
    unet.py:511-514), as the port's StepDraws."""
    b, length, channels = shape
    sub = b // len(trainer.tasks)
    diffusion = trainer.diffusion
    draws = StepDraws({}, {}, {}, {}, {}, {})
    for i, task in enumerate(trainer.tasks):
        k_mask, k_t, _ = jax.random.split(jax.random.fold_in(rng_key, i), 3)
        mask_len, start = jax_mask_draws(k_mask, length, task)
        if mask_len is not None:
            draws.mask_len[task] = mask_len
        if start is not None:
            draws.mask_start[task] = start
        if trainer.is_gdm:
            t = jax.random.randint(k_t, (sub,), 0, diffusion.num_timesteps)
            draws.t[task] = torch.from_numpy(np.asarray(t, np.int64))
    for causal in sorted(set(flags)):
        nb = sub * sum(f == causal for f in flags)
        k_grp = jax.random.fold_in(rng_key, 1000 + int(causal))
        if trainer.is_gdm:
            k_noise, k_cfg = jax.random.split(k_grp)
        else:
            k_times, k_noise, k_cfg = jax.random.split(k_grp, 3)
            draws.times[causal] = torch.from_numpy(
                np.array(jax.random.uniform(k_times, (nb,), jnp.float32)))
        draws.noise[causal] = torch.from_numpy(
            np.array(jax.random.normal(k_noise, (nb, length, channels), jnp.float32)))
        draws.cfg_bits[causal] = torch.from_numpy(np.array(
            jax.random.bernoulli(k_cfg, diffusion.cfg_dropout_proba, (nb, 1, 1))))
    return draws


class Coin:
    """A host generator whose text_guided coin is fixed."""

    def __init__(self, value):
        self.value = value

    def integers(self, lo, hi):
        return self.value


# --------------------------------------------------------------- models


@pytest.fixture(scope="module")
def models():
    """The JAX and port UNets of tiny_test_config() with the flash path,
    holding the same random parameters."""
    jcfg, pcfg = flash_model_configs()
    jmodel = jax_unet(jcfg.model_config)
    mc = jcfg.model_config
    shapes = jax.eval_shape(lambda r: jmodel.init(
        r,
        jnp.zeros((1, 40, mc.in_channels)),
        jnp.zeros((1,)),
        embedding=jnp.zeros((1, mc.context_embedding_max_length,
                             mc.context_embedding_features)),
        embedding_mask=jnp.ones((1, mc.context_embedding_max_length), bool),
        channels_list=[jnp.zeros((1, 40, mc.context_channels[0]))],
    ), jax.random.PRNGKey(0))
    params = random_params(shapes, seed=11)
    pmodel = load(port_unet(pcfg.model_config), params)
    return jcfg, pcfg, jmodel, params, pmodel


def step_batch(mc, length, seed=0):
    g = rng(seed)
    m = mc.context_embedding_max_length
    mask = np.ones((3, m), bool)
    mask[-1, m // 2:] = False
    return {
        "latents": randn(g, 3, length, mc.in_channels),
        "text_emb": randn(g, 3, m, mc.context_embedding_features),
        "text_mask": mask,
    }


# ----------------------------------------------------------- (b) masks


@pytest.mark.parametrize("task", ["text_guided", "music_inpaint", "music_cont"])
@pytest.mark.parametrize("length,seed", [(48, 0), (520, 1), (4500, 2), (37, 3)])
def test_task_masks_equal_given_same_draws(task, length, seed):
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jax_random_task_mask(key, 2, length, task))
    mask_len, start = jax_mask_draws(key, length, task)
    out = tasks.task_mask(task, 2, length, mask_len, start)
    assert out.shape == ref.shape == (2, length, 1)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("task", ["music_inpaint", "music_cont"])
def test_random_task_mask_draws_in_bounds(task):
    """The port's own draws: one contiguous hidden region of length in
    [0.2 L, 0.8 L] shared over the sub-batch; music_cont hides the tail."""
    length = 50
    lo, hi = tasks.mask_length_bounds(length)
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        m = tasks.random_task_mask(gen, 2, length, task)[..., 0]
        assert torch.equal(m[0], m[1])
        hidden = (m[0] == 0).nonzero().flatten()
        assert lo <= len(hidden) <= hi
        assert torch.equal(hidden, torch.arange(int(hidden[0]), int(hidden[-1]) + 1))
        if task == "music_cont":
            assert int(hidden[-1]) == length - 1


# ---------------------------------------------------------- (c) losses


def cfg_key(split, proba, b, start=0):
    """A key whose CFG-dropout bits hold both values, so the check covers
    the replaced and the kept embeddings."""
    for seed in range(start, start + 100):
        key = jax.random.PRNGKey(seed)
        bits = np.array(jax.random.bernoulli(split(key), proba, (b, 1, 1)))
        if 0 < bits.sum() < b:
            return key, bits
    raise AssertionError("no key with mixed bits")


def loss_inputs(mc, b, length, seed):
    g = rng(seed)
    m = mc.context_embedding_max_length
    return dict(
        x0=randn(g, b, length, mc.in_channels),
        emb=randn(g, b, m, mc.context_embedding_features),
        mask=np.ones((b, m), bool),
        concat=randn(g, b, length, mc.context_channels[0]),
        noise=randn(g, b, length, mc.in_channels),
    )


def jax_cond(inp):
    return {"cross_attn_cond": inp["emb"], "cross_attn_masks": inp["mask"],
            "global_cond": None, "input_concat_cond": inp["concat"]}


def port_cond(inp):
    return {k: None if v is None else torch.from_numpy(v) for k, v in jax_cond(inp).items()}


@pytest.mark.parametrize("causal", [False, True])
def test_gdm_training_losses_match(models, causal):
    """GaussianDiffusion.training_losses, v objective, CFG dropout 0.5:
    the same noise and t, and the port given JAX's dropout bits."""
    jcfg, pcfg, jmodel, params, pmodel = models
    gc = dataclasses.replace(jcfg.diffusion_config.gaussian_diffusion, cfg_dropout_proba=0.5)
    jd = jax_gdm(gc)
    pd = create_gaussian_diffusion(dataclasses.replace(
        pcfg.diffusion_config.gaussian_diffusion, cfg_dropout_proba=0.5))
    inp = loss_inputs(jcfg.model_config, 4, 48, seed=1 + causal)
    t = np.array([0, 3, 5, 7], np.int32)
    key, bits = cfg_key(lambda k: jax.random.split(k)[1], 0.5, 4)
    ref = jax.jit(lambda p, key: jd.training_losses(
        lambda x, tt, **kw: jmodel.apply(p, x, tt, **kw), inp["x0"], t, jax_cond(inp), key,
        noise=inp["noise"], causal=causal, reduce="none"))(params, key)
    with torch.no_grad():
        out = pd.training_losses(
            pmodel, torch.from_numpy(inp["x0"]), torch.from_numpy(t.astype(np.int64)),
            port_cond(inp), noise=torch.from_numpy(inp["noise"]),
            cfg_bits=torch.from_numpy(bits), causal=causal, reduce="none")
    assert out.shape == (4,)
    assert_close(out, ref, **LOSS)


@pytest.mark.parametrize("causal", [False, True])
def test_vdm_training_losses_match(models, causal):
    """VDM.training_losses (v target), CFG dropout 0.5: the same noise and
    times, and the port given JAX's dropout bits."""
    jcfg, pcfg, jmodel, params, pmodel = models
    jd = jax_vdm(dataclasses.replace(jcfg.diffusion_config.variational_diffusion,
                                     cfg_dropout_proba=0.5))
    pd = create_variational_diffusion(dataclasses.replace(
        pcfg.diffusion_config.variational_diffusion, cfg_dropout_proba=0.5))
    inp = loss_inputs(jcfg.model_config, 4, 48, seed=3 + causal)
    times = rng(5).uniform(size=4).astype(np.float32)
    key, bits = cfg_key(lambda k: jax.random.split(k, 3)[2], 0.5, 4)
    ref = jax.jit(lambda p, key: jd.training_losses(
        lambda x, tt, **kw: jmodel.apply(p, x, tt, **kw), inp["x0"], jax_cond(inp), key,
        noise=inp["noise"], times=times, causal=causal, reduce="none"))(params, key)
    with torch.no_grad():
        out = pd.training_losses(
            pmodel, torch.from_numpy(inp["x0"]), port_cond(inp),
            noise=torch.from_numpy(inp["noise"]), times=torch.from_numpy(times),
            cfg_bits=torch.from_numpy(bits), causal=causal, reduce="none")
    assert_close(out, ref, **LOSS)


def test_gdm_buffers_match(models):
    jcfg, pcfg = models[:2]
    jd = jax_gdm(jcfg.diffusion_config.gaussian_diffusion)
    pd = create_gaussian_diffusion(pcfg.diffusion_config.gaussian_diffusion)
    for name in ("betas", "alphas_cumprod", "sqrt_alphas_cumprod",
                 "sqrt_one_minus_alphas_cumprod", "posterior_variance",
                 "posterior_log_variance_clipped", "posterior_mean_coef1",
                 "posterior_mean_coef2"):
        np.testing.assert_array_equal(getattr(pd, name).numpy(), np.asarray(getattr(jd, name)))


# ------------------------------------------------------ (d) train step


def jax_and_port_step(models, coin, remat=False):
    """One multi-task GDM step at the tiny flash config (fp32, L = 520):
    JAX's value_and_grad of _multi_task_loss against the port's train_step
    with JAX's draws injected, both with `remat`; asserts the train bars and
    returns the port's model (holding its gradients) and metrics."""
    jcfg, pcfg, jmodel, params, pmodel = models
    if remat:
        jcfg, pcfg = copy.deepcopy(jcfg), copy.deepcopy(pcfg)
        jcfg.model_config = dataclasses.replace(jcfg.model_config, remat=True)
        pcfg.model_config = dataclasses.replace(pcfg.model_config, remat=True)
        jmodel = jax_unet(jcfg.model_config)
    jtrainer = JaxTrainer(jcfg, jmodel, jax_gdm(jcfg.diffusion_config.gaussian_diffusion))
    model = port_unet(pcfg.model_config)
    model.load_state_dict(pmodel.state_dict())
    ptrainer = UnifiedMultiTaskTrainer(
        pcfg, model, create_gaussian_diffusion(pcfg.diffusion_config.gaussian_diffusion),
        device="cpu")
    batch = step_batch(jcfg.model_config, L_FLASH, seed=coin)
    key = jax.random.PRNGKey(20 + coin)
    flags = jtrainer._causal_flags(Coin(coin))
    assert len(set(flags)) == 2

    def loss_fn(p):
        return jtrainer._multi_task_loss(p, batch["latents"], batch["text_emb"],
                                         batch["text_mask"], key, flags)

    (total, per_task), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params["params"])

    draws = jax_step_draws(ptrainer, key, flags, batch["latents"].shape)
    ptrainer.draw_randoms = lambda *args: draws
    _, metrics = ptrainer.train_step(
        ptrainer.init_state(), {k: torch.from_numpy(v) for k, v in batch.items()}, None,
        Coin(coin))
    assert_close(metrics["loss/train"], total, **LOSS)
    for task, value in per_task.items():
        assert_close(metrics[f"loss_{task}/train"], value, **LOSS)
    assert_close(metrics["grad_norm"], optax.global_norm(grads), **LOSS)

    ref_grads = load(port_unet(pcfg.model_config), {"params": grads})
    assert_grads_close(model, dict(ref_grads.named_parameters()))
    return model, metrics


def assert_grads_close(model, refs):
    """Every gradient leaf of `model` within LEAF_RTOL of its reference."""
    floor = LEAF_FLOOR * max(float(r.detach().abs().max()) for r in refs.values())
    for name, p in model.named_parameters():
        ref = refs[name].detach()
        bar = LEAF_RTOL * max(float(ref.abs().max()), floor)
        assert float((p.grad - ref).abs().max()) <= bar, name


@pytest.mark.parametrize("coin", [0, 1], ids=["text_guided_bidir", "text_guided_causal"])
def test_train_step_matches_jax(models, coin):
    """text_guided joins the bidirectional group (coin 0) or the causal one
    (coin 1)."""
    jax_and_port_step(models, coin)


def test_remat_train_step_matches_jax(models):
    """ModelConfig.remat: JAX's nn.remat step against the port's
    torch.utils.checkpoint step, at the train bars."""
    with one_torch_thread():
        jax_and_port_step(models, 0, remat=True)


def test_remat_step_equals_plain_step(models, monkeypatch):
    """The same port step with and without remat: equal losses and
    gradients at the train bars. The recompute runs each flash forward
    again in the backward: 4 -> 8 forward calls per step (two causal
    groups x the two transformers at 130 frames), the backward calls stay
    4."""
    from jen1_tpu_torch.ops import flash_attention as port_fa

    _, pcfg, _, _, pmodel = models
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = port_fa.flash_attention_reference, port_fa.flash_attention_bwd_reference

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(port_fa, "flash_attention_reference", counting("fwd", fwd))
    monkeypatch.setattr(port_fa, "flash_attention_bwd_reference", counting("bwd", bwd))
    batch = {k: torch.from_numpy(v) for k, v in step_batch(pcfg.model_config, L_FLASH).items()}
    results = {}
    for remat in (False, True):
        cfg = copy.deepcopy(pcfg)
        cfg.model_config = dataclasses.replace(cfg.model_config, remat=remat)
        model = port_unet(cfg.model_config)
        model.load_state_dict(pmodel.state_dict())
        trainer = UnifiedMultiTaskTrainer(
            cfg, model, create_gaussian_diffusion(cfg.diffusion_config.gaussian_diffusion),
            device="cpu")
        draws = trainer.draw_randoms(torch.Generator().manual_seed(3), (True, False, True),
                                     tuple(batch["latents"].shape))
        trainer.draw_randoms = lambda *args: draws
        calls.update(fwd=0, bwd=0)
        with one_torch_thread():
            _, metrics = trainer.train_step(trainer.init_state(), batch, None, Coin(1))
        results[remat] = (model, metrics, dict(calls))
    (plain, m_plain, c_plain), (remat, m_remat, c_remat) = results[False], results[True]
    assert (c_plain, c_remat) == ({"fwd": 4, "bwd": 4}, {"fwd": 8, "bwd": 4})
    for k in m_plain:
        assert_close(m_remat[k], m_plain[k], **LOSS)
    assert_grads_close(remat, {n: p.grad for n, p in plain.named_parameters()})


def test_draw_randoms_shapes():
    """The port's own draws: one call makes every device draw of a step."""
    _, pcfg = flash_model_configs()
    trainer = UnifiedMultiTaskTrainer(
        pcfg, port_unet(pcfg.model_config),
        create_gaussian_diffusion(pcfg.diffusion_config.gaussian_diffusion), device="cpu")
    flags = (True, False, True)  # text_guided causal
    draws = trainer.draw_randoms(torch.Generator().manual_seed(0), flags, (3, 60, 8))
    assert set(draws.mask_len) == {"music_inpaint", "music_cont"}
    assert set(draws.mask_start) == {"music_inpaint"}
    assert {k: tuple(v.shape) for k, v in draws.noise.items()} == {
        False: (1, 60, 8), True: (2, 60, 8)}
    assert {k: tuple(v.shape) for k, v in draws.cfg_bits.items()} == {
        False: (1, 1, 1), True: (2, 1, 1)}
    assert all(int(t.max()) < trainer.diffusion.num_timesteps for t in draws.t.values())


def test_accumulation_and_ema():
    """grad_accum_every = 2 takes the optax-semantics chain: the first call
    leaves the parameters as they are, the second applies the averaged
    gradient; the EMA follows e = d * e + (1 - d) * p after every call, as
    in jen1_tpu's train step."""
    _, pcfg = flash_model_configs()
    pcfg.grad_accum_every, pcfg.use_ema, pcfg.ema_decay = 2, True, 0.9
    model = init_module(port_unet(pcfg.model_config), torch.Generator().manual_seed(0))
    trainer = UnifiedMultiTaskTrainer(
        pcfg, model, create_gaussian_diffusion(pcfg.diffusion_config.gaussian_diffusion),
        device="cpu")
    assert trainer.optimizer is not None
    state = trainer.init_state()
    batch = {k: torch.from_numpy(v) for k, v in step_batch(pcfg.model_config, 48).items()}
    p0 = [p.detach().clone() for p in trainer.params]
    state, _ = trainer.train_step(state, batch, torch.Generator().manual_seed(0), Coin(0))
    assert all(torch.equal(a, p) for a, p in zip(p0, trainer.params))
    state, _ = trainer.train_step(state, batch, torch.Generator().manual_seed(1), Coin(1))
    assert state.step == 2 and state.opt_state.count == 1
    assert not all(torch.equal(a, p) for a, p in zip(p0, trainer.params))
    for e, a, p in zip(state.ema_params, p0, trainer.params):
        torch.testing.assert_close(e, 0.9 * a + 0.1 * p.detach(), rtol=1e-6, atol=1e-7)


def tiny_trainer(**fields):
    _, pcfg = flash_model_configs()
    for k, v in fields.items():
        setattr(pcfg, k, v)
    model = init_module(port_unet(pcfg.model_config), torch.Generator().manual_seed(0))
    return pcfg, UnifiedMultiTaskTrainer(
        pcfg, model, create_gaussian_diffusion(pcfg.diffusion_config.gaussian_diffusion),
        device="cpu")


def thread_spans(since_ns):
    """This thread's spans of the ring since `since_ns`, in start order."""
    from jen1_tpu_torch.utils import profiling

    return [s for s in profiling.spans(since_ns) if s[3] == threading.get_ident()]


@pytest.mark.parametrize("use_ema", [False, True])
def test_train_step_stretches_are_spans(use_ema):
    """A step's stretches are spans of its thread, back to back in order:
    the draws, the loss's forward and backward, the optimizer and, with an
    EMA, its update."""
    pcfg, trainer = tiny_trainer(use_ema=use_ema)
    batch = {k: torch.from_numpy(v) for k, v in step_batch(pcfg.model_config, 48).items()}
    t0 = time.time_ns()
    trainer.train_step(trainer.init_state(), batch, torch.Generator().manual_seed(0), Coin(0))
    spans = thread_spans(t0)
    want = ["train.draws", "forward_backward", "optimizer"] + (["train.ema"] if use_ema else [])
    assert [s[0] for s in spans] == want
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


def test_prepare_batch_is_a_span():
    """The frozen conditioner's pass and the upload are one
    `train.prepare_batch` span."""
    pcfg, trainer = tiny_trainer()
    mc = pcfg.model_config
    calls = []

    def conditioner(metadata):
        calls.append(time.time_ns())
        n, m = len(metadata), mc.context_embedding_max_length
        return {"prompt": (torch.zeros(n, m, mc.context_embedding_features),
                           torch.ones(n, m, dtype=torch.bool))}

    trainer.conditioner = conditioner
    t0 = time.time_ns()
    batch = trainer.prepare_batch(np.zeros((2, 48, mc.in_channels), np.float32),
                                  [{"prompt": "a"}, {"prompt": "b"}])
    (span,) = thread_spans(t0)
    assert span[0] == "train.prepare_batch" and span[1] <= calls[0] <= span[2]
    assert batch["latents"].shape == (2, 48, mc.in_channels)


def test_train_and_eval_steps_run_without_tf32():
    """train_step and eval_step run the UNet's forward and backward with
    cuDNN's and cuBLAS's TF32 off, whatever the caller set (cuDNN's flag
    defaults to True), as JAX runs fp32 convs at Precision.HIGHEST; the
    flags are the caller's again afterwards. Read through hooks, so this
    holds on the CPU as on the card."""
    _, pcfg = flash_model_configs()
    model = init_module(port_unet(pcfg.model_config), torch.Generator().manual_seed(0))
    trainer = UnifiedMultiTaskTrainer(
        pcfg, model, create_gaussian_diffusion(pcfg.diffusion_config.gaussian_diffusion),
        device="cpu")
    seen = []

    def flags(*_):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))

    model.register_forward_hook(flags)
    model.register_full_backward_hook(flags)
    batch = {k: torch.from_numpy(v) for k, v in step_batch(pcfg.model_config, 48).items()}
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        trainer.train_step(trainer.init_state(), batch, torch.Generator().manual_seed(0),
                           Coin(0))
        n_train = len(seen)
        trainer.eval_step(None, batch, torch.Generator().manual_seed(1))
        after = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
    assert n_train >= 2 and len(seen) > n_train  # forwards and backwards, then eval
    assert set(seen) == {(False, False)} and after == (True, True)


# ------------------------------------------------------ (e) optimizers


def opt_problem(seed, steps, bad_step=None):
    g = rng(seed)
    shapes = [(16, 32), (32,), (5, 8, 8), (7,)]
    params = [randn(g, *s) for s in shapes]
    grads = []
    for i in range(steps):
        step = [randn(g, *s) * (0.05 if i % 2 else 3.0) for s in shapes]
        if i == bad_step:
            step[1][3] = np.nan
        grads.append(step)
    return params, grads


def test_fused_adamw_matches_jax():
    """Three updates plus one non-finite gradient, which must leave params,
    moments and count unchanged and raise notfinite_count."""
    oc, joc = OptimizerConfig(), JaxOptimizerConfig()
    params, grads = opt_problem(0, 4, bad_step=2)
    kw = dict(b1=oc.beta_1, b2=oc.beta_2, eps=1e-8, weight_decay=oc.weight_decay,
              clip=oc.grad_clip)
    from jen1_tpu.train.optim import make_lr_schedule as jax_lr
    from jen1_tpu_torch.train.optim import make_lr_schedule

    jp, js = [jnp.asarray(p) for p in params], jax_fused.fused_adamw_init(
        [jnp.asarray(p) for p in params])
    pp = [torch.from_numpy(p.copy()) for p in params]
    ps = fused_optim.fused_adamw_init(pp)
    for step, g in enumerate(grads):
        jp, js, jnorm = jax_fused.fused_adamw_apply(
            [jnp.asarray(x) for x in g], js, jp, lr=jax_lr(joc), **kw)
        ps, pnorm = fused_optim.fused_adamw_apply(
            [torch.from_numpy(x) for x in g], ps, pp, lr=make_lr_schedule(oc), **kw)
        assert (ps.count, ps.notfinite_count) == (int(js.count), int(js.notfinite_count))
        if step != 2:
            assert_close(pnorm, jnorm, **OPT)
        for a, b in zip(pp + ps.mu + ps.nu, list(jp) + list(js.mu) + list(js.nu)):
            assert_close(a, b, **OPT)
    assert ps.count == 3 and ps.notfinite_count == 0


@pytest.mark.parametrize("accum", [1, 2])
def test_optax_chain_matches_jax(accum):
    """clip -> AdamW -> apply_if_finite (-> MultiSteps), with a non-finite
    gradient that skips its update. Under MultiSteps the NaN stays in the
    running mean (optax resets it by multiplying by zero), so every later
    window would be skipped too: the bad gradient goes into the last one."""
    oc, joc = OptimizerConfig(), JaxOptimizerConfig()
    n_calls = 4 * accum
    params, grads = opt_problem(1, n_calls, bad_step=1 if accum == 1 else n_calls - 1)
    tx = jax_make_optimizer(joc, accum)
    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    chain = make_optimizer(oc, accum)
    pp = [torch.from_numpy(p.copy()) for p in params]
    ps = chain.init(pp)
    for g in grads:
        updates, js = tx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, updates)
        ps = chain.update([torch.from_numpy(x) for x in g], ps, pp)
        for a, b in zip(pp, jp):
            assert_close(a, b, **OPT)
    assert ps.count == 3 and ps.total_notfinite == 1


# ------------------------------------------------------------- (f) CLI


def tiny_cli_config(tmp_path):
    from jen1_tpu_torch.config import tiny_test_config

    cfg = tiny_test_config()
    cfg.conditioner_config.t5_config.t5_model_name = "tiny-test"
    cfg.conditioner_config.t5_config.max_length = cfg.model_config.context_embedding_max_length
    cfg.eval_interval = 2
    path = tmp_path / "cfg.json"
    cfg.to_json(str(path))
    latents = tmp_path / "latents"
    latents.mkdir()
    g = rng(0)
    for i in range(6):
        np.save(latents / f"clip{i}.npy", randn(g, 48, 8))
        (latents / f"clip{i}.json").write_text(json.dumps({"prompt": f"song {i}"}))
    return path, latents


def test_cli_trains_on_cpu(tmp_path):
    path, latents = tiny_cli_config(tmp_path)
    logs = tmp_path / "logs"
    train_cli.main(["--config", str(path), "--latents-dir", str(latents), "--max-steps", "2",
                    "--device", "cpu", "--log-dir", str(logs)])
    records = [json.loads(line) for line in (logs / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in records if "loss/train" in r]
    assert [r["step"] for r in train] == [1, 2]
    assert all(np.isfinite(r[k]) for r in train for k in r if k.startswith(("loss", "grad")))
    assert any("loss/val" in r for r in records)


@pytest.mark.parametrize("args,error,match", [
    (["--tp", "2"], ValueError, "needs a process group: run under torchrun with --distributed"),
    (["--fsdp"], ValueError, "needs a process group: run under torchrun with --distributed"),
    (["--distributed"], RuntimeError, "torchrun environment"),
])
def test_cli_refuses_unported_options(tmp_path, args, error, match, monkeypatch):
    """The mesh options are ported (tests/test_torch_mesh_entry.py runs them over
    gloo); a mesh needs a process group, so without `--distributed` they
    raise, and `--distributed` outside torchrun names what it lacks."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    path, latents = tiny_cli_config(tmp_path)
    with pytest.raises(error, match=match):
        train_cli.main(["--config", str(path), "--latents-dir", str(latents), "--max-steps",
                        "1", "--device", "cpu", *args])


@pytest.mark.parametrize("field,value", [("fsdp", True), ("tp", 2), ("dp", 2), ("sp", 2)])
def test_build_trainer_refuses_a_parallel_config_without_a_mesh(field, value):
    """A dp, tp, sp or fsdp setting needs a mesh: without one build_trainer
    raises instead of building a single-device trainer."""
    from jen1_tpu_torch.config import tiny_test_config

    cfg = tiny_test_config()
    setattr(cfg.parallel_config, field, value)
    with pytest.raises(ValueError, match="needs a process group"):
        train_cli.build_trainer(cfg, device="cpu")


# ---------------------------------------------------------- (g) config


# the port's own fields (jen1_tpu_torch/config.py: Stable Audio Open's model
# family), which no JAX config has; from a JAX config they keep their defaults
PORT_ONLY = {"denoiser", "codec_type", "dit_config", "oobleck_config", "number_start_config"}


def shared_fields(port, ref, path=""):
    """The port's dataclass has the JAX one's fields, at every nesting
    level, and every field equals the JAX one's, tuples as tuples; its own
    fields (PORT_ONLY) hold their defaults."""
    names = [f.name for f in dataclasses.fields(port)]
    own = set(names) - {f.name for f in dataclasses.fields(ref)}
    assert own <= PORT_ONLY, path or "Config"
    assert set(names) - own == {f.name for f in dataclasses.fields(ref)}, path or "Config"
    for name in own:
        assert getattr(port, name) == getattr(type(port)(), name), f"{path}{name}"
    for name in set(names) - own:
        a, b = getattr(port, name), getattr(ref, name)
        if dataclasses.is_dataclass(a):
            shared_fields(a, b, f"{path}{name}.")
        else:
            assert type(a) is type(b) and a == b, f"{path}{name}: {a!r} != {b!r}"


@pytest.mark.parametrize("which", ["default", "longform"])
def test_jax_config_json_loads(tmp_path, which):
    ref = JaxConfig() if which == "default" else jax_longform()
    path = tmp_path / "cfg.json"
    ref.to_json(str(path))
    port = Config.from_json(str(path))
    shared_fields(port, ref)
    if which == "longform":
        shared_fields(longform_config(), ref)


@pytest.mark.parametrize("key,value", [
    ("model_config.use_snake", True), ("model_config.use_stft", True),
    ("model_config.stft_hop_length", 128), ("model_config.use_stft_context", True),
    ("conditioner_config.int_config.max_val", 60),
])
def test_jax_config_with_model_feature_fields_loads(key, value):
    """A JAX JSON with a model-feature field off its default loads, keeps
    the value and builds the model JAX builds from it: the UNet (on the
    meta device: Config() is full width) with Snake in every conv block or
    the STFT front and back, or the int conditioner's 61-row table."""
    d = json.loads(JaxConfig().override(**{key: value}).to_json())
    cfg = Config.from_dict(d)
    section, *rest = key.split(".")
    node = getattr(cfg, section)
    for name in rest:
        node = getattr(node, name)
    assert node == value
    mc = cfg.model_config
    if section == "model_config":
        with torch.device("meta"):
            model = port_unet(mc)
        snakes = [m for m in model.modules() if type(m).__name__ == "Snake1d"]
        assert bool(snakes) == mc.use_snake
        assert (model.unet.stft is not None) == mc.use_stft
        stft_channels = (mc.stft_num_fft // 2 + 1) * 2 if mc.use_stft else 1
        context = mc.context_channels[0] * (stft_channels if mc.use_stft_context else 1)
        assert model.unet.to_in.block.block1.project.weight.shape[1] == (
            mc.in_channels * stft_channels + context)
        assert model.unet.to_out.block.block2.project.weight.shape[0] == (
            mc.out_channels * stft_channels)
        if mc.use_stft:
            assert model.unet.stft.hop_length == mc.stft_hop_length
    else:
        from jen1_tpu_torch.conditioning.conditioners import IntConditioner

        c = cfg.conditioner_config
        table = IntConditioner(c.cond_dim, c.int_config.min_val, c.int_config.max_val,
                               device="cpu").embedding
        assert table.shape == (61, c.cond_dim)


@pytest.mark.parametrize("key", ["conditioner_config.t5_config.weights_path",
                                 "codec_weights_path"])
def test_jax_config_weight_paths_load(tmp_path, key):
    """A JAX JSON with a local weights file keeps the path, and the port loads
    the file through it: the T5 conditioner (an HF state dict for the tiny
    T5) or Jen1's codec (an EnCodec-48k state dict of the facebookresearch
    layout, from tests/encodec_torch_mock.py)."""
    from encodec_torch_mock import MockEncodec

    from jen1_tpu_torch.api.generation import Jen1
    from jen1_tpu_torch.conditioning.conditioners import create_multi_conditioner
    from jen1_tpu_torch.conditioning.t5 import T5EncoderConfig
    from jen1_tpu_torch.config import tiny_test_config
    from torch_port_util import hf_t5_state_dict

    path = tmp_path / "weights.pt"
    torch.manual_seed(0)
    if key == "codec_weights_path":
        sd = MockEncodec().state_dict()
        want = {"codebooks": torch.stack([sd[f"quantizer.vq.layers.{i}._codebook.embed"]
                                          for i in range(16)])}
    else:
        sd = hf_t5_state_dict(0, dataclasses.replace(T5EncoderConfig.tiny_test(),
                                                     vocab_size=259), "shared.weight")
        want = {"encoder.embedding": sd["shared.weight"]}
    torch.save(sd, path)
    d = json.loads(JaxConfig().override(**{key: str(path)}).to_json())
    jcfg = Config.from_dict(d)
    kept = (jcfg.codec_weights_path if key == "codec_weights_path"
            else jcfg.conditioner_config.t5_config.weights_path)
    assert kept == str(path)
    cfg = tiny_test_config()
    cfg.conditioner_config = jcfg.conditioner_config
    cfg.conditioner_config.cond_dim = cfg.model_config.context_embedding_features
    cfg.conditioner_config.t5_config.t5_model_name = "tiny-test"
    cfg.conditioner_config.t5_config.max_length = 6
    cfg.codec_weights_path = jcfg.codec_weights_path
    if key == "codec_weights_path":
        loaded = Jen1(config=cfg, device="cpu").codec
    else:
        loaded = create_multi_conditioner(cfg.conditioner_config, device="cpu").conditioners[
            "prompt"]
    for name, value in want.items():
        assert torch.equal(loaded.state_dict()[name], value.float()), name


def test_config_round_trip_and_override():
    cfg = longform_config().override(**{"dataset_config.sample_duration": 30,
                                        "model_config.attentions": [0, 1, 0]})
    assert cfg.model_config.attentions == (0, 1, 0)
    again = Config.from_dict(json.loads(cfg.to_json()))
    assert again == cfg and again.dataset_config.sample_duration == 30


def test_metric_logger_histograms_images_audio(tmp_path):
    """The port's MetricLogger has the JAX logger's surface
    (tests/test_misc.py:89-102): scalars, histograms, images, audio and
    per-index vectors land in metrics.jsonl and TensorBoard."""
    import os

    from jen1_tpu_torch.utils.logger import MetricLogger

    ml = MetricLogger(str(tmp_path))
    ml.log(1, {"loss/train": 0.5, "lr": 3e-5})
    ml.log_histograms(1, {"params/w": np.random.default_rng(0).normal(size=64),
                          "grads/w": torch.randn(64)})
    ml.log_images(1, {"latent/spec": np.zeros((3, 8, 8), np.float32)})
    ml.log_audio(1, "sample", np.zeros((1, 160), np.float32), 1600)
    ml.log_vectors({"loss/per_timestep": [0.9, 0.5, 0.3]})
    ml.close()
    rec = json.loads((tmp_path / "metrics.jsonl").read_text().splitlines()[0])
    assert rec["step"] == 1 and rec["loss/train"] == 0.5
    if ml._tb is not None:  # tensorboard installed: event file written
        assert any(n.startswith("events.") for n in os.listdir(tmp_path))
