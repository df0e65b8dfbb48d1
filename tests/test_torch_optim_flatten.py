"""Port parity of `flatten_optimizer`: jen1_tpu_torch's optax-semantics chain
over one concatenated fp32 vector against jen1_tpu's `optax.flatten` chain,
and the flat layout of the trainer's checkpoint.

Bars: parameters after every update rtol 1e-5 (the optimizer bar of
tests/test_torch_train.py); the flat and per-parameter chains agree at the
same bar (only the global norm's summation order differs).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from jen1_tpu.config import OptimizerConfig as JaxOptimizerConfig
from jen1_tpu.train.optim import make_optimizer as jax_make_optimizer
from jen1_tpu_torch.config import OptimizerConfig
from jen1_tpu_torch.diffusion.gdm import create_gaussian_diffusion
from jen1_tpu_torch.models.unet import unet_from_model_config as port_unet
from jen1_tpu_torch.ops.initializers import init_module
from jen1_tpu_torch.train.optim import flat_fp32, make_optimizer
from jen1_tpu_torch.train.trainer import FLAT_NAME, UnifiedMultiTaskTrainer
from test_torch_train import OPT, Coin, opt_problem, step_batch
from torch_port_util import assert_close, flash_model_configs


@pytest.mark.parametrize("accum", [1, 2])
def test_flatten_optimizer_matches_jax(accum):
    """clip -> AdamW -> apply_if_finite (-> MultiSteps) over one vector, 3
    updates (with a non-finite gradient that skips its update), against
    optax.flatten of the JAX chain."""
    oc = dataclasses.replace(OptimizerConfig(), flatten_optimizer=True)
    joc = dataclasses.replace(JaxOptimizerConfig(), flatten_optimizer=True)
    n_calls = 4 * accum
    params, grads = opt_problem(2, n_calls, bad_step=1 if accum == 1 else n_calls - 1)
    tx = jax_make_optimizer(joc, accum)
    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    chain = make_optimizer(oc, accum)
    pp = [torch.from_numpy(p.copy()) for p in params]
    ps = chain.init(pp)
    total = sum(p.size for p in params)
    assert [tuple(m.shape) for m in ps.mu] == [(total,)]
    for g in grads:
        updates, js = tx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, updates)
        ps = chain.update([torch.from_numpy(x) for x in g], ps, pp)
        for a, b in zip(pp, jp):
            assert_close(a, b, **OPT)
    assert ps.count == 3 and ps.total_notfinite == 1
    assert_close(ps.mu[0], jax_mu(js), **OPT)


def jax_mu(state):
    """The (flat) first moment of the AdamW inside a JAX chain state."""
    nodes = jax.tree_util.tree_leaves(
        state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
    return next(n for n in nodes if isinstance(n, optax.ScaleByAdamState)).mu


def test_flat_and_per_parameter_chains_agree():
    params, grads = opt_problem(3, 4)
    runs = []
    for flatten in (False, True):
        chain = make_optimizer(dataclasses.replace(OptimizerConfig(), flatten_optimizer=flatten))
        pp = [torch.from_numpy(p.copy()) for p in params]
        state = chain.init(pp)
        for g in grads:
            state = chain.update([torch.from_numpy(x) for x in g], state, pp)
        runs.append((pp, state))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert_close(a, b, **OPT)
    assert_close(flat_fp32(runs[0][1].nu), runs[1][1].nu[0], **OPT)


def trainer(pcfg, flatten):
    cfg = copy.deepcopy(pcfg)
    cfg.grad_accum_every = 2
    cfg.optimizer_config = dataclasses.replace(cfg.optimizer_config, flatten_optimizer=flatten)
    model = init_module(port_unet(cfg.model_config), torch.Generator().manual_seed(0))
    return UnifiedMultiTaskTrainer(
        cfg, model, create_gaussian_diffusion(cfg.diffusion_config.gaussian_diffusion),
        device="cpu")


def test_trainer_checkpoint_carries_the_flat_layout():
    """A flat trainer's state_dict holds one vector per optimizer field and
    restores into a flat trainer; a trainer with the other setting of the
    flag refuses it, and the reverse, naming the flag."""
    _, pcfg = flash_model_configs()
    flat_tr, plain_tr = trainer(pcfg, True), trainer(pcfg, False)
    batch = {k: torch.from_numpy(v) for k, v in step_batch(pcfg.model_config, 48).items()}
    state = flat_tr.init_state()
    for i in range(2):
        state, _ = flat_tr.train_step(state, batch, torch.Generator().manual_seed(i), Coin(i))
    saved = flat_tr.state_dict(state)
    n = sum(p.numel() for p in flat_tr.params)
    assert {k: tuple(v.shape) for k, v in saved.items() if k.startswith("opt/") and
            v.ndim} == {f"opt/{f}/{FLAT_NAME}": (n,) for f in ("mu", "nu", "acc")}
    assert state.opt_state.count == 1
    again = trainer(pcfg, True)
    restored = again.load_state_dict(saved)
    assert torch.equal(restored.opt_state.mu[0], state.opt_state.mu[0])
    assert restored.opt_state.count == 1 and restored.step == 2
    with pytest.raises(ValueError, match="flatten_optimizer=True.*flatten_optimizer=False"):
        plain_tr.load_state_dict(saved)
    with pytest.raises(ValueError, match="flatten_optimizer=False.*flatten_optimizer=True"):
        again.load_state_dict(plain_tr.state_dict(plain_tr.init_state()))
