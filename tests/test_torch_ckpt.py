"""Port parity of checkpoints: jen1_tpu_torch's `CheckpointManager` (a torch
format, one directory per step) against jen1_tpu's Orbax-backed one, and
training resume: a run stopped and resumed from its save_dir is bit-identical
to the unbroken run, with fused AdamW and with the accumulating optax-
semantics chain.

Bars: retained steps, `latest_step` and `best_step` equal to the JAX
manager's for the same (step, loss) saves; a round trip and a resumed run
bit-identical (`torch.equal`).
"""

import json
import os

import numpy as np
import pytest
import torch

from jen1_tpu.ckpt.checkpoint import CheckpointManager as JaxCheckpointManager
from jen1_tpu_torch.ckpt import checkpoint as port_checkpoint
from jen1_tpu_torch.ckpt.checkpoint import CheckpointManager
from jen1_tpu_torch.config import tiny_test_config
from jen1_tpu_torch.train import train as train_cli
from torch_port_util import randn, rng

# (step, loss): ties, a late best, a save worse than every kept one
SAVES = [(1, 0.5), (2, 0.3), (3, 0.7), (4, 0.3), (5, 0.1), (6, 0.9), (7, 0.3), (9, 0.2)]


@pytest.mark.parametrize("keep_best", [True, False])
def test_retention_matches_jax(tmp_path, keep_best):
    jm = JaxCheckpointManager(str(tmp_path / "jax"), max_to_keep=3, keep_best=keep_best)
    pm = CheckpointManager(str(tmp_path / "port"), max_to_keep=3, keep_best=keep_best)
    for step, loss in SAVES:
        jm.save(step, {"w": np.full((2,), step, np.float32)}, loss=loss)
        pm.save(step, {"w": torch.full((2,), float(step))}, loss=loss)
        assert pm.all_steps() == sorted(jm.manager.all_steps()), step
        assert pm.latest_step() == jm.latest_step(), step
        assert pm.best_step() == jm.best_step(), step
    state, meta = pm.restore(pm.best_step())
    assert meta["loss"] == dict(SAVES)[pm.best_step()]
    assert torch.equal(state["w"], torch.full((2,), float(pm.best_step())))


def flat_state(seed: int):
    g = rng(seed)
    return {
        "params/a.weight": torch.from_numpy(randn(g, 4, 3)),
        "params/b.bias": torch.from_numpy(randn(g, 5)).to(torch.bfloat16),
        "opt/count": torch.tensor(7, dtype=torch.int64),
        "mask": torch.from_numpy(g.standard_normal(6) > 0),
    }


def test_round_trip_is_bit_identical(tmp_path):
    pm = CheckpointManager(str(tmp_path))
    state = flat_state(0)
    pm.save(3, state, loss=1.25, learning_rate=1e-4, extra_meta={"best_val": 1.25})
    back, meta = CheckpointManager(str(tmp_path)).restore()
    assert meta == {"loss": 1.25, "learning_rate": 1e-4, "best_val": 1.25}
    assert list(back) == list(state)
    for k, v in state.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    assert sorted(os.listdir(tmp_path / "3")) == ["meta.json", "state.pt"]
    with pytest.raises(ValueError, match="already exists"):
        pm.save(3, state, loss=1.0)
    assert pm.restore_best()[1]["loss"] == 1.25


def test_restore_partial_matches_jax(tmp_path):
    """A template with one resized leaf and one new leaf: both packages copy
    the matching leaves and name the same skipped ones."""
    g = rng(1)
    saved = {"enc": {"w": randn(g, 4, 3), "b": randn(g, 3)}, "head": randn(g, 2, 2)}
    template = {"enc": {"w": np.zeros((4, 3), np.float32), "b": np.zeros((3,), np.float32)},
                "head": np.zeros((3, 2), np.float32), "extra": np.ones((2,), np.float32)}
    jm = JaxCheckpointManager(str(tmp_path / "jax"))
    jm.save(1, saved, loss=0.0)
    jmerged, jskipped = jm.restore_partial(template)

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict) else
                       {prefix + k: torch.from_numpy(np.array(v))})
        return out

    pm = CheckpointManager(str(tmp_path / "port"))
    pm.save(1, flat(saved), loss=0.0)
    merged, skipped = pm.restore_partial(flat(template))
    assert skipped == ["/".join(p) for p in jskipped] == ["head", "extra"]
    jflat = flat(jmerged)
    assert list(merged) == list(jflat)
    for k in merged:
        assert torch.equal(merged[k], jflat[k]), k


def test_killed_save_leaves_previous_checkpoint(tmp_path, monkeypatch):
    """A save that dies between writing and renaming its step leaves the
    previous latest step readable and no partial step behind."""
    pm = CheckpointManager(str(tmp_path))
    first = flat_state(2)
    pm.save(1, first, loss=0.5)

    def killed(src, dst):
        raise KeyboardInterrupt("killed between write and rename")

    monkeypatch.setattr(port_checkpoint.os, "replace", killed)
    with pytest.raises(KeyboardInterrupt):
        pm.save(2, flat_state(3), loss=0.1)
    monkeypatch.undo()
    again = CheckpointManager(str(tmp_path))
    assert again.all_steps() == [1] and again.latest_step() == 1
    assert os.listdir(tmp_path) == ["1"]
    back, _ = again.restore()
    assert all(torch.equal(back[k], v) for k, v in first.items())


# ------------------------------------------------------------- resume


def tiny_run_config(tmp_path, accum: int):
    cfg = tiny_test_config()
    cfg.conditioner_config.t5_config.t5_model_name = "tiny-test"
    cfg.conditioner_config.t5_config.max_length = cfg.model_config.context_embedding_max_length
    cfg.eval_interval = 1
    cfg.grad_accum_every = accum
    cfg.use_ema, cfg.ema_decay = True, 0.9
    latents = tmp_path / "latents"
    latents.mkdir(exist_ok=True)
    g = rng(0)
    for i in range(6):  # 3 train, 3 val windows: one batch of 3 per epoch
        np.save(latents / f"clip{i}.npy", randn(g, 48, 8))
        (latents / f"clip{i}.json").write_text(json.dumps({"prompt": f"song {i}"}))
    cfg.dataset_config.latents_dir = str(latents)
    return cfg


def losses(log_dir, after: int = 0):
    """{(step, kind): {loss key: value}} of metrics.jsonl, steps > after."""
    out = {}
    for line in (log_dir / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["step"] > after:
            kind = "val" if "loss/val" in rec else "train"
            out[(rec["step"], kind)] = {k: v for k, v in rec.items()
                                        if k.startswith(("loss", "grad_norm"))}
    return out


def run(cfg, save_dir, log_dir, max_steps):
    cfg.save_dir, cfg.log_dir = str(save_dir), str(log_dir)
    return train_cli.run(cfg, max_steps=max_steps, device="cpu")


@pytest.mark.parametrize("accum", [1, 2], ids=["fused_adamw", "chain_accum2"])
def test_resumed_run_is_bit_identical(tmp_path, accum):
    """N steps unbroken against k steps, a stop, and a resume to N from the
    latest checkpoint: the resumed run's losses (train and val) from its
    resume point, its final parameters, optimizer moments, accumulator,
    counters and EMA, and the checkpoints it keeps equal the unbroken run's."""
    n, k = 5, 3
    cfg = tiny_run_config(tmp_path, accum)
    trainer_a, state_a = run(cfg, tmp_path / "ckpt_a", tmp_path / "log_a", n)
    run(cfg, tmp_path / "ckpt_b", tmp_path / "log_b1", k)
    start = CheckpointManager(str(tmp_path / "ckpt_b")).latest_step()
    assert 1 <= start <= k
    trainer_b, state_b = run(cfg, tmp_path / "ckpt_b", tmp_path / "log_b2", n - start)
    assert state_a.step == state_b.step == n
    resumed = losses(tmp_path / "log_b2")
    assert resumed and min(s for s, _ in resumed) == start + 1
    unbroken = losses(tmp_path / "log_a", after=start)
    assert resumed == unbroken
    flat_a, flat_b = trainer_a.state_dict(state_a), trainer_b.state_dict(state_b)
    assert list(flat_a) == list(flat_b)
    assert any(k.startswith("ema_params/") for k in flat_a)
    assert any(k.startswith("opt/acc/") for k in flat_a) == (accum > 1)
    for name, t in flat_a.items():
        assert torch.equal(t, flat_b[name]), name
    steps_a = CheckpointManager(str(tmp_path / "ckpt_a")).all_steps()
    assert CheckpointManager(str(tmp_path / "ckpt_b")).all_steps() == steps_a


def test_state_dict_round_trip_onto_a_fresh_trainer(tmp_path):
    """load_state_dict refuses a state of another trainer and restores its
    own exactly."""
    from jen1_tpu_torch.train.train import build_trainer

    cfg = tiny_run_config(tmp_path, 2)
    trainer = build_trainer(cfg, device="cpu")
    state = trainer.init_state()
    state.step, state.opt_state.mini_step = 3, 1
    flat = {k: v.clone() for k, v in trainer.state_dict(state).items()}
    flat["opt/mu/" + next(iter(dict(trainer.model.named_parameters())))] += 1.0
    fresh = build_trainer(cfg, device="cpu")
    back = fresh.load_state_dict(flat)
    assert back.step == 3 and back.opt_state.mini_step == 1
    for name, t in fresh.state_dict(back).items():
        assert torch.equal(t, flat[name]), name
    cfg.use_ema = False
    with pytest.raises(ValueError, match="does not fit"):
        build_trainer(cfg, device="cpu").load_state_dict(flat)
