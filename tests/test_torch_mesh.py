"""The port's device mesh (jen1_tpu_torch/parallel/mesh.py) on the CPU, over
gloo in several processes (tests/torch_mesh_ranks.py: a FileStore in
tmp_path, one torch thread per rank, a timeout on the group and a deadline
on every join).

* `make_mesh`'s shapes and errors and the tp / fsdp plan against
  jen1_tpu.parallel.mesh on the 8 CPU devices of tests/conftest.py, on the
  tiny model and on `longform_config()` (meta device). The one allowed
  difference is the head rule: the port splits to_q / to_kv / to_out over
  tp only where num_heads % tp == 0.
* Training over dp2 x tp2 with fsdp (4 ranks; remat and an EMA on) against
  the single-process port, with the same weights, batches and draws, at
  __graft_entry__.py:253's bars (loss rtol 5e-5, parameters rtol 1e-4 /
  atol 5e-6); LoRA over the same mesh; checkpoints moving between the two
  bit for bit; `flatten_optimizer` off under tp or fsdp. The single-process
  port is held to JAX's train step in tests/test_torch_train.py, which closes
  the chain to JAX.
  The same over dp1 x sp2 x tp2 (4 ranks) and with the tp + fsdp + sp
  triple, dp2 x sp2 x tp2 (8 ranks), which JAX refuses (an XLA fault,
  docs/SPMD_TRIPLE_REPRO.md).
* The entry points over the mesh (`Jen1.mesh`, `batch_generate --dp`,
  `train --distributed`): tests/test_torch_mesh_entry.py.
"""

import re

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from jen1_tpu.parallel import mesh as jmesh
from jen1_tpu_torch.parallel import mesh as pmesh
from torch_port_util import one_torch_thread

LOSS_RTOL = 5e-5
PARAM_BAR = dict(rtol=1e-4, atol=5e-6)


# ------------------------------------------------------------ the plan


@pytest.mark.parametrize("dp,tp,sp", [
    (-1, 1, 1), (-1, 2, 1), (-1, 4, 1), (-1, 2, 2), (2, 2, 2), (8, 1, 1), (1, 1, 8),
    (-1, 3, 1), (4, 4, 1), (-1, 16, 1),
])
def test_make_mesh_shapes_and_errors_match_jax(dp, tp, sp):
    try:
        ref = jmesh.make_mesh(dp=dp, tp=tp, sp=sp).devices.shape
    except AssertionError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            pmesh.mesh_shape(8, dp, tp, sp)
        return
    assert pmesh.mesh_shape(8, dp, tp, sp) == ref


def test_make_mesh_spans_the_world_and_needs_a_group():
    """JAX may leave devices out of a mesh; a torch.distributed mesh spans
    every rank of its group, and make_mesh needs the group. The shardings
    are DTensor placements over (dp, sp, tp), as JAX's PartitionSpecs."""
    from torch.distributed.tensor import Replicate, Shard

    assert pmesh.replicated(None) == (Replicate(),) * 3
    assert pmesh.batch_sharding(None) == (Shard(0), Replicate(), Replicate())
    assert pmesh.seq_sharding(None) == (Shard(0), Shard(1), Replicate())
    assert jmesh.make_mesh(dp=2, tp=2).devices.shape == (2, 1, 2)
    with pytest.raises(ValueError, match="spans every rank"):
        pmesh.mesh_shape(8, 2, 2, 1)
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.make_mesh()


def _jax_params(cfg):
    from jen1_tpu.models.unet import unet_from_model_config

    mc = cfg.model_config
    model = unet_from_model_config(mc)
    return jax.eval_shape(lambda r: model.init(
        r, jax.numpy.zeros((1, 64, mc.in_channels)), jax.numpy.zeros((1,)),
        embedding=jax.numpy.zeros((1, mc.context_embedding_max_length,
                                   mc.context_embedding_features)),
        channels_list=[jax.numpy.zeros((1, 64, mc.context_channels[0]))],
    ), jax.random.PRNGKey(0))["params"]


def _port_model(cfg):
    from jen1_tpu_torch.models.unet import unet_from_model_config

    with torch.device("meta"):
        return unet_from_model_config(cfg.model_config)


@pytest.fixture(scope="module")
def plan_models():
    from jen1_tpu.config import longform_config as jlong, tiny_test_config as jtiny
    from jen1_tpu_torch.config import longform_config as plong, tiny_test_config as ptiny

    return {"tiny": (_jax_params(jtiny()), _port_model(ptiny())),
            "longform": (_jax_params(jlong()), _port_model(plong()))}


def _jax_plan(params, tp, fsdp):
    """{flax path: spec, padded to the leaf's rank} of JAX's plan."""
    mesh = jmesh.make_mesh(dp=8 // tp, tp=tp)
    specs = jmesh.param_shardings(params, mesh, fsdp=fsdp)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    shardings = jax.tree_util.tree_leaves(specs)
    return {"/".join(str(k.key) for k in kp): tuple(sh.spec) + (None,) * (x.ndim - len(sh.spec))
            for (kp, x), sh in zip(flat, shardings)}


def _port_plan_in_flax_layout(model, tp, fsdp):
    out = {}
    for name, spec in pmesh.param_shardings(model, {"dp": 8 // tp, "tp": tp}, fsdp).items():
        path, dims = pmesh._flax_path_and_dims(model, name, len(spec))
        out[path] = tuple(spec[d] for d in dims)
    return out


@pytest.mark.parametrize("which", ["tiny", "longform"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("fsdp", [False, True])
def test_param_plan_matches_jax(plan_models, which, tp, fsdp):
    params, model = plan_models[which]
    ref = _jax_plan(params, tp, fsdp)
    got = _port_plan_in_flax_layout(model, tp, fsdp)
    assert set(got) == set(ref)
    differ = sorted(p for p in ref if got[p] != ref[p])
    heads = {name: m.num_heads for name, m in model.named_modules()
             if type(m).__name__ == "Attention"}
    # the head rule: JAX splits an attention projection where its dimension
    # divides, the port only on head boundaries (and then fsdp may take it)
    expected = sorted(
        p for p in ref
        if p.split("/")[-2] in ("to_q", "to_kv", "to_out") and p.endswith("/kernel")
        and "tp" in ref[p] and heads[".".join(p.split("/")[:-2])] % tp)
    assert differ == expected
    assert all("tp" not in got[p] for p in differ)
    assert bool(differ) == (which == "tiny" and tp == 4)  # two heads, four ranks


# ------------------------------------------------------------ training


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """The single-process port (full and LoRA) and the same runs over a
    dp2 x tp2 mesh with fsdp on 4 ranks, with remat and an EMA."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    with one_torch_thread():
        trainer, state, losses, norms = ranks.single_train({"remat": True}, 3)
        ref = ranks.full_state(trainer, state)
        lora, lstate, llosses, lnorms = ranks.single_train({"lora_rank": 4, "remat": True}, 2)
        lref = ranks.full_state(lora, lstate)
    torch.save(ref, tmp / "ref.pt")
    out = ranks.spawn(ranks.mesh_train, 4, tmp, 2, 1, 2, True, 3, str(tmp / "ref.pt"),
                      True)[0]
    return {"losses": losses, "grad_norms": norms, "state": ref, "lora_losses": llosses,
            "lora_grad_norms": lnorms, "lora_state": lref,
            "mesh": out, "trainer": trainer}


def _assert_params_close(got, ref):
    """The parameters (and the EMA) at the dryrun bars."""
    assert set(got) == set(ref)
    for k in ref:
        if k.startswith(("params/", "ema_params/")):
            torch.testing.assert_close(got[k], ref[k], **PARAM_BAR, msg=k)


def test_dp2_tp2_fsdp_train_matches_single_process(train_runs):
    mesh = train_runs["mesh"]
    np.testing.assert_allclose(mesh["losses"], train_runs["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(mesh["grad_norms"], train_runs["grad_norms"], rtol=LOSS_RTOL)
    _assert_params_close(mesh["state"], train_runs["state"])
    assert train_runs["state"]["step"] == mesh["state"]["step"] == 3
    assert any(k.startswith("ema_params/") for k in mesh["state"])
    # the run was sharded: tp took the attention and FFN projections, FSDP2 the rest
    tp_names, dp_names = mesh["sharded"]["tp"], mesh["sharded"]["dp"]
    for leaf in ("to_q.weight", "to_kv.weight", "to_out.weight", "linear1.weight",
                 "linear1.bias", "linear2.weight"):
        assert any(n.endswith(leaf) for n in tp_names), leaf
    assert not set(tp_names) & set(dp_names)
    assert len(dp_names) > len(tp_names) and any("to_out.bias" in n for n in dp_names)


def test_dp2_tp2_lora_matches_single_process(train_runs):
    mesh = train_runs["mesh"]
    np.testing.assert_allclose(mesh["lora_losses"], train_runs["lora_losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(mesh["lora_grad_norms"], train_runs["lora_grad_norms"],
                               rtol=LOSS_RTOL)
    _assert_params_close(mesh["lora_state"], train_runs["lora_state"])
    assert all(".kernel." in k for k in mesh["lora_state"] if k.startswith("params/"))


def test_checkpoints_move_between_mesh_and_single_process_bit_for_bit(train_runs):
    """The single-process state loaded into the mesh trainer gathers back
    unchanged, and the mesh run's gathered state loads into a
    single-process trainer unchanged."""
    ref, mesh = train_runs["state"], train_runs["mesh"]
    assert set(mesh["reloaded"]) == set(ref)
    for k in ref:
        assert torch.equal(mesh["reloaded"][k], ref[k]), k
    trainer = train_runs["trainer"]
    with one_torch_thread():
        back = ranks.full_state(trainer, trainer.load_state_dict(mesh["state"]))
    for k in mesh["state"]:
        assert torch.equal(back[k], mesh["state"][k]), k


def test_flatten_optimizer_turns_off_when_params_are_sharded(train_runs):
    """As jen1_tpu/train/trainer.py:71-92: tp > 1 or fsdp turns the flat
    optimizer off; a dp-only mesh keeps it, and its two steps of the flat
    chain are the single-process run's."""
    flatten = dict(train_runs["mesh"]["flatten"])
    losses, norms, state = flatten.pop("dp4_run")
    assert flatten == {"dp4": True, "dp2_tp2": False, "dp4_fsdp": False}
    cfg = ranks.train_config(flatten=True)
    cfg.dataset_config.batch_size = 12
    with one_torch_thread():
        trainer = ranks.build(cfg)
        ref_state, ref_losses, ref_norms = ranks.run_steps(trainer, cfg, 2)
        ref = ranks.full_state(trainer, ref_state)
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(norms, ref_norms, rtol=LOSS_RTOL)
    _assert_params_close(state, ref)
    assert any(k.endswith("/__flat__") for k in ref)


@pytest.mark.parametrize("dp,sp,tp,fsdp,remat", [(1, 2, 2, False, False),
                                                 (2, 2, 2, True, True)],
                         ids=["dp1_sp2_tp2", "dp2_sp2_tp2_fsdp_remat"])
def test_sp_train_matches_single_process(tmp_path, dp, sp, tp, fsdp, remat):
    """The latent's length split over sp (halo exchanges before every conv,
    GroupNorm statistics and the transformers over the whole length), with
    tp, and with fsdp over dp and remat recomputing the collectives in the
    backward: the single-process run at the dryrun bars."""
    with one_torch_thread():
        trainer, state, losses, norms = ranks.single_train({"remat": remat}, 3)
        ref = ranks.full_state(trainer, state)
    out = ranks.spawn(ranks.mesh_train, dp * sp * tp, tmp_path, dp, sp, tp, fsdp, 3, None,
                      remat)[0]
    np.testing.assert_allclose(out["losses"], losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(out["grad_norms"], norms, rtol=LOSS_RTOL)
    _assert_params_close(out["state"], ref)
    assert bool(out["sharded"]["dp"]) == fsdp and out["sharded"]["tp"]
