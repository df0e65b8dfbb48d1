"""Port parity of the reference `.pth` exporter (`ckpt/torch_export.py`):
the port's export of a parameter tree, and of a port UNet holding it, has
the JAX exporter's keys and bit-equal arrays, with and without Snake; the
exported file loads back through the port's importer bit for bit."""

import dataclasses

import pytest
import torch

from jen1_tpu.ckpt.torch_export import export_reference_unet as jax_export
from jen1_tpu.models.unet import unet_from_model_config as jax_unet
from jen1_tpu_torch.api.generation import cast_weights_bf16
from jen1_tpu_torch.ckpt.torch_export import (
    export_reference_unet, flax_tree, save_reference_checkpoint,
)
from jen1_tpu_torch.ckpt.torch_import import load_reference_checkpoint
from jen1_tpu_torch.models.unet import unet_from_model_config as port_unet
from torch_port_util import load, random_params, tiny_model_configs, unet_shapes, with_alphas


@pytest.fixture(scope="module", params=[False, True], ids=["silu", "snake"])
def case(request):
    """Tied tiny configs (both packages), random params and a port UNet
    holding them."""
    jcfg, pcfg = tiny_model_configs(tie_transformer_projections=True,
                                    use_snake=request.param, use_xattn_time=True)
    mc = jcfg.model_config
    params = with_alphas(random_params(unet_shapes(jax_unet(mc), mc), seed=6))
    return mc, pcfg.model_config, params, load(port_unet(pcfg.model_config), params)


def assert_same_state(out, ref):
    assert set(out) == set(ref)
    for key, value in ref.items():
        assert out[key].dtype == torch.float32 and out[key].shape == value.shape, key
        assert torch.equal(out[key], value), key


def test_export_of_params_equals_jax(case):
    jmc, pmc, params, _ = case
    ref = jax_export(params, jmc)
    assert_same_state(export_reference_unet(params, pmc), ref)
    alphas = [k for k in ref if k.endswith("activation.alpha")]
    assert bool(alphas) == pmc.use_snake
    assert all(ref[k].shape[0] == 1 and ref[k].shape[2] == 1 for k in alphas)


def test_export_of_module_equals_jax(case):
    jmc, pmc, params, model = case
    assert_same_state(export_reference_unet(model, pmc), jax_export(params, jmc))


def test_flax_tree_inverts_from_jax(case):
    _, pmc, params, model = case
    again = load(port_unet(pmc), flax_tree(model))
    for (name, a), b in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(a, b), name


def test_round_trip_through_torch_import(case, tmp_path):
    """save_reference_checkpoint -> load_reference_checkpoint into a fresh
    UNet: every parameter bit-equal, epoch and learning rate kept; bf16
    weights export as their fp32 values."""
    _, pmc, _, model = case
    path = str(tmp_path / "jen1.pth")
    save_reference_checkpoint(path, model, pmc, epoch=5, learning_rate=2e-5)
    fresh = port_unet(pmc)
    assert load_reference_checkpoint(path, fresh, pmc) == (5, 2e-5)
    for (name, a), b in zip(model.named_parameters(), fresh.parameters()):
        assert torch.equal(a, b), name
    half = port_unet(pmc)
    half.load_state_dict(model.state_dict())
    cast_weights_bf16(half)
    sd = export_reference_unet(half, pmc)
    w = "to_in.block.block1.project.conv.weight"
    assert torch.equal(sd[w], model.unet.to_in.block.block1.project.weight.detach()
                       .bfloat16().float())


def test_export_refuses_untied_projections(case):
    _, pmc, params, _ = case
    with pytest.raises(ValueError, match="tie_transformer_projections"):
        export_reference_unet(params, dataclasses.replace(pmc, tie_transformer_projections=False))
