"""Port parity of `utils/factories.py`: the reference-parity construction
names build the port's objects as jen1_tpu's build the JAX ones."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jen1_tpu.config import tiny_test_config as jax_tiny
from jen1_tpu.utils import factories as jf
from jen1_tpu_torch.config import tiny_test_config
from jen1_tpu_torch.models.unet import UNetCFG1d
from jen1_tpu_torch.utils import factories as pf


@pytest.mark.parametrize("x", [1, 3, 5.5, 6, 100, 1000, 4500])
def test_helpers_equal_jax(x):
    assert pf.closest_power_2(x) == jf.closest_power_2(x)
    assert pf.default(None, lambda: x) == jf.default(None, lambda: x) == x
    assert pf.exists(x) and not pf.exists(None)


def test_create_model_matches_jax_parameter_count():
    jcfg, pcfg = jax_tiny(), tiny_test_config()
    model = pf.create_model(pcfg, device="cpu")
    assert isinstance(model, UNetCFG1d)
    mc = jcfg.model_config
    shapes = jax.eval_shape(lambda r: jf.create_model(jcfg).init(
        r, jnp.zeros((1, 40, mc.in_channels)), jnp.zeros((1,)),
        embedding=jnp.zeros((1, mc.context_embedding_max_length,
                             mc.context_embedding_features)),
        channels_list=[jnp.zeros((1, 40, mc.context_channels[0]))]), jax.random.PRNGKey(0))
    jax_count = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == jax_count
    again = pf.create_model(pcfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


@pytest.mark.parametrize("kind", ["gdm", "vdm"])
def test_create_model_and_diffusion(kind):
    jcfg, pcfg = jax_tiny(), tiny_test_config()
    jcfg.diffusion_type = pcfg.diffusion_type = kind
    _, diffusion = pf.create_model_and_diffusion(pcfg, sampling_steps=4, device="cpu")
    ref = jf.create_diffusion(jcfg, sampling_steps=4)
    assert type(diffusion).__name__ == type(ref).__name__
    if kind == "gdm":
        assert diffusion.num_timesteps == ref.num_timesteps
    pcfg.diffusion_type = "other"
    with pytest.raises(ValueError, match="unknown diffusion_type"):
        pf.create_diffusion(pcfg, device="cpu")


def test_create_multi_conditioner():
    cfg = tiny_test_config().conditioner_config
    cfg.t5_config.t5_model_name = "tiny-test"
    cfg.conditioning_type = ("t5", "int", "number")
    mc = pf.create_multi_conditioner(cfg, device="cpu")
    assert list(mc.conditioners) == ["prompt", "seconds_start", "seconds_total"]
