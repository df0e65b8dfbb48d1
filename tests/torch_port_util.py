"""Helpers shared by the `tests/test_torch_*.py` parity tests: the same numpy
inputs and weights go through a JAX function and its counterpart in
`jen1_tpu_torch`, which runs on the CPU with its plain kernels."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from jen1_tpu_torch.ckpt.from_jax import load_flax_params


def np_tree(tree):
    """A flax parameter tree as nested dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def load(module: torch.nn.Module, flax_params) -> torch.nn.Module:
    """Load a flax parameter tree into a port module (strict) and return it."""
    load_flax_params(module, np_tree(flax_params))
    return module.eval()


def random_params(shape_tree, seed: int):
    """A parameter tree of the shapes of `shape_tree` (e.g. from
    `jax.eval_shape(model.init, ...)`), drawn with numpy: U(+-1/sqrt(fan_in))
    kernels and biases, norm scales near 1, N(0, 1) embeddings and Fourier
    weights. Cheaper than compiling the JAX init."""
    g = rng(seed)

    def draw(name, shape):
        if name == "scale":
            return (1.0 + 0.1 * g.standard_normal(shape)).astype(np.float32)
        if name in ("kernel", "bias"):
            fan_in = int(np.prod(shape[:-1])) if name == "kernel" else shape[0]
            b = 1.0 / np.sqrt(max(fan_in, 1))
            return g.uniform(-b, b, shape).astype(np.float32)
        return g.standard_normal(shape).astype(np.float32)

    def walk(tree):
        return {
            k: walk(v) if hasattr(v, "items") else draw(k, tuple(v.shape))
            for k, v in tree.items()
        }

    return walk(shape_tree)


def rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def randn(g: np.random.Generator, *shape) -> np.ndarray:
    return g.standard_normal(shape).astype(np.float32)


def assert_close(port, ref, rtol: float, atol: float) -> None:
    if isinstance(port, torch.Tensor):
        port = port.detach().cpu().numpy()
    np.testing.assert_allclose(
        np.asarray(port, np.float32), np.asarray(ref, np.float32), rtol=rtol, atol=atol
    )


def flash_model_configs(flash_min_seq_len: int = 128):
    """The JAX and port tiny_test_config() with the flash path engaged."""
    from jen1_tpu.config import tiny_test_config as jax_tiny
    from jen1_tpu_torch.config import tiny_test_config as port_tiny

    kw = dict(use_flash_attention=True, flash_min_seq_len=flash_min_seq_len)
    jcfg, pcfg = jax_tiny(), port_tiny()
    jcfg.model_config = dataclasses.replace(jcfg.model_config, **kw)
    pcfg.model_config = dataclasses.replace(pcfg.model_config, **kw)
    return jcfg, pcfg


def vdm_initial_noise(seed: int, shape) -> np.ndarray:
    """The JAX Jen1.generate VDM stream: fold_in(key(seed), 2), split, and
    the first half drawn as N(0, 1) (generation.py:429,648; vdm.py:157-158)."""
    rng_init, _ = jax.random.split(jax.random.fold_in(jax.random.key(seed), 2))
    return np.array(jax.random.normal(rng_init, shape, jax.numpy.float32))


def gdm_draws(key, shape, fold_values):
    """The draws of the JAX `GaussianDiffusion.sample(..., rng=key)`: split
    the key, x_T from the first half; the step that folds `v` into the
    second half draws its noise from split(fold_in(rng_loop, v))[1]
    (gdm.py:318-332, :454-473). DDIM folds the step index, DDPM the
    timestep. Returns (x_T, [noise per fold value])."""
    rng_init, rng_loop = jax.random.split(key)
    x_t = np.array(jax.random.normal(rng_init, shape, jax.numpy.float32))
    noises = [
        np.array(jax.random.normal(jax.random.split(jax.random.fold_in(rng_loop, v))[1],
                                   shape, jax.numpy.float32))
        for v in fold_values
    ]
    return x_t, noises


def inject_gdm_draws(monkeypatch, x_t, noises) -> None:
    """Make jen1_tpu_torch's GDM samplers take x_T and step i's noise from
    the given arrays instead of their generator."""
    from jen1_tpu_torch.diffusion import gdm

    monkeypatch.setattr(gdm, "initial_noise",
                        lambda shape, generator, device: torch.from_numpy(x_t).to(device))
    monkeypatch.setattr(gdm, "step_noise",
                        lambda x, generator, index, uniform=False:
                        torch.from_numpy(noises[index]).to(x.device))
