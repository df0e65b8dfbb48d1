"""Load JAX (flax) parameter trees into the port's modules.

The inverse of the layouts listed in jen1_tpu/ckpt/torch_export.py:9-13.
A tree is a nested dict of numpy arrays, as `jax.tree.map(np.asarray,
params)` gives it; a level that holds only a "params" key is stepped
through. Port submodules carry the flax names, so each leaf path names its
module, and the leaf is transposed into torch layout:

  Linear kernel (in, out)        -> weight (out, in)
  Conv kernel   (K, in, out)     -> weight (out, in, K)
  ConvT kernel  (K, in, out)     -> weight (in, out, K)
  LSTM  l{i}_w_ih / l{i}_w_hh (in, 4H) -> weight_ih_l{i} / weight_hh_l{i} (4H, in)
  norm scale                     -> weight

Covers the UNet (`UNetCFG1d`), the T5 conditioner and the codec decoder.
Imports neither JAX nor `jen1_tpu`.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from jen1_tpu_torch.codec.seanet import SConvTranspose1d, SLSTM
from jen1_tpu_torch.ops.conv import Upsample1d


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {"a.b.leaf": array}, stepping through "params"."""
    if set(tree) == {"params"}:
        return flatten(tree["params"], prefix)
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(flatten(value, path + "."))
        else:
            out[path] = np.asarray(value, dtype=np.float32)
    return out


def _target(module: nn.Module, leaf: str, arr: np.ndarray):
    """(torch parameter name, array in torch layout) for one flax leaf."""
    if isinstance(module, SLSTM):
        layer, kind = leaf[1:].split("_", 1)  # "l0_w_ih" -> ("0", "w_ih")
        name = {"w_ih": "weight_ih", "w_hh": "weight_hh",
                "b_ih": "bias_ih", "b_hh": "bias_hh"}[kind]
        return f"lstm.{name}_l{layer}", arr.T if arr.ndim == 2 else arr
    if leaf == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        transposed = isinstance(module, SConvTranspose1d) or (
            isinstance(module, Upsample1d) and module.transposed
        )
        return "weight", arr.transpose(1, 2, 0) if transposed else arr.transpose(2, 1, 0)
    if leaf == "scale":
        return "weight", arr
    return leaf, arr


@torch.no_grad()
def load_flax_params(module: nn.Module, tree: Mapping) -> None:
    """Copy every leaf of `tree` into `module`; every parameter of `module`
    must be written."""
    written = set()
    for path, arr in flatten(tree).items():
        mod_path, leaf = path.rsplit(".", 1) if "." in path else ("", path)
        sub = module.get_submodule(mod_path)
        name, value = _target(sub, leaf, arr)
        param = sub.get_parameter(name)
        if tuple(param.shape) != value.shape:
            raise ValueError(
                f"{path}: JAX shape {arr.shape} -> {value.shape} does not fit "
                f"torch {mod_path}.{name} {tuple(param.shape)}"
            )
        param.copy_(torch.from_numpy(np.array(value, np.float32)))
        written.add(f"{mod_path}.{name}" if mod_path else name)
    missing = {n for n, _ in module.named_parameters()} - written
    if missing:
        raise ValueError(f"parameters not in the JAX tree: {sorted(missing)[:8]}")
