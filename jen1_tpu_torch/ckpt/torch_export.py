"""Export the port's UNetCFG1d to the reference JEN-1 `.pth` layout (port of
jen1_tpu/ckpt/torch_export.py).

The inverse of `ckpt/torch_import.py`: the UNet's weights, from a port
module or from a JAX-layout parameter tree (nested dicts of arrays, as
`ckpt/from_jax.py` reads them), become the torch state_dict of the
reference UNetCFG1d (jen1/model/model.py), under the reference's names:

  kernel (in, out)    -> torch Linear  (out, in)
  kernel (K, in, out) -> torch Conv1d  (out, in, K)
  kernel (K, in, out) -> torch ConvT1d (in, out, K)
  scale/bias          -> norm weight/bias
  snake alpha (C,)    -> activation.alpha (1, C, 1)

A port module is first read into the JAX layout (`flax_tree`, the inverse
of `from_jax.load_flax_params`), so both inputs take the same code. The
reference ties each Transformer1d's in/out 1x1 conv, so the model config
must have tie_transformer_projections=True.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from jen1_tpu_torch.ops.conv import Upsample1d


def flax_tree(module: nn.Module) -> Dict[str, Any]:
    """A port UNet's parameters as the JAX package's tree of fp32 numpy
    arrays (names unchanged; weight -> kernel or scale in JAX layout)."""
    tree: Dict[str, Any] = {}
    for name, p in module.named_parameters():
        path, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        sub = module.get_submodule(path)
        arr = p.detach().float().cpu().numpy()
        if leaf == "weight" and arr.ndim == 1:
            leaf = "scale"
        elif leaf == "weight" and arr.ndim == 2:
            leaf, arr = "kernel", arr.T
        elif leaf == "weight":
            transposed = isinstance(sub, Upsample1d) and sub.transposed
            leaf, arr = "kernel", arr.transpose(2, 0, 1) if transposed else arr.transpose(2, 1, 0)
        node = tree
        for key in path.split(".") if path else ():
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _lin(out: Dict, p: Mapping, name: str) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{name}.bias"] = _t(p["bias"])


def _conv(out: Dict, p: Mapping, name: str) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(2, 1, 0))
    out[f"{name}.bias"] = _t(p["bias"])


def _convtr(out: Dict, p: Mapping, name: str) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(1, 2, 0))
    out[f"{name}.bias"] = _t(p["bias"])


def _norm(out: Dict, p: Mapping, name: str) -> None:
    out[f"{name}.weight"] = _t(p["scale"])
    out[f"{name}.bias"] = _t(p["bias"])


def _conv_block(out: Dict, p: Mapping, pre: str) -> None:
    if "groupnorm" in p:
        _norm(out, p["groupnorm"], f"{pre}.groupnorm")
    if "snake" in p:
        out[f"{pre}.activation.alpha"] = _t(np.asarray(p["snake"]["alpha"]).reshape(1, -1, 1))
    _conv(out, p["project"], f"{pre}.project.conv")


def _resnet(out: Dict, p: Mapping, pre: str) -> None:
    _conv_block(out, p["block1"], f"{pre}.block1")
    _conv_block(out, p["block2"], f"{pre}.block2")
    if "to_scale_shift" in p:
        _lin(out, p["to_scale_shift"]["to_scale_shift"], f"{pre}.to_scale_shift.to_scale_shift.1")
    if "to_out" in p:
        _conv(out, p["to_out"], f"{pre}.to_out.conv")


def _attention(out: Dict, p: Mapping, pre: str) -> None:
    _norm(out, p["norm"], f"{pre}.norm")
    _norm(out, p["norm_context"], f"{pre}.norm_context")
    _lin(out, p["to_q"], f"{pre}.to_q")
    _lin(out, p["to_kv"], f"{pre}.to_kv")
    _lin(out, p["to_out"], f"{pre}.attention.to_out")


def _transformer(out: Dict, p: Mapping, pre: str) -> None:
    _norm(out, p["group_norm"], f"{pre}.group_norm")
    _conv(out, p["conv_in"], f"{pre}.conv1d.conv")  # tied in/out conv
    k = 0
    while f"block{k}" in p:
        bp = p[f"block{k}"]
        _attention(out, bp["attention"], f"{pre}.blocks.{k}.attention")
        _lin(out, bp["feed_forward"]["linear1"], f"{pre}.blocks.{k}.feed_forward.0")
        _lin(out, bp["feed_forward"]["linear2"], f"{pre}.blocks.{k}.feed_forward.2")
        if "cross_attention" in bp:
            _attention(out, bp["cross_attention"], f"{pre}.blocks.{k}.cross_attention")
        k += 1


def _time_pos(out: Dict, p: Mapping, pre: str) -> None:
    out[f"{pre}.0.weights"] = _t(p["pos"]["weights"])
    _lin(out, p["linear"], f"{pre}.1")


def export_reference_unet(model_or_params, model_config) -> Dict[str, torch.Tensor]:
    """A port `UNetCFG1d` or its JAX-layout parameter tree (a level that
    holds only "params" is stepped through) -> the reference torch
    state_dict (fp32 CPU tensors)."""
    if isinstance(model_or_params, nn.Module):
        p = flax_tree(model_or_params)
    else:
        p = model_or_params["params"] if "params" in model_or_params else model_or_params
    mc = model_config
    if not mc.tie_transformer_projections:
        raise ValueError("export needs tie_transformer_projections=True (the reference "
                         "model ties each Transformer1d's in/out conv)")
    n = len(mc.multipliers) - 1
    unet = p["unet"]
    out: Dict[str, torch.Tensor] = {}

    _time_pos(out, unet["to_time"], "to_time.0")
    _lin(out, unet["to_mapping_1"], "to_mapping.0")
    _lin(out, unet["to_mapping_2"], "to_mapping.2")
    if "to_features" in unet:
        _lin(out, unet["to_features"], "to_features.0")

    _resnet(out, unet["to_in"]["block"], "to_in.block")
    for i in range(n):
        d = unet[f"downsample{i}"]
        _conv(out, d["downsample"]["conv"], f"downsamples.{i}.downsample.conv")
        for j in range(mc.num_blocks[i]):
            _resnet(out, d[f"block{j}"], f"downsamples.{i}.blocks.{j}")
        if mc.attentions[i]:
            _transformer(out, d["transformer"], f"downsamples.{i}.transformer")

    bott = unet["bottleneck"]
    _resnet(out, bott["pre_block"], "bottleneck.pre_block")
    _resnet(out, bott["post_block"], "bottleneck.post_block")
    if mc.attentions[-1]:
        _transformer(out, bott["transformer"], "bottleneck.transformer")

    for jpos, i in enumerate(reversed(range(n))):
        u = unet[f"upsample{jpos}"]
        for j in range(mc.num_blocks[i] + (1 if mc.attentions[i] else 0)):
            _resnet(out, u[f"block{j}"], f"upsamples.{jpos}.blocks.{j}")
        if mc.attentions[i]:
            _transformer(out, u["transformer"], f"upsamples.{jpos}.transformer")
        up_pre = f"upsamples.{jpos}.upsample"
        if mc.factors[i] == 1:
            _conv(out, u["upsample"], up_pre)
        elif mc.use_nearest_upsample:
            _conv(out, u["upsample"], f"{up_pre}.1")
        else:
            _convtr(out, u["upsample"], up_pre)

    _resnet(out, unet["to_out"]["block"], "to_out.block")

    out["fixed_embedding.embedding.weight"] = _t(p["fixed_embedding"]["embedding"])
    if mc.use_xattn_time:
        _time_pos(out, p["to_time_embedding"], "to_time_embedding.0")
    return out


def save_reference_checkpoint(path: str, model_or_params, model_config, *,
                              epoch: int = 0, learning_rate: float = 0.0) -> None:
    """Write the reference's .pth format: {'model', 'epoch',
    'learning_rate'} (no optimizer state)."""
    torch.save({"model": export_reference_unet(model_or_params, model_config),
                "epoch": epoch, "learning_rate": learning_rate}, path)
