"""Import reference PyTorch UNetCFG1d checkpoints into the port's UNet (port
of jen1_tpu/ckpt/torch_import.py:30-226).

The reference saves `{'model': state_dict, 'epoch', 'optimizer',
'learning_rate'}` with `Jen1_step_*_loss_*.pth` file names.
`convert_reference_unet` maps that state dict onto the JAX package's
parameter tree as numpy arrays, with the same code as the JAX importer;
`ckpt/from_jax.py::load_flax_params` then writes the tree into the port's
modules, which carry the flax names. Together the two transposes give the
reference's layout back:

  torch Linear  (out, in)       -> kernel (in, out)  -> weight (out, in)
  torch Conv1d  (out, in, K)    -> kernel (K, in, out) -> weight (out, in, K)
  torch ConvT1d (in, out, K)    -> kernel (K, in, out) -> weight (in, out, K)
  norm weight/bias              -> scale/bias        -> weight/bias

The model must be built with `tie_transformer_projections=True`: the
reference applies the same 1x1 conv before and after each Transformer1d.
The `_orig_mod.` prefix of torch.compile'd models is stripped. The file is
read with `weights_only=True`: it holds tensors and Python scalars only.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from jen1_tpu_torch.ckpt.checkpoint import load_torch_file, unwrap_state_dict
from jen1_tpu_torch.ckpt.from_jax import load_flax_params


def _arr(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


class _SD:
    """state_dict accessor stripping torch.compile prefixes."""

    def __init__(self, sd: Dict[str, Any]):
        self.sd = {k.replace("_orig_mod.", ""): v for k, v in sd.items()}

    def __contains__(self, k):
        return k in self.sd

    def lin(self, name):
        p = {"kernel": _arr(self.sd[f"{name}.weight"]).T}
        if f"{name}.bias" in self.sd:
            p["bias"] = _arr(self.sd[f"{name}.bias"])
        return p

    def lin_nobias(self, name):
        return {"kernel": _arr(self.sd[f"{name}.weight"]).T}

    def conv(self, name):
        w = _arr(self.sd[f"{name}.weight"]).transpose(2, 1, 0)
        return {"kernel": w, "bias": _arr(self.sd[f"{name}.bias"])}

    def convtr(self, name):
        w = _arr(self.sd[f"{name}.weight"]).transpose(2, 0, 1)
        return {"kernel": w, "bias": _arr(self.sd[f"{name}.bias"])}

    def norm(self, name):
        return {"scale": _arr(self.sd[f"{name}.weight"]), "bias": _arr(self.sd[f"{name}.bias"])}


def _conv_block(sd: _SD, pre: str) -> Dict[str, Any]:
    """reference ConvBlock1d (blocks.py:98-145) -> ours."""
    out: Dict[str, Any] = {}
    if f"{pre}.groupnorm.weight" in sd:
        out["groupnorm"] = sd.norm(f"{pre}.groupnorm")
    if f"{pre}.activation.alpha" in sd:  # Snake1d
        out["snake"] = {
            "alpha": _arr(sd.sd[f"{pre}.activation.alpha"]).reshape(-1)
        }
    out["project"] = sd.conv(f"{pre}.project.conv")
    return out


def _resnet(sd: _SD, pre: str) -> Dict[str, Any]:
    """reference ResnetBlock1d (blocks.py:168-231) -> ours."""
    out = {
        "block1": _conv_block(sd, f"{pre}.block1"),
        "block2": _conv_block(sd, f"{pre}.block2"),
    }
    if f"{pre}.to_scale_shift.to_scale_shift.1.weight" in sd:
        out["to_scale_shift"] = {
            "to_scale_shift": sd.lin(f"{pre}.to_scale_shift.to_scale_shift.1")
        }
    if f"{pre}.to_out.conv.weight" in sd:
        out["to_out"] = sd.conv(f"{pre}.to_out.conv")
    return out


def _attention(sd: _SD, pre: str, cross: bool) -> Dict[str, Any]:
    """reference Attention (blocks.py:383-437) -> ours."""
    out = {
        "norm": sd.norm(f"{pre}.norm"),
        "norm_context": sd.norm(f"{pre}.norm_context"),
        "to_q": sd.lin_nobias(f"{pre}.to_q"),
        "to_kv": sd.lin_nobias(f"{pre}.to_kv"),
        "to_out": sd.lin(f"{pre}.attention.to_out"),
    }
    return out


def _transformer(sd: _SD, pre: str, num_layers: int) -> Dict[str, Any]:
    """reference Transformer1d (blocks.py:497-537) -> ours (tied conv)."""
    out = {
        "group_norm": sd.norm(f"{pre}.group_norm"),
        "conv_in": sd.conv(f"{pre}.conv1d.conv"),  # tied: used in AND out
    }
    for k in range(num_layers):
        bp = f"{pre}.blocks.{k}"
        block = {
            "attention": _attention(sd, f"{bp}.attention", cross=False),
            "feed_forward": {
                "linear1": sd.lin(f"{bp}.feed_forward.0"),
                "linear2": sd.lin(f"{bp}.feed_forward.2"),
            },
        }
        if f"{bp}.cross_attention.norm.weight" in sd:
            block["cross_attention"] = _attention(
                sd, f"{bp}.cross_attention", cross=True
            )
        out[f"block{k}"] = block
    return out


def _time_pos_embedding(sd: _SD, pre: str) -> Dict[str, Any]:
    """reference TimePositionalEmbedding = Sequential(LPE, Linear)."""
    return {
        "pos": {"weights": _arr(sd.sd[f"{pre}.0.weights"])},
        "linear": sd.lin(f"{pre}.1"),
    }


def convert_reference_unet(state_dict: Dict[str, Any], model_config) -> Dict:
    """torch UNetCFG1d state_dict -> the JAX package's parameter tree of
    `unet_from_model_config`, as numpy arrays. model_config: a `ModelConfig`
    with tie_transformer_projections=True."""
    sd = _SD(state_dict)
    mc = model_config
    n = len(mc.multipliers) - 1

    unet: Dict[str, Any] = {}
    # FiLM mapping (reference model.py:75-89; ours unet._get_mapping)
    unet["to_time"] = _time_pos_embedding(sd, "to_time.0")
    unet["to_mapping_1"] = sd.lin("to_mapping.0")
    unet["to_mapping_2"] = sd.lin("to_mapping.2")
    if "to_features.0.weight" in sd:
        unet["to_features"] = sd.lin("to_features.0")

    unet["to_in"] = {"block": _resnet(sd, "to_in.block")}
    for i in range(n):
        d: Dict[str, Any] = {
            "downsample": {"conv": sd.conv(f"downsamples.{i}.downsample.conv")}
        }
        for j in range(mc.num_blocks[i]):
            d[f"block{j}"] = _resnet(sd, f"downsamples.{i}.blocks.{j}")
        if mc.attentions[i]:
            d["transformer"] = _transformer(
                sd, f"downsamples.{i}.transformer", mc.attentions[i]
            )
        unet[f"downsample{i}"] = d

    bott: Dict[str, Any] = {
        "pre_block": _resnet(sd, "bottleneck.pre_block"),
        "post_block": _resnet(sd, "bottleneck.post_block"),
    }
    if mc.attentions[-1]:
        bott["transformer"] = _transformer(
            sd, "bottleneck.transformer", mc.attentions[-1]
        )
    unet["bottleneck"] = bott

    for jpos, i in enumerate(reversed(range(n))):
        u: Dict[str, Any] = {}
        n_layers = mc.num_blocks[i] + (1 if mc.attentions[i] else 0)
        for j in range(n_layers):
            u[f"block{j}"] = _resnet(sd, f"upsamples.{jpos}.blocks.{j}")
        if mc.attentions[i]:
            u["transformer"] = _transformer(
                sd, f"upsamples.{jpos}.transformer", mc.attentions[i]
            )
        up_pre = f"upsamples.{jpos}.upsample"
        if mc.factors[i] == 1:
            u["upsample"] = sd.conv(up_pre)  # bare nn.Conv1d (blocks.py:73)
        elif mc.use_nearest_upsample:
            u["upsample"] = sd.conv(f"{up_pre}.1")  # Sequential(Upsample, Conv)
        else:
            u["upsample"] = sd.convtr(up_pre)  # bare nn.ConvTranspose1d
        unet[f"upsample{jpos}"] = u

    unet["to_out"] = {"block": _resnet(sd, "to_out.block")}

    params: Dict[str, Any] = {"unet": unet}
    params["fixed_embedding"] = {
        "embedding": _arr(sd.sd["fixed_embedding.embedding.weight"])
    }
    if mc.use_xattn_time:
        params["to_time_embedding"] = _time_pos_embedding(sd, "to_time_embedding.0")
    return {"params": params}


def load_reference_checkpoint(path: str, model: torch.nn.Module, model_config):
    """Load a reference .pth file into `model` (a port `UNetCFG1d` built
    from `model_config`); returns (epoch, learning_rate), None where the file
    has none."""
    obj = load_torch_file(path)
    load_flax_params(model, convert_reference_unet(unwrap_state_dict(obj), model_config))
    return obj.get("epoch"), obj.get("learning_rate")
