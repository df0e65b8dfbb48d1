"""Conditioners: metadata -> (embedding [B, L, D], mask [B, L]) (port of
jen1_tpu/conditioning/conditioners.py).

The T5 conditioner and the multi-conditioner dispatch are ported; the int
and number conditioners and loading pretrained T5 weights are not yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from jen1_tpu_torch.conditioning.t5 import T5Encoder, T5EncoderConfig
from jen1_tpu_torch.conditioning.tokenizer import ByteTokenizer, get_tokenizer
from jen1_tpu_torch.ops.initializers import init_module
from jen1_tpu_torch.ops.linear import Linear


class T5Conditioner(nn.Module):
    """Frozen T5 encoder + linear projection, masked positions zeroed."""

    def __init__(
        self,
        output_dim: int,
        t5_model_name: str = "t5-base",
        max_length: int = 128,
        project_out: bool = False,
        *,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if t5_model_name == "tiny-test":
            cfg = T5EncoderConfig.tiny_test()
            self.tokenizer = ByteTokenizer()
        else:
            cfg = T5EncoderConfig.from_name(t5_model_name)
            self.tokenizer = get_tokenizer(t5_model_name)
        if isinstance(self.tokenizer, ByteTokenizer):
            # the byte fallback needs a vocabulary as large as its id range
            cfg.vocab_size = max(cfg.vocab_size, self.tokenizer.vocab_size)
        self.max_length = max_length
        self.output_dim = output_dim
        with torch.device(device):
            self.encoder = T5Encoder(cfg)
            use_proj = cfg.d_model != output_dim or project_out
            self.proj = Linear(cfg.d_model, output_dim) if use_proj else None
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        init_module(self, generator)
        self.device = torch.device(device)

    @torch.no_grad()
    def forward(self, texts: List[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        ids, mask = self.tokenizer(texts, self.max_length)
        ids = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        mask = torch.as_tensor(mask, device=self.device)
        emb = self.encoder(ids, mask)
        if self.proj is not None:
            emb = self.proj(emb)
        return emb * mask[..., None].to(emb.dtype), mask


class MultiConditioner:
    """Dispatch metadata dicts to conditioners by key."""

    def __init__(self, conditioners: Dict[str, Any],
                 default_keys: Optional[Dict[str, str]] = None):
        self.conditioners = conditioners
        self.default_keys = default_keys or {}

    def __call__(self, batch_metadata: List[Dict[str, Any]]):
        output = {}
        for key, conditioner in self.conditioners.items():
            inputs = []
            for x in batch_metadata:
                condition_key = key
                if condition_key not in x and condition_key in self.default_keys:
                    condition_key = self.default_keys[condition_key]
                if condition_key not in x:
                    raise ValueError(f"Conditioner key {condition_key} not found in metadata")
                value = x[condition_key]
                if isinstance(value, (list, tuple)) and len(value) == 1:
                    value = value[0]
                inputs.append(value)
            output[key] = conditioner(inputs)
        return output


def create_multi_conditioner(config, *, device="cuda",
                             generator: Optional[torch.Generator] = None) -> MultiConditioner:
    """Build the configured conditioners (a `ConditionerConfig`)."""
    conditioners = {}
    for ctype in config.conditioning_type:
        if ctype != "t5":
            raise NotImplementedError(
                f"conditioner type {ctype!r} is not ported yet "
                "(ROADMAP Queue 1, 'Remaining model, conditioning and eval features')")
        c = config.t5_config
        conditioners[c.id] = T5Conditioner(
            output_dim=config.cond_dim,
            t5_model_name=c.t5_model_name,
            max_length=c.max_length,
            project_out=c.project_out,
            device=device,
            generator=generator,
        )
    return MultiConditioner(conditioners, default_keys=config.default_keys)


def assemble_conditioning(
    cond: Dict[str, Any],
    *,
    cross_attn_cond_ids: Sequence[str] = ("prompt",),
    global_cond_ids: Sequence[str] = (),
    input_concat_ids: Sequence[str] = ("masked_input", "mask"),
) -> Dict[str, Any]:
    """Regroup conditioner outputs into the model's conditioning dict.
    Entries named in `input_concat_ids` are raw (B, L, C) tensors; the rest
    are (embedding, mask) pairs."""
    out = {
        "cross_attn_cond": None,
        "cross_attn_masks": None,
        "global_cond": None,
        "input_concat_cond": None,
    }
    if cross_attn_cond_ids:
        out["cross_attn_cond"] = torch.cat([cond[k][0] for k in cross_attn_cond_ids], dim=1)
        out["cross_attn_masks"] = torch.cat([cond[k][1] for k in cross_attn_cond_ids], dim=1)
    if global_cond_ids:
        g = torch.cat([cond[k][0] for k in global_cond_ids], dim=-1)
        out["global_cond"] = g.squeeze(1) if g.dim() == 3 else g
    if input_concat_ids:
        out["input_concat_cond"] = torch.cat([cond[k] for k in input_concat_ids], dim=-1)
    return out
