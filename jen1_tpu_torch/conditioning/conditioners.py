"""Conditioners: metadata -> (embedding [B, L, D], mask [B, L]) (port of
jen1_tpu/conditioning/conditioners.py).

The T5 conditioner (pretrained weights from a local HF state dict,
`weights_path`), the int conditioner (a learned table over a clamped
range), the number conditioner (Fourier features of a clamped, normalised
value) and the multi-conditioner dispatch. Prompt-only metadata fills a
missing int or number key with the conditioner's `min_val`, as in the JAX
package. Every weight comes from a `torch.Generator` or, through
`ckpt/from_jax.py`, from a JAX tree.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from jen1_tpu_torch.ckpt.checkpoint import load_torch_file
from jen1_tpu_torch.conditioning.t5 import T5Encoder, T5EncoderConfig, convert_hf_t5_encoder
from jen1_tpu_torch.conditioning.tokenizer import ByteTokenizer, get_tokenizer
from jen1_tpu_torch.ops.embeddings import NumberEmbedder
from jen1_tpu_torch.ops.initializers import init_module, normal_
from jen1_tpu_torch.ops.linear import Linear


class T5Conditioner(nn.Module):
    """Frozen T5 encoder + linear projection, masked positions zeroed."""

    def __init__(
        self,
        output_dim: int,
        t5_model_name: str = "t5-base",
        max_length: int = 128,
        project_out: bool = False,
        weights_path: Optional[str] = None,
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
        if weights_path is not None:
            self._load_encoder(load_torch_file(weights_path, unwrap=True), cfg)
        self.device = torch.device(device)

    @torch.no_grad()
    def _load_encoder(self, state_dict, cfg: T5EncoderConfig) -> None:
        """The encoder's weights from an HF state dict; the embedding takes
        the checkpoint's vocabulary size, as the JAX conditioner's does."""
        sd = convert_hf_t5_encoder(state_dict, cfg)
        emb = sd["embedding"]
        if emb.shape != self.encoder.embedding.shape:
            self.encoder.embedding = nn.Parameter(
                torch.empty(emb.shape, device=self.encoder.embedding.device))
        self.encoder.load_state_dict(sd)

    @torch.no_grad()
    def forward(self, texts: List[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        ids, mask = self.tokenizer(texts, self.max_length)
        ids = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        mask = torch.as_tensor(mask, device=self.device)
        emb = self.encoder(ids, mask)
        if self.proj is not None:
            emb = self.proj(emb)
        return emb * mask[..., None].to(emb.dtype), mask


class IntConditioner(nn.Module):
    """A learned (max - min + 1, D) table indexed by the clamped int
    (jen1_tpu/conditioning/conditioners.py:129-149); parameter `embedding`."""

    def __init__(self, output_dim: int, min_val: int = 0, max_val: int = 512, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.output_dim = output_dim
        self.min_val, self.max_val = int(min_val), int(max_val)
        self.device = torch.device(device)
        self.embedding = nn.Parameter(torch.empty(
            (self.max_val - self.min_val + 1, output_dim), device=self.device))
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        init_module(self, generator)

    def init_parameters(self, generator):
        normal_(self.embedding, generator)

    @torch.no_grad()
    def forward(self, ints: List[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        idx = torch.as_tensor([int(v) for v in ints], dtype=torch.long, device=self.device)
        emb = self.embedding[idx.clamp(self.min_val, self.max_val) - self.min_val][:, None, :]
        return emb, torch.ones((emb.shape[0], 1), dtype=torch.float32, device=self.device)


class NumberConditioner(nn.Module):
    """Fourier features of the value clamped to [min, max] and normalised
    to [0, 1] (jen1_tpu/conditioning/conditioners.py:152-174); submodule
    `embedder` holds the JAX NumberEmbedder's parameters."""

    def __init__(self, output_dim: int, min_val: float = 0, max_val: float = 1, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.output_dim = output_dim
        self.min_val, self.max_val = float(min_val), float(max_val)
        self.device = torch.device(device)
        with torch.device(self.device):
            self.embedder = NumberEmbedder(output_dim)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        init_module(self, generator)

    @torch.no_grad()
    def forward(self, floats: List[float]) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.as_tensor([float(v) for v in floats], dtype=torch.float32,
                            device=self.device).clamp(self.min_val, self.max_val)
        x = (x - self.min_val) / (self.max_val - self.min_val)
        emb = self.embedder(x)[:, None, :]
        return emb, torch.ones((emb.shape[0], 1), dtype=torch.float32, device=self.device)


class MultiConditioner:
    """Dispatch metadata dicts to conditioners by key. A key missing from a
    metadata dict is looked up under its `default_keys` alias, then taken
    from `fill_values`, else raises ValueError."""

    def __init__(self, conditioners: Dict[str, Any],
                 default_keys: Optional[Dict[str, str]] = None,
                 fill_values: Optional[Dict[str, Any]] = None):
        self.conditioners = conditioners
        self.default_keys = default_keys or {}
        self.fill_values = fill_values or {}

    def __call__(self, batch_metadata: List[Dict[str, Any]]):
        output = {}
        for key, conditioner in self.conditioners.items():
            inputs = []
            for x in batch_metadata:
                condition_key = key
                if condition_key not in x and condition_key in self.default_keys:
                    condition_key = self.default_keys[condition_key]
                if condition_key in x:
                    value = x[condition_key]
                elif key in self.fill_values:
                    value = self.fill_values[key]
                else:
                    raise ValueError(f"Conditioner key {condition_key} not found in metadata"
                                     f" and no fill value configured")
                if isinstance(value, (list, tuple)) and len(value) == 1:
                    value = value[0]
                inputs.append(value)
            output[key] = conditioner(inputs)
        return output


def create_multi_conditioner(config, *, device="cuda",
                             generator: Optional[torch.Generator] = None) -> MultiConditioner:
    """Build every configured conditioner (a `ConditionerConfig`), in
    `conditioning_type` order, all drawing from `generator`; int and number
    keys fill with their `min_val` (jen1_tpu/conditioning/conditioners.py:
    213-250)."""
    conditioners: Dict[str, Any] = {}
    fill_values: Dict[str, Any] = {}
    for ctype in config.conditioning_type:
        if ctype == "t5":
            c = config.t5_config
            conditioners[c.id] = T5Conditioner(
                output_dim=config.cond_dim,
                t5_model_name=c.t5_model_name,
                max_length=c.max_length,
                project_out=c.project_out,
                weights_path=c.weights_path,
                device=device,
                generator=generator,
            )
        elif ctype in ("int", "number"):
            c = config.int_config if ctype == "int" else config.number_config
            cls = IntConditioner if ctype == "int" else NumberConditioner
            conditioners[c.id] = cls(config.cond_dim, c.min_val, c.max_val, device=device,
                                     generator=generator)
            fill_values[c.id] = c.min_val
        else:
            raise NotImplementedError(f"Invalid conditioner type: {ctype}")
    return MultiConditioner(conditioners, default_keys=config.default_keys,
                            fill_values=fill_values)


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
