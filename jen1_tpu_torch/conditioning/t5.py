"""T5 text encoder, FLAN-T5 family (port of jen1_tpu/conditioning/t5.py).

Encoder only, inference mode: RMSNorm with fp32 statistics, bidirectional
relative-position buckets whose bias is computed in block 0 and reused by
every later block, no 1/sqrt(d_kv) query scaling, and a gated-GELU (tanh)
or ReLU FFN. Bias-free projections are initialised normal(1.0), as in the
JAX package. `convert_hf_t5_encoder` maps a local HuggingFace
`T5EncoderModel` state dict onto `T5Encoder`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from jen1_tpu_torch.ops.initializers import normal_


@dataclasses.dataclass
class T5EncoderConfig:
    vocab_size: int = 32128
    d_model: int = 1024
    d_kv: int = 64
    num_heads: int = 16
    d_ff: int = 2816
    num_layers: int = 24
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "gated-gelu"  # 'relu' for original T5

    @classmethod
    def flan_t5_large(cls) -> "T5EncoderConfig":
        return cls()

    @classmethod
    def tiny_test(cls) -> "T5EncoderConfig":
        return cls(vocab_size=64, d_model=32, d_kv=8, num_heads=4, d_ff=48, num_layers=2)

    @classmethod
    def from_name(cls, name: str) -> "T5EncoderConfig":
        table = {
            "google/flan-t5-small": cls(d_model=512, d_kv=64, num_heads=6, d_ff=1024, num_layers=8),
            "google/flan-t5-base": cls(d_model=768, num_heads=12, d_ff=2048, num_layers=12),
            "google/flan-t5-large": cls.flan_t5_large(),
            "google/flan-t5-xl": cls(d_model=2048, num_heads=32, d_ff=5120, num_layers=24),
            "t5-small": cls(d_model=512, d_kv=64, num_heads=8, d_ff=2048, num_layers=6, feed_forward_proj="relu"),
            "t5-base": cls(d_model=768, num_heads=12, d_ff=3072, num_layers=12, feed_forward_proj="relu"),
            "t5-large": cls(d_model=1024, num_heads=16, d_ff=4096, num_layers=24, feed_forward_proj="relu"),
        }
        if name not in table:
            raise KeyError(f"unknown T5 model name: {name}")
        return table[name]


class RMSNorm(nn.Module):
    """T5LayerNorm: no mean subtraction, no bias; fp32 statistics."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels))

    def init_parameters(self, generator):
        nn.init.ones_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(x.dtype)


def _relative_position_bucket(relative_position: np.ndarray, num_buckets: int,
                              max_distance: int) -> np.ndarray:
    """Bidirectional T5 relative-position bucketing (static numpy)."""
    ret = np.zeros_like(relative_position)
    n = num_buckets // 2
    ret += (relative_position > 0).astype(np.int64) * n
    rp = np.abs(relative_position)
    max_exact = n // 2
    is_small = rp < max_exact
    val_if_large = max_exact + (
        np.log(np.maximum(rp, 1) / max_exact)
        / np.log(max_distance / max_exact)
        * (n - max_exact)
    ).astype(np.int64)
    val_if_large = np.minimum(val_if_large, n - 1)
    return ret + np.where(is_small, rp, val_if_large)


def relative_position_bias_index(q_len: int, k_len: int, num_buckets: int,
                                 max_distance: int) -> np.ndarray:
    ctx = np.arange(q_len)[:, None]
    mem = np.arange(k_len)[None, :]
    return _relative_position_bucket(mem - ctx, num_buckets, max_distance)


class _Dense(nn.Module):
    """Bias-free projection; weight (out, in), init normal(1.0)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))

    def init_parameters(self, generator):
        normal_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype))


class T5SelfAttention(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, has_relative_bias: bool):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = _Dense(cfg.d_model, inner)
        self.k = _Dense(cfg.d_model, inner)
        self.v = _Dense(cfg.d_model, inner)
        self.o = _Dense(inner, cfg.d_model)
        self.relative_attention_bias = (
            nn.Parameter(torch.empty(cfg.relative_attention_num_buckets, cfg.num_heads))
            if has_relative_bias
            else None
        )

    def init_parameters(self, generator):
        if self.relative_attention_bias is not None:
            normal_(self.relative_attention_bias, generator)

    def forward(self, x, attention_mask, position_bias: Optional[torch.Tensor]):
        cfg = self.cfg
        b, length, _ = x.shape

        def heads(a):
            return a.reshape(b, length, cfg.num_heads, cfg.d_kv).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        if position_bias is None:
            if self.relative_attention_bias is not None:
                idx = relative_position_bias_index(
                    length, length, cfg.relative_attention_num_buckets,
                    cfg.relative_attention_max_distance,
                )
                idx = torch.as_tensor(idx, device=x.device)
                position_bias = self.relative_attention_bias[idx].permute(2, 0, 1)[None].float()
            else:
                position_bias = torch.zeros((1, cfg.num_heads, length, length),
                                            device=x.device)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))  # no q scaling
        mask_bias = torch.where(
            attention_mask[:, None, None, :], 0.0, torch.finfo(torch.float32).min
        )
        probs = torch.softmax(scores + position_bias + mask_bias, dim=-1).to(x.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, length, -1)
        return self.o(out), position_bias


class T5FFN(nn.Module):
    def __init__(self, cfg: T5EncoderConfig):
        super().__init__()
        self.gated = cfg.feed_forward_proj == "gated-gelu"
        if self.gated:
            self.wi_0 = _Dense(cfg.d_model, cfg.d_ff)
            self.wi_1 = _Dense(cfg.d_model, cfg.d_ff)
        else:
            self.wi = _Dense(cfg.d_model, cfg.d_ff)
        self.wo = _Dense(cfg.d_ff, cfg.d_model)

    def forward(self, x):
        if self.gated:
            h = F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x)
        else:
            h = F.relu(self.wi(x))
        return self.wo(h)


class T5Block(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, has_relative_bias: bool):
        super().__init__()
        self.ln_attn = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.attn = T5SelfAttention(cfg, has_relative_bias)
        self.ln_ffn = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.ffn = T5FFN(cfg)

    def forward(self, x, attention_mask, position_bias):
        attn_out, position_bias = self.attn(self.ln_attn(x), attention_mask, position_bias)
        x = x + attn_out
        return x + self.ffn(self.ln_ffn(x)), position_bias


class T5Encoder(nn.Module):
    """input_ids (B, L) int, attention_mask (B, L) bool -> (B, L, d_model)."""

    def __init__(self, cfg: T5EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model))
        for i in range(cfg.num_layers):
            self.add_module(f"block{i}", T5Block(cfg, has_relative_bias=(i == 0)))
        self.final_ln = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def init_parameters(self, generator):
        normal_(self.embedding, generator)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        x = self.embedding[input_ids]
        position_bias = None
        for i in range(self.cfg.num_layers):
            x, position_bias = getattr(self, f"block{i}")(x, attention_mask, position_bias)
        return self.final_ln(x)


def convert_hf_t5_encoder(state_dict: Dict[str, Any],
                          cfg: T5EncoderConfig) -> Dict[str, torch.Tensor]:
    """An HF torch `T5EncoderModel.state_dict()` (`shared.weight` or
    `encoder.embed_tokens.weight`, `encoder.block.{i}.layer.{0,1}...`) as a
    state dict of `T5Encoder` (jen1_tpu/conditioning/t5.py:263-316). Both
    packages keep torch's (out, in) projection layout, so no leaf is
    transposed; keys the encoder does not read are ignored."""

    def get(*names) -> torch.Tensor:
        for n in names:
            if n in state_dict:
                return torch.as_tensor(state_dict[n]).float()
        raise KeyError(f"none of {names} in state dict")

    out = {"embedding": get("shared.weight", "encoder.embed_tokens.weight")}
    ffn = ("wi_0", "wi_1", "wo") if cfg.feed_forward_proj == "gated-gelu" else ("wi", "wo")
    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}.layer"
        for name in ("q", "k", "v", "o"):
            out[f"block{i}.attn.{name}.weight"] = get(f"{pre}.0.SelfAttention.{name}.weight")
        if i == 0:
            out["block0.attn.relative_attention_bias"] = get(
                f"{pre}.0.SelfAttention.relative_attention_bias.weight")
        for name in ffn:
            out[f"block{i}.ffn.{name}.weight"] = get(f"{pre}.1.DenseReluDense.{name}.weight")
        out[f"block{i}.ln_attn.weight"] = get(f"{pre}.0.layer_norm.weight")
        out[f"block{i}.ln_ffn.weight"] = get(f"{pre}.1.layer_norm.weight")
    out["final_ln.weight"] = get("encoder.final_layer_norm.weight")
    return out
