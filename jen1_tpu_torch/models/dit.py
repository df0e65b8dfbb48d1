"""Stable Audio Open's diffusion transformer with classifier-free guidance
(stable-audio-tools `models/dit.py::DiffusionTransformer` over
`models/transformer.py::ContinuousTransformer`, `global_cond_type`
"prepend"), channels-last: x (B, L, io_channels).

One forward (`_forward`):
  * the time t in [0, 1] as Fourier features [cos 2 pi t W, sin 2 pi t W],
    then Linear, SiLU, Linear (with biases); the global condition through
    Linear, SiLU, Linear (no biases), added to it: one token, prepended at
    position 0, so the sequence is L + 1 long;
  * the cross-attention tokens through Linear, SiLU, Linear (no biases),
    never masked (the published model turns the context mask off; a padded
    T5 position is a zero vector, whose key and value are zero);
  * x + preprocess(x) (a bias-free 1x1 conv), then project_in;
  * `depth` pre-norm blocks (bias-free LayerNorm, eps 1e-5): self-attention
    with rotary on the first max(head_dim / 2, 32) dims of each head, in
    fp32 (positions 0..L, the global token at 0); cross-attention whose kv
    heads, of the same head width over the context's width, each serve
    num_heads / kv_heads query heads (repeat_interleave); a GLU
    feed-forward x * SiLU(gate);
  * project_out, the prepended token dropped, plus the bias-free 1x1
    postprocess.

Precision: the projections, attention and feed-forward of each block run
in the compute dtype (x's: bf16 over fp32 weights, as in JEN-1); the
residual stream, the time and global token, the output head and the
guidance mix stay in fp32, as torch.autocast would keep them over fp32
weights. Guidance at scale 7 multiplies what the two branches' outputs
differ by, rounding included: a bf16 residual stream read several times
further from the fp32 reference (2-4x at test widths).

Self-attention goes to `ops/flash_attention.flash_attention` wherever
`flash_attention_supported` holds, from 128 tokens on (K1 on the card: the
tensor-core route in bf16, at head dim 64 for the published widths);
shorter self-attention, and all cross-attention, to the plain fp32-logits
path. `COUNTERS` count the
forwards and each self-attention's route; under a CUDA graph
utils/cuda_graphs.py adds them at every replay. Each block's parts are the
spans `dit.self_attn`, `dit.cross_attn` and `dit.ff` (utils/profiling.py),
which inside a captured graph run only at capture.

The published model's fixed choices are constants here: the context keeps
its own width (`project_cond_tokens` false), 256 Fourier time features, a
GLU of 4 x embed_dim, rotary base 10000.

Guidance (`forward`) follows the published model: the unconditional rows
get zeros for the cross-attention tokens and keep the time and global
token; out = u + scale (c - u), batched (one doubled forward) or as two
forwards, with the port's std-matching rescale under `scale_cfg`. CFG
dropout in training zeroes the tokens of the rows whose bit is set.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from jen1_tpu_torch.ops.attention import dot_product_attention
from jen1_tpu_torch.ops.embeddings import rand_bool
from jen1_tpu_torch.ops.flash_attention import flash_attention, flash_attention_supported
from jen1_tpu_torch.ops.initializers import normal_
from jen1_tpu_torch.ops.linear import Linear
from jen1_tpu_torch.ops.norm import LayerNorm
from jen1_tpu_torch.ops.rotary import apply_rotary, rotary_tables
from jen1_tpu_torch.utils.profiling import annotate

# Passes through the block stack (one per sampler step under batch CFG) and
# self-attention calls by route; incremented here only, and under a CUDA
# graph by utils/cuda_graphs.py at every replay.
COUNTERS = ("FORWARDS", "SELF_ATTN_FLASH", "SELF_ATTN_PLAIN")
FORWARDS = 0
SELF_ATTN_FLASH = 0
SELF_ATTN_PLAIN = 0

TIMESTEP_FEATURES = 256
FF_MULT = 4
ROTARY_BASE = 10_000.0


class FourierFeatures(nn.Module):
    """t (B,) -> [cos 2 pi t W, sin 2 pi t W] (B, features) in fp32; the
    weight (features / 2, 1)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features // 2, 1))

    def init_parameters(self, generator):
        normal_(self.weight, generator)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        f = 2 * math.pi * t.float()[:, None] * self.weight.float()[:, 0][None, :]
        return torch.cat([f.cos(), f.sin()], dim=-1)


def _mlp(fin: int, fout: int, bias: bool) -> nn.Sequential:
    """Linear, SiLU, Linear: the embedding heads (indices 0 and 2, as
    published)."""
    return nn.Sequential(Linear(fin, fout, use_bias=bias), nn.SiLU(),
                         Linear(fout, fout, use_bias=bias))


class SelfAttention(nn.Module):
    def __init__(self, dim: int, head_dim: int):
        super().__init__()
        self.heads, self.head_dim = dim // head_dim, head_dim
        self.to_qkv = Linear(dim, 3 * dim, use_bias=False)
        self.to_out = Linear(dim, dim, use_bias=False)

    def forward(self, x: torch.Tensor, rotary) -> torch.Tensor:
        global SELF_ATTN_FLASH, SELF_ATTN_PLAIN
        b, n, c = x.shape
        d = self.head_dim
        q, k, v = self.to_qkv(x).reshape(b, n, 3, self.heads, d).permute(2, 0, 3, 1, 4).unbind(0)
        q, k = apply_rotary(q, *rotary), apply_rotary(k, *rotary)
        if flash_attention_supported(n, d):
            SELF_ATTN_FLASH += 1
            out = flash_attention(q, k, v.contiguous())
        else:
            SELF_ATTN_PLAIN += 1
            out = dot_product_attention(q, k, v)
        return self.to_out(out.transpose(1, 2).reshape(b, n, c))


class CrossAttention(nn.Module):
    """Queries of `dim`, keys and values of `context_dim` in heads of
    head_dim, each kv head repeated over heads / kv_heads query heads."""

    def __init__(self, dim: int, context_dim: int, head_dim: int):
        super().__init__()
        self.heads, self.kv_heads, self.head_dim = dim // head_dim, context_dim // head_dim, head_dim
        self.to_q = Linear(dim, dim, use_bias=False)
        self.to_kv = Linear(context_dim, 2 * context_dim, use_bias=False)
        self.to_out = Linear(dim, dim, use_bias=False)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        d, rep = self.head_dim, self.heads // self.kv_heads
        q = self.to_q(x).reshape(b, n, self.heads, d).transpose(1, 2)
        k, v = self.to_kv(context).reshape(b, -1, 2, self.kv_heads, d).permute(2, 0, 3, 1, 4).unbind(0)
        out = dot_product_attention(q, k.repeat_interleave(rep, dim=1),
                                    v.repeat_interleave(rep, dim=1))
        return self.to_out(out.transpose(1, 2).reshape(b, n, c))


class FeedForward(nn.Module):
    """GLU: proj to 2 x inner (with bias), x * SiLU(gate), out (with bias)."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, 2 * inner)
        self.out = Linear(inner, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.proj(x).chunk(2, dim=-1)
        return self.out(a * F.silu(gate))


class DiTBlock(nn.Module):
    def __init__(self, dim: int, head_dim: int, context_dim: int, ff_inner: int):
        super().__init__()
        self.pre_norm = LayerNorm(dim, use_bias=False)
        self.self_attn = SelfAttention(dim, head_dim)
        self.cross_attend_norm = LayerNorm(dim, use_bias=False)
        self.cross_attn = CrossAttention(dim, context_dim, head_dim)
        self.ff_norm = LayerNorm(dim, use_bias=False)
        self.ff = FeedForward(dim, ff_inner)

    def forward(self, x, context, rotary, dtype):
        """x: the fp32 residual stream; each branch in `dtype`."""
        with annotate("dit.self_attn"):
            x = x + self.self_attn(self.pre_norm(x).to(dtype), rotary)
        with annotate("dit.cross_attn"):
            x = x + self.cross_attn(self.cross_attend_norm(x).to(dtype), context)
        with annotate("dit.ff"):
            x = x + self.ff(self.ff_norm(x).to(dtype))
        return x


class DiffusionTransformer(nn.Module):
    """The DiT of a `config.DiTConfig` (module docstring)."""

    def __init__(self, dc):
        super().__init__()
        dim, io, context_dim = dc.embed_dim, dc.io_channels, dc.cond_token_dim
        head_dim = dim // dc.num_heads
        self.rotary_dim = max(head_dim // 2, 32)
        self.timestep_features = FourierFeatures(TIMESTEP_FEATURES)
        self.to_timestep_embed = _mlp(TIMESTEP_FEATURES, dim, bias=True)
        self.to_cond_embed = _mlp(context_dim, context_dim, bias=False)
        self.to_global_embed = _mlp(dc.global_cond_dim, dim, bias=False)
        self.preprocess_conv = Linear(io, io, use_bias=False)
        self.project_in = Linear(io, dim, use_bias=False)
        self.layers = nn.ModuleList(
            DiTBlock(dim, head_dim, context_dim, FF_MULT * dim)
            for _ in range(dc.depth))
        self.project_out = Linear(dim, io, use_bias=False)
        self.postprocess_conv = Linear(io, io, use_bias=False)

    def _forward(self, x: torch.Tensor, time: torch.Tensor, context: torch.Tensor,
                 global_cond: Optional[torch.Tensor]) -> torch.Tensor:
        """x (B, L, io) in the compute dtype, time (B,), context (B, M,
        cond_token_dim), global_cond (B, global_cond_dim) or None -> (B, L,
        io) fp32 (module docstring, "Precision")."""
        global FORWARDS
        FORWARDS += 1
        dtype = x.dtype
        context = self.to_cond_embed(context.to(dtype))
        token = self.to_timestep_embed(self.timestep_features(time))
        if global_cond is not None:
            token = token + self.to_global_embed(global_cond.float())
        x = x + self.preprocess_conv(x)
        h = torch.cat([token[:, None], self.project_in(x).float()], dim=1)
        rotary = rotary_tables(h.shape[1], self.rotary_dim, ROTARY_BASE, h.device)
        for layer in self.layers:
            h = layer(h, context, rotary, dtype)
        h = self.project_out(h)[:, 1:]
        return h + self.postprocess_conv(h)

    def forward(
        self,
        x: torch.Tensor,  # (B, L, io_channels)
        time: torch.Tensor,  # (B,)
        *,
        embedding: torch.Tensor,  # (B, M, cond_token_dim)
        embedding_mask: Optional[torch.Tensor] = None,  # (B, M): not applied
        embedding_scale: float = 1.0,
        embedding_mask_proba: float = 0.0,
        batch_cfg: bool = False,
        scale_cfg: bool = False,
        scale_phi: float = 0.7,
        features: Optional[torch.Tensor] = None,  # (B, global_cond_dim)
        channels_list: Optional[Sequence[torch.Tensor]] = None,
        causal: bool = False,
        generator: Optional[torch.Generator] = None,
        embedding_mask_bits: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """The guided prediction (module docstring); the keywords are the
        UNet's (models/unet.py::UNetCFG1d.forward), which the samplers pass.
        The DiT has no causal form and no input-concat conditioning."""
        if causal or channels_list:
            raise ValueError("the DiT takes no causal mask and no input-concat conditioning")
        if embedding_mask_proba > 0.0:
            bits = embedding_mask_bits
            if bits is None:
                bits = rand_bool(generator, (x.shape[0], 1, 1), embedding_mask_proba,
                                 embedding.device)
            embedding = torch.where(bits.to(embedding.device), 0.0, embedding)
        if embedding_scale == 1.0:
            return self._forward(x, time, embedding, features)
        null = torch.zeros_like(embedding)
        if batch_cfg:
            def twice(a):
                return None if a is None else torch.cat([a, a], dim=0)

            out, out_null = self._forward(twice(x), twice(time), torch.cat([embedding, null]),
                                          twice(features)).chunk(2, dim=0)
        else:
            out = self._forward(x, time, embedding, features)
            out_null = self._forward(x, time, null, features)
        out_cfg = out_null + (out - out_null) * embedding_scale
        if scale_cfg:
            # std over channels with Bessel's correction, as the UNet's
            out_std = out.std(dim=-1, keepdim=True, correction=1)
            cfg_std = out_cfg.std(dim=-1, keepdim=True, correction=1)
            out_cfg = scale_phi * (out_cfg * (out_std / cfg_std)) + (1.0 - scale_phi) * out_cfg
        return out_cfg

