"""Plain fp32 Stable Audio Open 1.0: the T5-base text encoder, the two
number conditioners, the DiT with classifier-free guidance, the VDM
v-sampler and the Oobleck VAE decoder, in plain PyTorch.

Written from stable-audio-tools (`models/dit.py`, `models/transformer.py`,
`models/autoencoders.py`, `models/conditioners.py`, `models/blocks.py`)
in its own layout, (B, C, T), with the parameter names of
`jen1_tpu_torch`'s modules, so that one set of seeded weights loads into
both by name. Everything runs in fp32 with TF32 off (`fp32()`), one
unbatched forward per guidance branch, with no kernel, cache or graph.
Nothing here imports the port, JAX or any other file of this repository.

Departures from the published code, each noted at its line: the 1x1
pre/postprocess convs hold (C, C) weights; weight norm is folded into
plain weights; the text is tokenized as UTF-8 bytes (no tokenizer files);
the sampler is the deterministic v-space one on the trigonometric schedule
(the published default is DPM-Solver++(3M) SDE).

`lower_precision()` rounds the operands of every matrix product and
convolution to float8 e4m3 with a per-tensor scale, the precision below
the configuration's bf16 compute: the control that the comparison has to
fail.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_ROUND = {"fn": None}


@contextlib.contextmanager
def fp32():
    """fp32 products in full fp32: TF32 off for matmuls and cuDNN."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


@contextlib.contextmanager
def lower_precision():
    """Operands of every product rounded to float8 e4m3 (the control)."""
    _ROUND["fn"] = _fp8
    try:
        yield
    finally:
        _ROUND["fn"] = None


def _r(t: torch.Tensor) -> torch.Tensor:
    fn = _ROUND["fn"]
    return t if fn is None else fn(t)


def linear(x, w, b=None):
    return F.linear(_r(x), _r(w), b)


def matmul(a, b):
    return torch.matmul(_r(a), _r(b))


class _Linear(nn.Module):
    def __init__(self, fin, fout, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(fout, fin))
        self.bias = nn.Parameter(torch.empty(fout)) if bias else None

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class _W(nn.Module):
    def __init__(self, *shape):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*shape))


# ----------------------------------------------------------------- T5

T5_WIDTHS = {
    "t5-base": dict(vocab_size=32128, d_model=768, d_kv=64, num_heads=12, d_ff=3072,
                    num_layers=12, ffn="relu"),
    "tiny-test": dict(vocab_size=64, d_model=32, d_kv=8, num_heads=4, d_ff=48, num_layers=2,
                      ffn="gated-gelu"),
}
BYTE_VOCAB = 259  # ids 3..258 for UTF-8 bytes, 0 pad, 1 eos


def byte_tokens(texts: List[str], max_length: int):
    """UTF-8 bytes + 3, then eos (1), padded with 0: (ids, mask). The
    published conditioner runs T5's SentencePiece tokenizer."""
    ids = torch.zeros((len(texts), max_length), dtype=torch.long)
    mask = torch.zeros((len(texts), max_length), dtype=torch.bool)
    for i, text in enumerate(texts):
        seq = [b + 3 for b in text.encode("utf-8")[: max_length - 1]] + [1]
        ids[i, : len(seq)] = torch.tensor(seq)
        mask[i, : len(seq)] = True
    return ids, mask


def _t5_bucket(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    n = num_buckets // 2
    ret = (rel > 0).long() * n
    rp = rel.abs()
    max_exact = n // 2
    large = max_exact + (torch.log(rp.clamp_min(1).double() / max_exact)
                         / math.log(max_distance / max_exact) * (n - max_exact)).long()
    large = large.clamp_max(n - 1)
    return ret + torch.where(rp < max_exact, rp, large)


class _T5Attn(nn.Module):
    def __init__(self, w, rel_bias):
        super().__init__()
        inner = w["num_heads"] * w["d_kv"]
        self.q, self.k, self.v = (_W(inner, w["d_model"]) for _ in range(3))
        self.o = _W(w["d_model"], inner)
        self.relative_attention_bias = (nn.Parameter(torch.empty(32, w["num_heads"]))
                                        if rel_bias else None)


class _T5FFN(nn.Module):
    def __init__(self, w):
        super().__init__()
        if w["ffn"] == "relu":
            self.wi = _W(w["d_ff"], w["d_model"])
        else:
            self.wi_0, self.wi_1 = _W(w["d_ff"], w["d_model"]), _W(w["d_ff"], w["d_model"])
        self.wo = _W(w["d_model"], w["d_ff"])


class _T5Block(nn.Module):
    def __init__(self, w, rel_bias):
        super().__init__()
        self.ln_attn, self.ln_ffn = _W(w["d_model"]), _W(w["d_model"])
        self.attn = _T5Attn(w, rel_bias)
        self.ffn = _T5FFN(w)


def _rms(x, weight):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) * weight


class T5Encoder(nn.Module):
    """T5 encoder: RMSNorm, bucketed relative position bias from block 0
    shared by every block, no 1/sqrt(d) query scaling, a ReLU FFN (t5-base)
    or a gated-GELU one (the tiny test encoder)."""

    def __init__(self, w):
        super().__init__()
        self.w = w
        self.embedding = nn.Parameter(torch.empty(max(w["vocab_size"], BYTE_VOCAB), w["d_model"]))
        for i in range(w["num_layers"]):
            self.add_module(f"block{i}", _T5Block(w, i == 0))
        self.final_ln = _W(w["d_model"])

    def forward(self, ids, mask):
        w = self.w
        b, length = ids.shape
        x = self.embedding[ids]
        pos = torch.arange(length, device=ids.device)
        bucket = _t5_bucket(pos[None, :] - pos[:, None], 32, 128)
        bias = self.block0.attn.relative_attention_bias[bucket].permute(2, 0, 1)[None]
        bias = bias + torch.where(mask[:, None, None, :], 0.0, torch.finfo(torch.float32).min)
        for i in range(w["num_layers"]):
            blk = getattr(self, f"block{i}")
            h = _rms(x, blk.ln_attn.weight)
            a = blk.attn

            def heads(t):
                return t.reshape(b, length, w["num_heads"], w["d_kv"]).transpose(1, 2)

            q, k, v = (heads(linear(h, p.weight)) for p in (a.q, a.k, a.v))
            probs = torch.softmax(matmul(q, k.transpose(-1, -2)) + bias, dim=-1)
            out = matmul(probs, v).transpose(1, 2).reshape(b, length, -1)
            x = x + linear(out, a.o.weight)
            h = _rms(x, blk.ln_ffn.weight)
            f = blk.ffn
            if w["ffn"] == "relu":
                g = F.relu(linear(h, f.wi.weight))
            else:
                g = F.gelu(linear(h, f.wi_0.weight), approximate="tanh") * linear(h, f.wi_1.weight)
            x = x + linear(g, f.wo.weight)
        return _rms(x, self.final_ln.weight)


class T5Conditioner(nn.Module):
    """Byte tokens -> T5 -> a Linear projection where the widths differ
    (t5-base's 768 into 768: none), padded positions zeroed; -> (B, L, D)."""

    def __init__(self, t5_name: str, out_dim: int, max_length: int, project_out: bool):
        super().__init__()
        self.max_length = max_length
        w = T5_WIDTHS[t5_name]
        self.encoder = T5Encoder(w)
        use_proj = project_out or w["d_model"] != out_dim
        self.proj = _Linear(w["d_model"], out_dim) if use_proj else None

    def forward(self, texts: List[str]):
        dev = self.encoder.embedding.device
        ids, mask = byte_tokens(texts, self.max_length)
        ids, mask = ids.to(dev), mask.to(dev)
        emb = self.encoder(ids, mask)
        if self.proj is not None:
            emb = self.proj(emb)
        return emb * mask[..., None].float()


class NumberConditioner(nn.Module):
    """Clamp to [min, max], normalise to [0, 1], [x, sin 2 pi x w,
    cos 2 pi x w], Linear(257 -> D): (B,) -> (B, 1, D)."""

    def __init__(self, out_dim: int, min_val: float, max_val: float, dim: int = 256):
        super().__init__()
        self.min_val, self.max_val = float(min_val), float(max_val)
        self.embedder = nn.Module()
        self.embedder.embedding = nn.Module()
        self.embedder.embedding.pos = nn.Module()
        self.embedder.embedding.pos.weights = nn.Parameter(torch.empty(dim // 2))
        self.embedder.embedding.linear = _Linear(dim + 1, out_dim)

    def forward(self, values: Sequence[float]):
        e = self.embedder.embedding
        x = torch.tensor([float(v) for v in values], device=e.pos.weights.device)
        x = (x.clamp(self.min_val, self.max_val) - self.min_val) / (self.max_val - self.min_val)
        f = x[:, None] * e.pos.weights[None, :] * (2 * math.pi)
        return e.linear(torch.cat([x[:, None], torch.sin(f), torch.cos(f)], dim=-1))[:, None]


# ---------------------------------------------------------------- DiT


def _layer_norm(x, gamma):
    """The published LayerNorm: a learned gamma, beta a buffer of zeros."""
    return F.layer_norm(x, (x.shape[-1],), gamma, None, 1e-5)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat((-x2, x1), dim=-1)


def _rotary(t, freqs):
    """apply_rotary_pos_emb: the first freqs.shape[-1] dims rotated."""
    rot = freqs.shape[-1]
    t, rest = t[..., :rot], t[..., rot:]
    return torch.cat((t * freqs.cos() + _rotate_half(t) * freqs.sin(), rest), dim=-1)


class _SelfAttn(nn.Module):
    def __init__(self, dim, dim_heads):
        super().__init__()
        self.heads = dim // dim_heads
        self.to_qkv = _Linear(dim, 3 * dim, bias=False)
        self.to_out = _Linear(dim, dim, bias=False)

    def forward(self, x, freqs):
        b, n, _ = x.shape
        q, k, v = (t.reshape(b, n, self.heads, -1).transpose(1, 2)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        q, k = _rotary(q, freqs), _rotary(k, freqs)
        logits = matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        out = matmul(torch.softmax(logits, dim=-1), v)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class _CrossAttn(nn.Module):
    def __init__(self, dim, dim_context, dim_heads):
        super().__init__()
        self.heads, self.kv_heads = dim // dim_heads, dim_context // dim_heads
        self.to_q = _Linear(dim, dim, bias=False)
        self.to_kv = _Linear(dim_context, 2 * dim_context, bias=False)
        self.to_out = _Linear(dim, dim, bias=False)

    def forward(self, x, context):
        b, n, _ = x.shape
        q = self.to_q(x).reshape(b, n, self.heads, -1).transpose(1, 2)
        k, v = (t.reshape(b, t.shape[1], self.kv_heads, -1).transpose(1, 2)
                for t in self.to_kv(context).chunk(2, dim=-1))
        # each kv head serves heads / kv_heads query heads (repeat_interleave)
        rep = self.heads // self.kv_heads
        k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
        # no context mask: the published DiT turns it off
        logits = matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        out = matmul(torch.softmax(logits, dim=-1), v)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class _FF(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = _Linear(dim, 2 * inner)
        self.out = _Linear(inner, dim)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return self.out(a * F.silu(gate))


class _Block(nn.Module):
    def __init__(self, dim, dim_heads, dim_context, inner):
        super().__init__()
        self.pre_norm, self.cross_attend_norm, self.ff_norm = _W(dim), _W(dim), _W(dim)
        self.self_attn = _SelfAttn(dim, dim_heads)
        self.cross_attn = _CrossAttn(dim, dim_context, dim_heads)
        self.ff = _FF(dim, inner)

    def forward(self, x, context, freqs):
        x = x + self.self_attn(_layer_norm(x, self.pre_norm.weight), freqs)
        x = x + self.cross_attn(_layer_norm(x, self.cross_attend_norm.weight), context)
        return x + self.ff(_layer_norm(x, self.ff_norm.weight))


class _MLP(nn.Module):
    """Linear, SiLU, Linear, named as nn.Sequential names them ("0", "2")."""

    def __init__(self, fin, fout, bias):
        super().__init__()
        self.add_module("0", _Linear(fin, fout, bias))
        self.add_module("2", _Linear(fout, fout, bias))

    def forward(self, x):
        return getattr(self, "2")(F.silu(getattr(self, "0")(x)))


class DiT(nn.Module):
    """DiffusionTransformer with the continuous transformer, global_cond_type
    "prepend", on x (B, io_channels, T)."""

    def __init__(self, dc: Dict):
        super().__init__()
        dim, io = dc["embed_dim"], dc["io_channels"]
        dim_heads = dim // dc["num_heads"]
        ctx = dc["cond_token_dim"]  # project_cond_tokens false: the context keeps its width
        self.depth = dc["depth"]
        # RotaryEmbedding(max(dim_heads // 2, 32)), base 10000
        rot = max(dim_heads // 2, 32)
        self.inv_freq = 1.0 / (10_000 ** (torch.arange(0, rot, 2).float() / rot))
        self.timestep_features = _W(128, 1)  # FourierFeatures(1, 256)
        self.to_timestep_embed = _MLP(256, dim, True)
        self.to_cond_embed = _MLP(dc["cond_token_dim"], ctx, False)
        self.to_global_embed = _MLP(dc["global_cond_dim"], dim, False)
        # nn.Conv1d(io, io, 1, bias=False) in the published code: a (C, C) weight here
        self.preprocess_conv = _W(io, io)
        self.postprocess_conv = _W(io, io)
        self.project_in = _Linear(io, dim, False)
        self.project_out = _Linear(dim, io, False)
        self.layers = nn.ModuleList(_Block(dim, dim_heads, ctx, 4 * dim)
                                    for _ in range(self.depth))

    def forward(self, x, t, cross_attn_cond, global_embed):
        """x (B, C, T), t (B,), cross_attn_cond (B, M, cond_token_dim),
        global_embed (B, global_cond_dim) -> (B, C, T)."""
        context = self.to_cond_embed(cross_attn_cond)
        global_embed = self.to_global_embed(global_embed)
        f = 2 * math.pi * linear(t[:, None], self.timestep_features.weight)
        timestep_embed = self.to_timestep_embed(torch.cat([f.cos(), f.sin()], dim=-1))
        prepend = (global_embed + timestep_embed)[:, None]
        # x = self.preprocess_conv(x) + x
        x = matmul(_r(self.preprocess_conv.weight), x) + x
        x = self.project_in(x.transpose(1, 2))
        x = torch.cat([prepend, x], dim=1)
        pos = torch.arange(x.shape[1], device=x.device, dtype=torch.float32)
        freqs = pos[:, None] * self.inv_freq.to(x.device)[None, :]
        freqs = torch.cat([freqs, freqs], dim=-1)
        for layer in self.layers:
            x = layer(x, context, freqs)
        out = self.project_out(x).transpose(1, 2)[:, :, 1:]
        return matmul(_r(self.postprocess_conv.weight), out) + out

    def guided(self, x, t, cross_attn_cond, global_embed, scale: float):
        """Classifier-free guidance: the unconditional branch takes zeros
        for the cross-attention tokens (the global embedding is kept);
        u + scale (c - u). The two branches run one after the other."""
        cond = self(x, t, cross_attn_cond, global_embed)
        uncond = self(x, t, torch.zeros_like(cross_attn_cond), global_embed)
        return uncond + (cond - uncond) * scale


# ----------------------------------------------------------- Oobleck


def _snake_beta(x, act):
    """SnakeBeta with log-scale alpha, beta over channels of (B, C, T)."""
    alpha, beta = act.alpha.exp()[None, :, None], act.beta.exp()[None, :, None]
    return x + (1.0 / (beta + 1e-9)) * torch.sin(x * alpha).pow(2)


class _Act(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(c))
        self.beta = nn.Parameter(torch.empty(c))


class _Conv(nn.Module):
    """WNConv1d with the weight norm folded into the weight."""

    def __init__(self, cin, cout, k, dilation=1, bias=True):
        super().__init__()
        self.dilation = dilation
        self.weight = nn.Parameter(torch.empty(cout, cin, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        pad = self.dilation * (self.weight.shape[-1] - 1) // 2
        return F.conv1d(_r(x), _r(self.weight), self.bias, padding=pad, dilation=self.dilation)


class _ConvT(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(cin, cout, 2 * stride))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return F.conv_transpose1d(_r(x), _r(self.weight), self.bias, stride=self.stride,
                                  padding=math.ceil(self.stride / 2))


class _Res(nn.Module):
    def __init__(self, c, dilation):
        super().__init__()
        self.act1, self.conv1 = _Act(c), _Conv(c, c, 7, dilation)
        self.act2, self.conv2 = _Act(c), _Conv(c, c, 1)

    def forward(self, x):
        return x + self.conv2(_snake_beta(self.conv1(_snake_beta(x, self.act1)), self.act2))


class _DecBlock(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.act, self.up = _Act(cin), _ConvT(cin, cout, stride)
        self.res = nn.ModuleList(_Res(cout, d) for d in (1, 3, 9))

    def forward(self, x):
        x = self.up(_snake_beta(x, self.act))
        for unit in self.res:
            x = unit(x)
        return x


class OobleckDecoder(nn.Module):
    """latent (B, dimension, F) -> audio (B, channels, F * prod(strides))."""

    def __init__(self, oc: Dict):
        super().__init__()
        ch, mults = oc["base_channels"], [1] + list(oc["c_mults"])
        self.conv_in = _Conv(oc["dimension"], mults[-1] * ch, 7)
        self.blocks = nn.ModuleList(_DecBlock(mults[i] * ch, mults[i - 1] * ch,
                                              oc["strides"][i - 1])
                                    for i in range(len(mults) - 1, 0, -1))
        self.act_out = _Act(ch)
        self.conv_out = _Conv(ch, oc["channels"], 7, bias=False)

    def forward(self, z):
        x = self.conv_in(z)
        for block in self.blocks:
            x = block(x)
        return self.conv_out(_snake_beta(x, self.act_out))  # final_tanh false


# ------------------------------------------------------------- models


def build(cfg: Dict, device="cpu"):
    """{"t5", "seconds_start", "seconds_total", "dit", "decoder"} of a
    configuration (the port's Config as a dict), parameters
    uninitialised."""
    cc = cfg["conditioner_config"]
    t5c = cc["t5_config"]
    with torch.device(device):
        return {
            "t5": T5Conditioner(t5c["t5_model_name"], cc["cond_dim"], t5c["max_length"],
                                t5c["project_out"]),
            "seconds_start": NumberConditioner(cc["cond_dim"],
                                               cc["number_start_config"]["min_val"],
                                               cc["number_start_config"]["max_val"]),
            "seconds_total": NumberConditioner(cc["cond_dim"], cc["number_config"]["min_val"],
                                               cc["number_config"]["max_val"]),
            "dit": DiT(cfg["dit_config"]),
            "decoder": OobleckDecoder(cfg["oobleck_config"]),
        }


def conditioning(models: Dict, captions: List[str], seconds_start: float,
                 seconds_total: float):
    """(cross-attention tokens (B, L + 2, D): the prompt's, seconds_start's,
    seconds_total's; the global condition (B, 2 D): seconds_start's and
    seconds_total's, concatenated)."""
    b = len(captions)
    prompt = models["t5"](captions)
    start = models["seconds_start"]([seconds_start] * b)
    total = models["seconds_total"]([seconds_total] * b)
    return torch.cat([prompt, start, total], dim=1), torch.cat([start, total], dim=-1)[:, 0]


def sample_vdm(dit: DiT, noise: torch.Tensor, cross, glob, steps: int,
               scale: float) -> torch.Tensor:
    """The deterministic v-space sampler (alpha = cos(t pi/2), sigma =
    sin(t pi/2) on linspace(1, 0, steps + 1)) from x_T = `noise` (B, C, T),
    the guided DiT predicting v."""
    ts = np.linspace(1.0, 0.0, steps + 1, dtype=np.float32)
    ang = ts * np.float32(math.pi / 2)
    alpha, sigma = np.cos(ang), np.sin(ang)
    x = noise
    for i in range(steps):
        t = torch.full((x.shape[0],), float(ts[i]), device=x.device)
        v = dit.guided(x, t, cross, glob, scale)
        x_pred = float(alpha[i]) * x - float(sigma[i]) * v
        n_pred = float(sigma[i]) * x + float(alpha[i]) * v
        x = float(alpha[i + 1]) * x_pred + float(sigma[i + 1]) * n_pred
    return x


def generate(models: Dict, cfg: Dict, captions: List[str], noise: torch.Tensor, steps: int,
             seconds_start: float, seconds_total: float) -> torch.Tensor:
    """Audio (B, channels, samples) from captions and x_T `noise` (B, C, T):
    the conditioners, the guided sampler at the config's scale, and the
    decoder a clip at a time."""
    cross, glob = conditioning(models, captions, seconds_start, seconds_total)
    scale = cfg["diffusion_config"]["variational_diffusion"]["embedding_scale"]
    lat = sample_vdm(models["dit"], noise, cross, glob, steps, scale)
    return torch.cat([models["decoder"](lat[i:i + 1]) for i in range(lat.shape[0])])
