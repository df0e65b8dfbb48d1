"""Plain fp32 JEN-1: the T5 text encoder, the CFG UNet denoiser and the
SEANet decoder of the 48 kHz EnCodec, in plain PyTorch.

Written from the published JEN-1 structure (the UNet of
0417keito/JEN-1-pytorch, FLAN-T5's encoder, EnCodec's decoder), with the
parameter names of the program's modules, so that the benchmark's seeded
weights (`weights.py`) load into both sides by name. Everything runs in
fp32 with TF32 off (`fp32()`), channels-last (B, L, C) as the program, with
no kernel, cache, graph or batching of the program's. Nothing here imports
the program.

`lower_precision()` rounds the inputs and weights of every matrix product
and convolution to float8 e4m3 (per-tensor scale), the precision below the
configuration's bf16 compute: the control that the comparison has to fail.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

# the rounding of products' operands; None is fp32 (see lower_precision)
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


def conv1d_cl(x, w, b, *, stride=1, dilation=1, causal=False):
    """'Same'-style conv of channels-last x: total padding (K - 1) *
    dilation, half on each side, or all on the left when causal; weight
    (Cout, Cin, K)."""
    pad = (w.shape[-1] - 1) * dilation
    xt = F.pad(x.transpose(1, 2), (pad, 0) if causal else (pad // 2, pad // 2))
    return F.conv1d(_r(xt), _r(w), b, stride=stride, dilation=dilation).transpose(1, 2)


# ----------------------------------------------------------------- T5


T5_WIDTHS = {
    "google/flan-t5-large": dict(vocab_size=32128, d_model=1024, d_kv=64, num_heads=16,
                                 d_ff=2816, num_layers=24),
    "tiny-test": dict(vocab_size=64, d_model=32, d_kv=8, num_heads=4, d_ff=48,
                      num_layers=2),
}
BYTE_VOCAB = 259  # ids 3..258 for UTF-8 bytes, 0 pad, 1 eos


def byte_tokens(texts: List[str], max_length: int):
    """UTF-8 bytes + 3, then eos (1), padded with 0: (ids, mask)."""
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


class _W(nn.Module):
    def __init__(self, *shape):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*shape))


class _Linear(nn.Module):
    def __init__(self, fin, fout, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(fout, fin))
        self.bias = nn.Parameter(torch.empty(fout)) if bias else None

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class _T5Attn(nn.Module):
    def __init__(self, w, rel_bias):
        super().__init__()
        inner = w["num_heads"] * w["d_kv"]
        self.w = w
        self.q, self.k, self.v = (_W(inner, w["d_model"]) for _ in range(3))
        self.o = _W(w["d_model"], inner)
        self.relative_attention_bias = (nn.Parameter(torch.empty(32, w["num_heads"]))
                                        if rel_bias else None)


class _T5FFN(nn.Module):
    def __init__(self, w):
        super().__init__()
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
    """FLAN-T5 encoder: RMSNorm, bucketed relative position bias from block
    0 shared by every block, no 1/sqrt(d) query scaling, gated-GELU FFN."""

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
            g = F.gelu(linear(h, f.wi_0.weight), approximate="tanh") * linear(h, f.wi_1.weight)
            x = x + linear(g, f.wo.weight)
        return _rms(x, self.final_ln.weight)


class T5Conditioner(nn.Module):
    """Byte tokens -> T5 -> Linear projection, padded positions zeroed."""

    def __init__(self, t5_name: str, out_dim: int, max_length: int):
        super().__init__()
        self.max_length = max_length
        self.encoder = T5Encoder(T5_WIDTHS[t5_name])
        self.proj = _Linear(T5_WIDTHS[t5_name]["d_model"], out_dim)

    def forward(self, texts: List[str]):
        dev = self.proj.weight.device
        ids, mask = byte_tokens(texts, self.max_length)
        ids, mask = ids.to(dev), mask.to(dev)
        emb = self.proj(self.encoder(ids, mask))
        return emb * mask[..., None].float(), mask


# --------------------------------------------------------------- UNet


class _Norm(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))


def group_norm(x, norm: _Norm, groups: int, eps: float = 1e-5):
    return F.group_norm(x.transpose(1, 2), groups, norm.weight, norm.bias, eps).transpose(1, 2)


def layer_norm(x, norm: _Norm):
    return F.layer_norm(x, (x.shape[-1],), norm.weight, norm.bias, 1e-5)


class _Conv(nn.Module):
    def __init__(self, cin, cout, k, stride=1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(cout, cin, k))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x, causal=False):
        return conv1d_cl(x, self.weight, self.bias, stride=self.stride, causal=causal)


class _ConvBlock(nn.Module):
    def __init__(self, cin, cout, groups):
        super().__init__()
        self.groups = groups
        self.groupnorm = _Norm(cin)
        self.project = _Conv(cin, cout, 3)

    def forward(self, x, scale_shift=None, causal=False):
        x = group_norm(x, self.groupnorm, self.groups)
        if scale_shift is not None:
            x = x * (scale_shift[0] + 1.0) + scale_shift[1]
        return self.project(F.silu(x), causal)


class _ScaleShift(nn.Module):
    def __init__(self, mf, c):
        super().__init__()
        self.to_scale_shift = _Linear(mf, 2 * c)

    def forward(self, mapping):
        scale, shift = self.to_scale_shift(F.silu(mapping)).chunk(2, dim=-1)
        return scale[:, None], shift[:, None]


class Resnet(nn.Module):
    def __init__(self, cin, cout, groups, mf):
        super().__init__()
        self.block1 = _ConvBlock(cin, cout, groups)
        self.to_scale_shift = _ScaleShift(mf, cout)
        self.block2 = _ConvBlock(cout, cout, groups)
        self.to_out = _Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x, mapping, causal=False):
        h = self.block1(x, causal=causal)
        h = self.block2(h, self.to_scale_shift(mapping), causal)
        return h + (x if self.to_out is None else self.to_out(x))


class _PatchResnet(nn.Module):
    """Patcher / Unpatcher at patch size 1: one resnet with one group,
    never causal (the UNet hands them no causal flag)."""

    def __init__(self, cin, cout, mf):
        super().__init__()
        self.block = Resnet(cin, cout, 1, mf)

    def forward(self, x, mapping):
        return self.block(x, mapping)


class Attention(nn.Module):
    def __init__(self, c, heads, ctx_features=None):
        super().__init__()
        self.heads = heads
        self.norm, self.norm_context = _Norm(c), _Norm(ctx_features or c)
        self.to_q = _Linear(c, c, bias=False)
        self.to_kv = _Linear(ctx_features or c, 2 * c, bias=False)
        self.to_out = _Linear(c, c)

    def forward(self, x, context=None, context_mask=None, causal=False):
        ctx = layer_norm(x if context is None else context, self.norm_context)
        q = self.to_q(layer_norm(x, self.norm))
        k, v = self.to_kv(ctx).chunk(2, dim=-1)
        if context_mask is not None:
            m = context_mask.float()[..., None]
            k, v = k * m, v * m
        b, n, c = q.shape
        d = c // self.heads

        def heads(t):
            return t.reshape(b, t.shape[1], self.heads, d).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        logits = matmul(q, k.transpose(-1, -2)) * d ** -0.5
        if causal:
            n_, m_ = logits.shape[-2:]
            above = (torch.arange(m_, device=x.device)[None, :]
                     > torch.arange(n_, device=x.device)[:, None] + (m_ - n_))
            logits = logits.masked_fill(above, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1)
        return self.to_out(matmul(probs, v).transpose(1, 2).reshape(b, n, c))


class _FeedForward(nn.Module):
    def __init__(self, c, mult):
        super().__init__()
        self.linear1, self.linear2 = _Linear(c, c * mult), _Linear(c * mult, c)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(x)))


class _TBlock(nn.Module):
    def __init__(self, c, heads, mult, ctx_features):
        super().__init__()
        self.attention = Attention(c, heads)
        self.cross_attention = Attention(c, heads, ctx_features)
        self.feed_forward = _FeedForward(c, mult)

    def forward(self, x, context, context_mask, causal=False):
        x = self.attention(x, causal=causal) + x
        x = self.cross_attention(x, context, context_mask) + x
        return self.feed_forward(x) + x


class Transformer(nn.Module):
    def __init__(self, layers, c, heads, mult, ctx_features):
        super().__init__()
        self.layers = layers
        self.group_norm = _Norm(c)
        self.conv_in, self.conv_out = _Conv(c, c, 1), _Conv(c, c, 1)
        for i in range(layers):
            self.add_module(f"block{i}", _TBlock(c, heads, mult, ctx_features))

    def forward(self, x, context, context_mask, causal=False):
        x = self.conv_in(group_norm(x, self.group_norm, min(32, x.shape[-1]), 1e-6))
        for i in range(self.layers):
            x = getattr(self, f"block{i}")(x, context, context_mask, causal)
        return self.conv_out(x)


class _Down(nn.Module):
    def __init__(self, cin, cout, factor, blocks, groups, mf, attn, kmul):
        super().__init__()
        self.blocks = blocks
        self.downsample = nn.Module()
        self.downsample.conv = _Conv(cin, cout, factor * kmul + 1, stride=factor)
        for i in range(blocks):
            self.add_module(f"block{i}", Resnet(cout, cout, groups, mf))
        self.transformer = Transformer(*attn(cout)) if attn(cout)[0] else None

    def forward(self, x, mapping, ctx, ctx_mask, causal=False):
        x = self.downsample.conv(x, causal)
        skips = []
        for i in range(self.blocks):
            x = getattr(self, f"block{i}")(x, mapping, causal)
            skips.append(x)
        if self.transformer is not None:
            x = self.transformer(x, ctx, ctx_mask, causal)
            skips.append(x)
        return x, skips


def _crop(x, skip):
    lx, ls = x.shape[1], skip.shape[1]
    if lx > ls:
        x = x[:, (lx - ls) // 2:(lx - ls) // 2 + ls]
    elif ls > lx:
        skip = skip[:, (ls - lx) // 2:(ls - lx) // 2 + lx]
    return x, skip


class _Up(nn.Module):
    def __init__(self, cin, cout, factor, blocks, groups, mf, attn):
        super().__init__()
        self.blocks, self.factor = blocks, factor
        for i in range(blocks):
            self.add_module(f"block{i}", Resnet(2 * cin, cin, groups, mf))
        self.transformer = Transformer(*attn(cin)) if attn(cin)[0] else None
        self.upsample = nn.Module()
        shape = (cin, cout, 2 * factor) if factor > 1 else (cout, cin, 3)
        self.upsample.weight = nn.Parameter(torch.empty(shape))
        self.upsample.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x, skips, mapping, ctx, ctx_mask, causal=False):
        for i in range(self.blocks):
            x, skip = _crop(x, skips.pop())
            x = getattr(self, f"block{i}")(torch.cat([x, skip * 2 ** -0.5], dim=-1), mapping,
                                           causal)
        if self.transformer is not None:
            x = self.transformer(x, ctx, ctx_mask, causal)
        f, up = self.factor, self.upsample
        if f == 1:
            return conv1d_cl(x, up.weight, up.bias)
        y = F.conv_transpose1d(_r(x.transpose(1, 2)), _r(up.weight), up.bias, stride=f,
                               padding=f // 2 + f % 2, output_padding=f % 2)
        return y.transpose(1, 2)


class UNetCFG(nn.Module):
    """The JEN-1 1-D UNet with batched classifier-free guidance: FiLM from
    Fourier time features, context channels concatenated at the input, a
    time token appended to the text, cross-attention in every transformer,
    guidance 0.8 with the std-matching rescale (phi 0.7)."""

    def __init__(self, mc: Dict):
        super().__init__()
        c, mult = mc["channels"], mc["multipliers"]
        n = len(mult) - 1
        self.n, self.mc = n, mc
        mf = c * mc["context_features_multiplier"]
        emb_f = mc["context_embedding_features"]
        heads, amult = mc["attention_heads"], mc["attention_multiplier"]
        groups = mc["resnet_groups"]
        for key, want in (("patch_size", 1), ("use_snake", False), ("use_stft", False),
                          ("use_context_time", True), ("use_xattn_time", True),
                          ("use_nearest_upsample", False), ("use_skip_scale", True),
                          ("tie_transformer_projections", False), ("n_tracks", 1),
                          ("context_features", None), ("attention_features", None)):
            if mc[key] != want:
                raise NotImplementedError(f"reference UNet: {key}={mc[key]!r}")
        if len(mc["context_channels"]) != 1:
            raise NotImplementedError("reference UNet: context channels at the input only")

        def attn(level_attn):
            return lambda ch: (level_attn, ch, heads, amult, emb_f)

        self.unet = nn.Module()
        u = self.unet
        u.to_time = nn.Module()
        u.to_time.pos = nn.Module()
        u.to_time.pos.weights = nn.Parameter(torch.empty(c // 2))
        u.to_time.linear = _Linear(c + 1, mf)
        u.to_mapping_1, u.to_mapping_2 = _Linear(mf, mf), _Linear(mf, mf)
        u.to_in = _PatchResnet(mc["in_channels"] + mc["context_channels"][0], c * mult[0], mf)
        for i in range(n):
            u.add_module(f"downsample{i}", _Down(
                c * mult[i], c * mult[i + 1], mc["factors"][i], mc["num_blocks"][i], groups,
                mf, attn(mc["attentions"][i]), mc["kernel_multiplier_downsample"]))
        u.bottleneck = nn.Module()
        u.bottleneck.pre_block = Resnet(c * mult[-1], c * mult[-1], groups, mf)
        u.bottleneck.transformer = (Transformer(*attn(mc["attentions"][-1])(c * mult[-1]))
                                    if mc["attentions"][-1] else None)
        u.bottleneck.post_block = Resnet(c * mult[-1], c * mult[-1], groups, mf)
        for j, i in enumerate(reversed(range(n))):
            u.add_module(f"upsample{j}", _Up(
                c * mult[i + 1], c * mult[i], mc["factors"][i],
                mc["num_blocks"][i] + (1 if mc["attentions"][i] else 0), groups, mf,
                attn(mc["attentions"][i])))
        u.to_out = _PatchResnet(c * mult[0], mc["out_channels"], mf)
        self.fixed_embedding = nn.Module()
        self.fixed_embedding.embedding = nn.Parameter(
            torch.empty(mc["context_embedding_max_length"] + 1, emb_f))
        self.to_time_embedding = nn.Module()
        self.to_time_embedding.pos = nn.Module()
        self.to_time_embedding.pos.weights = nn.Parameter(torch.empty(c // 2))
        self.to_time_embedding.linear = _Linear(c + 1, emb_f)

    @staticmethod
    def _time(mod, t):
        freqs = t[:, None] * mod.pos.weights[None, :] * (2 * math.pi)
        return mod.linear(torch.cat([t[:, None], torch.sin(freqs), torch.cos(freqs)], dim=-1))

    def _unet(self, x, t, ctx, ctx_mask, concat, causal=False):
        u = self.unet
        mapping = F.gelu(self._time(u.to_time, t))
        mapping = F.gelu(u.to_mapping_2(F.gelu(u.to_mapping_1(mapping))))
        x = u.to_in(torch.cat([x, concat], dim=-1), mapping)
        skips = [[x]]
        for i in range(self.n):
            x, s = getattr(u, f"downsample{i}")(x, mapping, ctx, ctx_mask, causal)
            skips.append(s)
        bn = u.bottleneck
        x = bn.pre_block(x, mapping, causal)
        if bn.transformer is not None:
            x = bn.transformer(x, ctx, ctx_mask, causal)
        x = bn.post_block(x, mapping, causal)
        for j in range(self.n):
            x = getattr(u, f"upsample{j}")(x, skips.pop(), mapping, ctx, ctx_mask, causal)
        x, skip0 = _crop(x, skips.pop()[0])
        return u.to_out(x + skip0, mapping)

    def forward(self, x, t, embedding, embedding_mask, concat, scale=0.8, phi=0.7,
                causal=False, drop=None):
        """`drop` (B, 1, 1) bool: CFG dropout, the text replaced by the
        learned null embedding where set (training)."""
        b = x.shape[0]
        token = F.gelu(self._time(self.to_time_embedding, t))
        embedding = torch.cat([embedding, token[:, None]], dim=1)
        embedding_mask = torch.cat(
            [embedding_mask, torch.ones((b, 1), dtype=torch.bool, device=x.device)], dim=1)
        fixed = self.fixed_embedding.embedding[: embedding.shape[1]][None].expand(
            b, -1, -1)
        if drop is not None:
            embedding = torch.where(drop, fixed, embedding)

        def twice(a):
            return torch.cat([a, a], dim=0)

        both = self._unet(twice(x), twice(t), torch.cat([embedding, fixed], dim=0),
                          twice(embedding_mask), twice(concat), causal)
        out, out_null = both.chunk(2, dim=0)
        cfg = out_null + (out - out_null) * scale
        rescaled = cfg * (out.std(dim=-1, keepdim=True) / cfg.std(dim=-1, keepdim=True))
        return phi * rescaled + (1.0 - phi) * cfg


# -------------------------------------------------------------- codec


def _pad_reflect(x, left, right):
    length = x.shape[-1]
    extra = 0
    if length <= max(left, right):
        extra = max(left, right) - length + 1
        x = F.pad(x, (0, extra))
    y = F.pad(x, (left, right), mode="reflect")
    return y[..., : y.shape[-1] - extra] if extra else y


class _SConv(nn.Module):
    """EnCodec's conv: reflect padding that keeps the last partial frame,
    then GroupNorm with one group; (B, C, L)."""

    def __init__(self, cin, cout, k, stride=1, dilation=1):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.weight = nn.Parameter(torch.empty(cout, cin, k))
        self.bias = nn.Parameter(torch.empty(cout))
        self.norm = _Norm(cout)

    def forward(self, x):
        keff = (self.weight.shape[-1] - 1) * self.dilation + 1
        total = keff - self.stride
        frames = (x.shape[-1] - keff + total) / self.stride + 1
        extra = max((math.ceil(frames) - 1) * self.stride + keff - total - x.shape[-1], 0)
        x = _pad_reflect(x, total - total // 2, total // 2 + extra)
        y = F.conv1d(_r(x), _r(self.weight), self.bias, stride=self.stride,
                     dilation=self.dilation)
        return F.group_norm(y, 1, self.norm.weight, self.norm.bias, 1e-5)


class _SConvT(nn.Module):
    def __init__(self, cin, cout, k, stride):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(cin, cout, k))
        self.bias = nn.Parameter(torch.empty(cout))
        self.norm = _Norm(cout)

    def forward(self, x):
        y = F.conv_transpose1d(_r(x), _r(self.weight), self.bias, stride=self.stride)
        y = F.group_norm(y, 1, self.norm.weight, self.norm.bias, 1e-5)
        total = self.weight.shape[-1] - self.stride
        return y[..., total - total // 2: y.shape[-1] - total // 2]


class _SRes(nn.Module):
    def __init__(self, dim, dilation):
        super().__init__()
        self.conv1 = _SConv(dim, dim // 2, 3, dilation=dilation)
        self.conv2 = _SConv(dim // 2, dim, 1)
        self.shortcut = _SConv(dim, dim, 1)

    def forward(self, x):
        return self.shortcut(x) + self.conv2(F.elu(self.conv1(F.elu(x))))


class SEANetDecoder(nn.Module):
    """EnCodec 48 kHz decoder: latent (B, F, 128) -> audio (B, 320 F, 2)."""

    def __init__(self, dimension=128, channels=2, n_filters=32, ratios=(8, 5, 4, 2)):
        super().__init__()
        self.ratios = ratios
        mult = 2 ** len(ratios)
        self.conv_in = _SConv(dimension, mult * n_filters, 7)
        self.lstm = nn.Module()
        self.lstm.lstm = nn.LSTM(mult * n_filters, mult * n_filters, 2)
        for si, ratio in enumerate(ratios):
            dim = mult * n_filters // 2
            self.add_module(f"stage{si}_up", _SConvT(mult * n_filters, dim, 2 * ratio, ratio))
            self.add_module(f"stage{si}_res0", _SRes(dim, 1))
            mult //= 2
        self.conv_out = _SConv(n_filters, channels, 7)

    def forward(self, z):
        x = self.conv_in(z.transpose(1, 2))
        seq = x.permute(2, 0, 1)
        lstm = self.lstm.lstm
        weights = {name: _r(p) if "weight" in name else p for name, p in lstm.named_parameters()}
        y, _ = torch.func.functional_call(lstm, weights, (_r(seq),))
        x = (y + seq).permute(1, 2, 0)
        for si in range(len(self.ratios)):
            x = getattr(self, f"stage{si}_up")(F.elu(x))
            x = getattr(self, f"stage{si}_res0")(x)
        return self.conv_out(F.elu(x)).transpose(1, 2)

    def decode_chunked(self, latent, chunk=150, hop=148):
        """EnCodec's 1 s segments with 1 % overlap: overlapping latent
        chunks decoded and joined by a triangular overlap-add."""
        b, f, d = latent.shape
        up = math.prod(self.ratios)
        if f <= chunk:
            return self(latent)[:, : f * up]
        n = max(1, math.ceil((f - chunk) / hop) + 1)
        latent = F.pad(latent, (0, 0, 0, (n - 1) * hop + chunk - f))
        pieces = [self(latent[:, i * hop: i * hop + chunk])[:, : chunk * up] for i in range(n)]
        total = hop * up * (n - 1) + chunk * up
        out = torch.zeros((b, total, pieces[0].shape[-1]), device=latent.device)
        norm = torch.zeros((total, 1), device=latent.device)
        ramp = torch.linspace(0.0, 1.0, chunk * up + 2, device=latent.device)[1:-1]
        w = (0.5 - (ramp - 0.5).abs())[:, None]
        for i, piece in enumerate(pieces):
            out[:, i * hop * up: i * hop * up + chunk * up] += piece * w
            norm[i * hop * up: i * hop * up + chunk * up] += w
        return (out / norm.clamp_min(1e-12))[:, : f * up]


def build(cfg: Dict, device="cpu"):
    """(T5 conditioner, UNet, SEANet decoder) of a configuration file's
    `config` (the program's Config as a dict), parameters uninitialised."""
    cc = cfg["conditioner_config"]
    with torch.device(device):
        t5 = T5Conditioner(cc["t5_config"]["t5_model_name"], cc["cond_dim"],
                           cc["t5_config"]["max_length"])
        unet = UNetCFG(cfg["model_config"])
        decoder = SEANetDecoder()
    return t5, unet, decoder


def sample_vdm(unet: UNetCFG, shape: Sequence[int], cond, noise: torch.Tensor,
               steps: int) -> torch.Tensor:
    """The deterministic v-space sampler: alpha = cos(t pi/2), sigma =
    sin(t pi/2) on linspace(1, 0, steps + 1), from x_T = `noise`."""
    import numpy as np

    ts = np.linspace(1.0, 0.0, steps + 1, dtype=np.float32)
    ang = ts * np.float32(math.pi / 2)
    alpha, sigma = np.cos(ang), np.sin(ang)
    x = noise
    for i in range(steps):
        t = torch.full((shape[0],), float(ts[i]), device=x.device)
        v = unet(x, t, *cond)
        x_pred = float(alpha[i]) * x - float(sigma[i]) * v
        n_pred = float(sigma[i]) * x + float(alpha[i]) * v
        x = float(alpha[i + 1]) * x_pred + float(sigma[i + 1]) * n_pred
    return x


def sample_ddim(unet: UNetCFG, shape: Sequence[int], cond, generator: torch.Generator,
                steps: int, timesteps: int = 1000, eta: float = 1.0,
                rows: slice = slice(None)) -> torch.Tensor:
    """DDIM over `steps` of the linear schedule's `timesteps` (beta 1e-4 to
    0.02), v objective, x_start clipped to [-1, 1]; x_T then each step's
    noise drawn from `generator` in order at the batch's `shape`, as the
    sampler draws them. Only `rows` of the batch are denoised (`cond`
    holds theirs): each row's result depends on its own draws alone."""
    import numpy as np

    scale = 1000 / timesteps
    betas = np.linspace(scale * 1e-4, scale * 0.02, timesteps,
                        dtype=np.float64).astype(np.float32).astype(np.float64)
    acp = np.cumprod(1.0 - betas)
    acp32 = acp.astype(np.float32)
    sqrt_acp, sqrt_1m = np.sqrt(acp).astype(np.float32), np.sqrt(1.0 - acp).astype(np.float32)
    recip, recipm1 = (np.sqrt(1.0 / acp).astype(np.float32),
                      np.sqrt(1.0 / acp - 1.0).astype(np.float32))
    times = np.linspace(-1, timesteps - 1, num=steps + 1).astype(np.int32)[::-1]
    dev = cond[0].device
    x = torch.randn(tuple(shape), generator=generator, device=dev)[rows]
    one, eta32 = np.float32(1.0), np.float32(eta)
    for time, time_next in zip(times[:-1], times[1:]):
        noise = torch.randn(tuple(shape), generator=generator, device=dev)[rows]
        a, a_next = acp32[time], acp32[max(time_next, 0)]
        sigma = eta32 * np.sqrt((one - a / a_next) * (one - a_next) / (one - a))
        c = np.sqrt(one - a_next - sigma * sigma)
        t = torch.full((x.shape[0],), float(time), device=dev)
        v = unet(x, t, *cond)
        x_start = (float(sqrt_acp[time]) * x - float(sqrt_1m[time]) * v).clamp(-1.0, 1.0)
        if time_next < 0:
            x = x_start
            continue
        pred_noise = (float(recip[time]) * x - x_start) / float(recipm1[time])
        x = x_start * float(np.sqrt(a_next)) + float(c) * pred_noise + float(sigma) * noise
    return x
