"""The benchmark's own count of the work, from a configuration's shapes,
whatever implements them, and the H100's peaks.

`unet_forward_flops` counts the multiply-adds (x2) of every convolution,
transposed convolution, linear layer and attention product of one JEN-1
UNet forward; norms, activations and the elementwise sampler arithmetic
are left out, as a model-FLOPs utilisation leaves them out. The attention
functions give the operations and bytes one call of the flash kernels
(K1 forward, K2 dq, K3 dk/dv) needs, as chip_smoke.py's bounds count
them: QK^T and PV products over the pairs, each of Q, K, V, O (dO, dQ,
dK, dV) and the fp32 row statistics read or written once.
"""

from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# the port's kernels that do the level-1 self-attention work, by the
# name of their CUDA function (a trace's kernel names contain them)
ATTN_KERNELS = {
    "attn_fwd": ("flash_fwd_mma_kernel", "flash_fwd_kernel"),
    "attn_bwd": ("flash_bwd_dq_mma_kernel", "flash_bwd_dq_kernel",
                 "flash_bwd_dkv_mma_kernel", "flash_bwd_dkv_kernel"),
}


def _conv(b: int, l_out: int, cin: int, cout: int, k: int) -> int:
    return 2 * b * l_out * cin * cout * k


def _resnet(b: int, length: int, cin: int, cout: int, mf: int) -> int:
    f = _conv(b, length, cin, cout, 3) + _conv(b, length, cout, cout, 3)
    f += 2 * b * mf * 2 * cout  # FiLM scale and shift
    if cin != cout:
        f += _conv(b, length, cin, cout, 1)
    return f


def _transformer(b: int, n: int, c: int, layers: int, mult: int, m: int, c_ctx: int,
                 causal: bool = False) -> int:
    pairs = n * (n + 1) // 2 if causal else n * n
    f = 2 * _conv(b, n, c, c, 1)  # conv_in, conv_out
    for _ in range(layers):
        f += 2 * b * n * c * 3 * c + 4 * b * pairs * c + 2 * b * n * c * c  # self
        f += (2 * b * n * c * c + 2 * b * m * c_ctx * 2 * c + 4 * b * n * m * c
              + 2 * b * n * c * c)  # cross
        f += 4 * b * n * c * c * mult  # feed-forward
    return f


def level_lengths(mc: Dict, length: int) -> list:
    """Frames at the input and after each down level (strided 'same'
    convs: ceil(L / factor))."""
    out = [length]
    for f in mc["factors"]:
        out.append(-(-out[-1] // f))
    return out


def unet_forward_flops(mc: Dict, batch: int, length: int, text_tokens: int,
                       causal: bool = False) -> int:
    """FLOPs of one UNet forward over `batch` rows (the CFG-doubled batch
    when guidance runs batched) of `length` latent frames, with
    `text_tokens` cross-attention tokens (the time token included); a
    causal forward's self-attention counts the pairs at or below the
    diagonal."""
    c, mult = mc["channels"], mc["multipliers"]
    n = len(mult) - 1
    ch = [c * m for m in mult]
    mf = c * mc["context_features_multiplier"]
    e = mc["context_embedding_features"]
    amult = mc["attention_multiplier"]
    lens = level_lengths(mc, length)
    b = batch
    f = 2 * b * (c + 1) * mf + 2 * 2 * b * mf * mf  # time features, mapping
    f += 2 * b * (c + 1) * e  # cross-attention time token
    f += _resnet(b, length, mc["in_channels"] + mc["context_channels"][0], ch[0], mf)
    for i in range(n):
        fac = mc["factors"][i]
        f += _conv(b, lens[i + 1], ch[i], ch[i + 1], fac * mc["kernel_multiplier_downsample"] + 1)
        f += mc["num_blocks"][i] * _resnet(b, lens[i + 1], ch[i + 1], ch[i + 1], mf)
        if mc["attentions"][i]:
            f += _transformer(b, lens[i + 1], ch[i + 1], mc["attentions"][i], amult,
                              text_tokens, e, causal)
    f += 2 * _resnet(b, lens[n], ch[n], ch[n], mf)
    if mc["attentions"][-1]:
        f += _transformer(b, lens[n], ch[n], mc["attentions"][-1], amult, text_tokens, e,
                          causal)
    for i in reversed(range(n)):
        fac = mc["factors"][i]
        blocks = mc["num_blocks"][i] + (1 if mc["attentions"][i] else 0)
        f += blocks * _resnet(b, lens[i + 1], 2 * ch[i + 1], ch[i + 1], mf)
        if mc["attentions"][i]:
            f += _transformer(b, lens[i + 1], ch[i + 1], mc["attentions"][i], amult,
                              text_tokens, e, causal)
        k = 3 if fac == 1 else 2 * fac
        f += _conv(b, lens[i + 1], ch[i + 1], ch[i], k)
    f += _resnet(b, length, ch[0], mc["out_channels"], mf)
    return f


def attn_fwd(bh: int, n: int, d: int, causal: bool = False, elem: int = 2) -> Tuple[int, int]:
    """(FLOPs, bytes) of one K1 call: QK^T and PV; Q, K, V, O once, and
    the fp32 log-sum-exp."""
    pairs = n * (n + 1) // 2 if causal else n * n
    return 4 * bh * pairs * d, 4 * bh * n * d * elem + bh * n * 4


def attn_bwd_dq(bh: int, n: int, d: int, causal: bool = False,
                elem: int = 2) -> Tuple[int, int]:
    """(FLOPs, bytes) of one K2 call (dQ)."""
    pairs = n * (n + 1) // 2 if causal else n * n
    return 6 * bh * pairs * d, 5 * bh * n * d * elem + 2 * bh * n * 4


def attn_bwd_dkv(bh: int, n: int, d: int, causal: bool = False,
                 elem: int = 2) -> Tuple[int, int]:
    """(FLOPs, bytes) of one K3 call (dK, dV)."""
    pairs = n * (n + 1) // 2 if causal else n * n
    return 8 * bh * pairs * d, 6 * bh * n * d * elem + 2 * bh * n * 4


def bound_s(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """Least time on the chip: the larger of operations over the peak rate
    and bytes over the memory bandwidth."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def flash_calls(mc: Dict, length: int) -> list:
    """(level, frames) of every self-attention that reaches the flash
    kernels at this latent length: use_flash_attention and at least
    flash_min_seq_len frames."""
    if not mc["use_flash_attention"]:
        return []
    lens = level_lengths(mc, length)
    out = []
    for i, a in enumerate(mc["attentions"][: len(mc["factors"])]):
        if a and lens[i + 1] >= mc["flash_min_seq_len"]:
            out.append((i, lens[i + 1]))
    return out


def mfu_percent(flops: float, seconds: float, dtype: str = "bfloat16") -> float:
    return 100.0 * flops / seconds / PEAK_FLOPS[dtype]

