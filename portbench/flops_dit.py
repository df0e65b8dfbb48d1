"""The benchmark's own count of Stable Audio Open's DiT, from a
configuration's `dit_config` and the cell's shapes, whatever implements
them.

Counted as portbench/flops.py counts the UNet: two operations per
multiply-add of every linear layer (the 1x1 pre/postprocess convs and the
embedding heads included) and of the attention products; norms, rotary,
activations, the gate and the sampler's arithmetic left out. A forward runs
over `rows` rows (the CFG-doubled batch) of `frames` latent frames plus the
prepended token, with `tokens` cross-attention tokens (130 for Stable
Audio Open: 128 of text and the two number conditioners).

The widths the configuration does not state are Stable Audio Open's
fixed ones: the context keeps its width, 256 Fourier time features, a GLU
of 4 x embed_dim.

`GEMM_KERNELS` names the library's matrix-product kernels in a device
trace: the linears and the cross-attention products (the plain route) run
there; the self-attention's products run in K1, whose work `k1_work`
gives through `flops.attn_fwd`.
"""

from __future__ import annotations

from typing import Dict, Tuple

from portbench import flops

# substrings of cuBLAS / CUTLASS matrix-product kernel names on the H100
GEMM_KERNELS = ("gemm", "nvjet", "xmma", "cutlass")
TIMESTEP_FEATURES = 256
FF_MULT = 4


def _widths(dc: Dict):
    dim = dc["embed_dim"]
    heads = dc["num_heads"]
    return dim, heads, dim // heads, dc["cond_token_dim"], FF_MULT * dim


def dit_linear_flops(dc: Dict, rows: int, frames: int, tokens: int) -> int:
    """FLOPs of every linear layer of one forward."""
    dim, _, _, ctx, inner = _widths(dc)
    io, n, m = dc["io_channels"], frames + 1, tokens
    f = 2 * (TIMESTEP_FEATURES * dim + dim * dim)  # time embedding
    f += 2 * (dc["global_cond_dim"] * dim + dim * dim)  # global embedding
    f += 2 * m * (dc["cond_token_dim"] * ctx + ctx * ctx)  # context embedding
    f += 2 * frames * io * io * 2 + 2 * frames * io * dim + 2 * n * dim * io  # pre/post, in/out
    layer = (2 * n * dim * 3 * dim + 2 * n * dim * dim  # self: qkv, out
             + 2 * n * dim * dim + 2 * m * ctx * 2 * ctx + 2 * n * dim * dim  # cross: q, kv, out
             + 2 * n * dim * 2 * inner + 2 * n * inner * dim)  # GLU feed-forward
    return rows * (f + dc["depth"] * layer)


def dit_cross_attention_flops(dc: Dict, rows: int, frames: int, tokens: int) -> int:
    """FLOPs of the cross-attention products (QK^T and PV) of one forward."""
    dim = dc["embed_dim"]
    return rows * dc["depth"] * 4 * (frames + 1) * tokens * dim


def dit_self_attention_flops(dc: Dict, rows: int, frames: int) -> int:
    """FLOPs of the self-attention products of one forward."""
    n = frames + 1
    return rows * dc["depth"] * 4 * n * n * dc["embed_dim"]


def dit_forward_flops(dc: Dict, rows: int, frames: int, tokens: int) -> int:
    """FLOPs of one forward: linears and both attentions' products."""
    return (dit_linear_flops(dc, rows, frames, tokens)
            + dit_cross_attention_flops(dc, rows, frames, tokens)
            + dit_self_attention_flops(dc, rows, frames))


def dit_gemm_flops(dc: Dict, rows: int, frames: int, tokens: int) -> int:
    """FLOPs of one forward that the library's GEMM kernels run (the
    linears and the cross-attention products)."""
    return (dit_linear_flops(dc, rows, frames, tokens)
            + dit_cross_attention_flops(dc, rows, frames, tokens))


def k1_shape(dc: Dict, rows: int, frames: int) -> Tuple[int, int, int]:
    """(B*H, N, D) of the self-attention's K1 call."""
    _, heads, head_dim, _, _ = _widths(dc)
    return rows * heads, frames + 1, head_dim


def k1_work(dc: Dict, rows: int, frames: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one K1 call at the self-attention's shape."""
    return flops.attn_fwd(*k1_shape(dc, rows, frames))
