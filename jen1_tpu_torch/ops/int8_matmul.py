"""int8 weight-only matmul and conv: the Hopper kernel K4, its plain version,
the dispatcher, the quantizer and the qweights wiring (port of
jen1_tpu/ops/int8_matmul.py).

Weights are quantized symmetrically per output channel, w ~ w8 * scale[n]
with scale = max|w[:, n]| / 127. The product rounds x to bf16, sums
bf16(x) * w8 in fp32 and multiplies by the scale after the sum, as the TPU
kernel `_kernel` does (jen1_tpu/ops/int8_matmul.py:48-69).

  * `matmul_int8w_cuda` launches K4 (`csrc/int8_matmul.cu`) and counts
    `LAUNCHES`; `matmul_int8w_plain` computes the same function in plain
    PyTorch. `matmul_int8w` sends CPU tensors to the plain version and CUDA
    tensors to K4, with no fallback.
  * `conv1d_int8w` is a stride-1 conv as im2col (in PyTorch, outside the
    kernel, as the JAX package leaves it to XLA) and `matmul_int8w`.
  * `quantize_conv_params` selects the UNet's conv kernels by the JAX rule
    and quantizes them; `attach_qweights` hands the result to the stride-1
    `OmniConv1d`s, which then run `conv1d_int8w`. In the JAX package int8 is
    a property of the variables given to `apply`; here it is a property of
    the module, set by these functions.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# Calls of `matmul_int8w_cuda` (each launches K4: one pass, or a split-K
# pass and its reduction), incremented by the wrapper only.
LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# K4's tile: BLOCK_N output columns and BLOCK_K rows of K per step; the
# split over K aims at TARGET_CTAS blocks (two per SM of an H100).
BLOCK_N, BLOCK_K = 64, 64
TARGET_CTAS = 264

QWeights = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w (..., N) float -> (int8 of w's shape, fp32 scale (N,)).

    scale[n] = max(max|w[..., n]|, 1e-12) / 127; w8 = clip(round(w / scale),
    -127, 127) in fp32. torch.round rounds half to even like jnp.round, so
    both are bit-identical to the JAX package's."""
    w = w.float()
    amax = w.abs().reshape(-1, w.shape[-1]).amax(dim=0)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    w8 = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w8, scale


def matmul_int8w_plain(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: x (M, K) rounded to bf16, times w8 (K, N) in
    fp32, times scale (N,) after the product -> (M, N) fp32."""
    return torch.matmul(x.to(torch.bfloat16).float(), w8.float()) * scale.float()


def split_k(m: int, k: int, n: int) -> Tuple[int, int]:
    """(splits, K tiles per split) of K4's grid for an (M, K, N) product.

    One block owns BLOCK_N columns, `rows_per_block(m)` rows and a range of
    K. At the UNet's deep-level shapes (M <= 72, N <= 1024) the M x N grid
    alone is 8-48 blocks on 132 SMs, so K is split until the grid has about
    TARGET_CTAS blocks; every split is non-empty."""
    bm = rows_per_block(m)
    base = -(-n // BLOCK_N) * -(-m // bm)
    k_tiles = -(-k // BLOCK_K)
    want = max(1, min(k_tiles, -(-TARGET_CTAS // base)))
    chunk = -(-k_tiles // want)
    return -(-k_tiles // chunk), chunk


def rows_per_block(m: int) -> int:
    """K4's rows per block: 8, 16 or 32 (2, 4 or 8 per thread)."""
    return 8 if m <= 8 else (16 if m <= 16 else 32)


def matmul_int8w_cuda(
    x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """Launch K4: x (M, K) bf16 or fp32, w8 (K, N) int8, scale (N,) fp32,
    all contiguous on one card -> (M, N) fp32. Launches on the current
    stream without synchronising; a refused launch raises."""
    global LAUNCHES
    from jen1_tpu_torch.ops.kernels import library

    m, k = x.shape
    k2, n = w8.shape
    for name, t in (("x", x), ("w8", w8), ("scale", scale)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"matmul_int8w_cuda: {name} is on {t.device}, not CUDA beside x")
        if not t.is_contiguous():
            raise ValueError(f"matmul_int8w_cuda: {name} is not contiguous")
    if x.dtype not in _DTYPE_CODES or w8.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"matmul_int8w_cuda: dtypes {x.dtype}, {w8.dtype}, {scale.dtype}")
    if k != k2 or tuple(scale.shape) != (n,) or min(m, k, n) < 1:
        raise ValueError(f"matmul_int8w_cuda: shapes {tuple(x.shape)}, {tuple(w8.shape)}, "
                         f"{tuple(scale.shape)}")
    splits, chunk = split_k(m, k, n)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    work = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
            if splits > 1 else out)
    err = library().jen1_int8w_matmul(
        x.data_ptr(), w8.data_ptr(), scale.data_ptr(), work.data_ptr(), out.data_ptr(),
        m, k, n, _DTYPE_CODES[x.dtype], splits, chunk * BLOCK_K,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"jen1_int8w_matmul: launch failed with CUDA error {err}")
    LAUNCHES += 1
    return out


def matmul_int8w(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) bf16/fp32; w8 (K, N) int8; scale (N,) fp32 -> (M, N) fp32:
    the plain version for CPU tensors, K4 for CUDA tensors."""
    if x.device.type == "cpu":
        return matmul_int8w_plain(x, w8, scale)
    return matmul_int8w_cuda(x.contiguous(), w8, scale)


def conv1d_int8w(
    x: torch.Tensor,
    w8: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    dilation: int = 1,
    causal: bool = False,
) -> torch.Tensor:
    """Stride-1 conv1d with int8 weights (jen1_tpu/ops/int8_matmul.py:189-233).

    x (B, L, Cin); w8 (k*Cin, Cout) int8, row tap*Cin + channel; scale
    (Cout,). Padding as `conv1d`: (k-1)*dilation, all on the left when
    causal, else pad // 2 on each side. The bias is added in fp32 after the
    product, then the result is cast to x's dtype."""
    b, length, cin = x.shape
    k = w8.shape[0] // cin
    if k * cin != w8.shape[0]:
        raise ValueError(f"conv1d_int8w: w8 {tuple(w8.shape)} does not fit Cin {cin}")
    pad = (k - 1) * dilation
    pads = (pad, 0) if causal else (pad // 2, pad // 2)
    if k == 1:
        cols, out_len = x.reshape(b * length, cin), length
    else:
        xpad = F.pad(x, (0, 0) + pads)
        out_len = xpad.shape[1] - pad
        cols = torch.cat(
            [xpad[:, t * dilation : t * dilation + out_len] for t in range(k)], dim=-1
        ).reshape(b * out_len, k * cin)
    y = matmul_int8w(cols.to(torch.bfloat16), w8, scale).reshape(b, out_len, -1)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _jax_layout_kernel(module: nn.Module) -> Optional[torch.Tensor]:
    """A conv module's weight as the JAX kernel (k, Cin, Cout), else None."""
    from jen1_tpu_torch.ops.conv import OmniConv1d, Upsample1d

    if isinstance(module, Upsample1d) and module.transposed:
        return module.weight.permute(2, 0, 1)  # (Cin, Cout, k)
    if isinstance(module, (OmniConv1d, Upsample1d)):
        return module.weight.permute(2, 1, 0)  # (Cout, Cin, k)
    if any(p.dim() == 3 for p in module.parameters(recurse=False)):
        raise ValueError(f"quantize_conv_params: no kernel layout for {type(module).__name__}")
    return None


@torch.no_grad()
def quantize_conv_params(
    model: nn.Module,
    *,
    min_weight_bytes: int = 4 << 20,
    min_weight_bytes_k1: int = 1 << 20,
) -> QWeights:
    """{module path: (kernel8 (k*Cin, Cout) int8, scale (Cout,) fp32)} for
    every conv kernel of `model` that the JAX rule selects
    (jen1_tpu/ops/int8_matmul.py:142-186): its bf16 bytes, numel * 2, are
    at least `min_weight_bytes` for k > 1 or `min_weight_bytes_k1` for
    k == 1. Strided convs and `Upsample1d` are selected too, as in JAX, and
    ignore their entry. Paths are the dotted module names that
    `ckpt/from_jax.py` uses, and the tensors lie on the weights' device."""
    out: QWeights = {}
    for path, module in model.named_modules():
        kern = _jax_layout_kernel(module)
        if kern is None:
            continue
        k, cin, cout = kern.shape
        thresh = min_weight_bytes_k1 if k == 1 else min_weight_bytes
        if kern.numel() * 2 >= thresh:
            out[path] = quantize_weight(kern.reshape(k * cin, cout))
    return out


def reads_qweights(module: nn.Module) -> bool:
    """Whether `module` runs the int8 path when given an entry: stride-1
    `OmniConv1d`s only (jen1_tpu/ops/conv.py:180)."""
    from jen1_tpu_torch.ops.conv import OmniConv1d

    return isinstance(module, OmniConv1d) and module.stride == 1


def attach_qweights(model: nn.Module, qweights: QWeights) -> int:
    """Give each stride-1 `OmniConv1d` named in `qweights` its int8 kernel
    and scale, on the module's device; entries of other modules are
    ignored, as in JAX. Returns the number of modules that read theirs."""
    attached = 0
    for path, (w8, scale) in qweights.items():
        module = model.get_submodule(path)
        if not reads_qweights(module):
            continue
        cout, cin, k = module.weight.shape
        if tuple(w8.shape) != (k * cin, cout) or tuple(scale.shape) != (cout,):
            raise ValueError(f"{path}: qweights {tuple(w8.shape)}, {tuple(scale.shape)} do "
                             f"not fit weight {tuple(module.weight.shape)}")
        dev = module.weight.device
        module.kernel8 = w8.to(dev, torch.int8).contiguous()
        module.scale = scale.to(dev, torch.float32).contiguous()
        attached += 1
    return attached


def clear_qweights(model: nn.Module) -> None:
    """Return every conv of `model` to its fp32 weight."""
    for module in model.modules():
        if reads_qweights(module):
            module.kernel8 = module.scale = None
