"""The tensor-core (bf16) routes of K1, K2 and K3, emulated on the CPU.

For bf16 inputs K1 (flash forward), K2 (dq) and K3 (dk/dv) run mma.sync
kernels (jen1_tpu_torch/csrc/flash_attention_{fwd,bwd}.cu), which run only
on the card (tests/test_torch_cuda.py, chip_smoke.py). Here the plain-PyTorch
emulation of their arithmetic in tests/torch_port_util.py (64-row / 64-key
tiles, the online-softmax rescale order, the bf16 hi + lo split of P, dS and
dS^T, fp32 sums, the final bf16 rounding) is held against the JAX Pallas
kernels in interpret mode on the same bf16 inputs, at the card's bars:
  O:          |diff| <= 1e-4 + 1e-2 |O_ref| elementwise (one bf16 step of a
              rounded fp32 result); lse: |diff| <= 1e-4;
  dq, dk, dv: |diff| <= 1e-4 max|ref| + 1e-2 |ref| elementwise.
The K2 and K3 tests share one Pallas forward + backward per case.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jen1_tpu.ops.flash_attention import _flash_backward, _flash_forward_lse
from jen1_tpu_torch.ops import flash_attention as fa
from torch_port_util import (
    flash_bwd_dkv_mma_emulation, flash_bwd_dq_mma_emulation, flash_fwd_mma_emulation, randn,
    rng,
)

BH = 2  # B = 1, H = 2


def bf16_inputs(n, d, seed, count):
    """`count` (1, BH, N, D) tensors drawn with numpy, rounded to bf16."""
    g = rng(seed)
    return [torch.from_numpy(randn(g, 1, BH, n, d)).to(torch.bfloat16) for _ in range(count)]


def to_jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


def to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def rows(t: torch.Tensor) -> torch.Tensor:
    """(1, BH, N, D) -> the kernels' (B*H, N, D)."""
    return t.reshape(BH, *t.shape[2:])


def jax_forward(q, k, v, causal):
    """Pallas `_flash_forward_lse` (interpret mode): O (1, BH, N, D) as
    fp32-held bf16 values and lse (BH, N)."""
    o, lse = jax.jit(lambda q, k, v: _flash_forward_lse(q, k, v, causal))(
        *map(to_jax, (q, k, v)))
    return to_torch(o), to_torch(lse)[:, : q.shape[2], 0]


def o_violation(o: torch.Tensor, ref: torch.Tensor) -> float:
    """max of |diff| / (1e-4 + 1e-2 |ref|): the bf16 O bar holds while <= 1."""
    return ((o.float() - ref).abs() / (1e-4 + 1e-2 * ref.abs())).max().item()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("n", [150, 563, 1125])
def test_k1_tensor_core_route_meets_the_card_bar(n, d, causal):
    q, k, v = bf16_inputs(n, d, seed=n + d, count=3)
    o_ref, lse_ref = jax_forward(q, k, v, causal)
    o, lse = flash_fwd_mma_emulation(rows(q), rows(k), rows(v), causal)
    assert o.dtype == torch.bfloat16 and lse.shape == (BH, n)
    assert o_violation(o, rows(o_ref)) <= 1.0
    assert (lse - lse_ref).abs().max().item() <= 1e-4


def test_k1_single_bf16_p_would_miss_the_bar():
    """Why P enters P V as bf16 hi + lo: with one bf16 copy of P the same
    emulation is off by several times the O bar at a short length."""
    n, d = 150, 16
    q, k, v = bf16_inputs(n, d, seed=n + d, count=3)
    o_ref = rows(jax_forward(q, k, v, False)[0])
    split, _ = flash_fwd_mma_emulation(rows(q), rows(k), rows(v), False)
    single, _ = flash_fwd_mma_emulation(rows(q), rows(k), rows(v), False, split=False)
    assert o_violation(split, o_ref) <= 1.0 < o_violation(single, o_ref)


@functools.lru_cache(maxsize=None)
def jax_backward(n, d, causal):
    """One Pallas forward + backward (interpret mode) per (n, d, causal),
    shared by the K2 and K3 tests: the bf16 inputs (B*H, N, D), lse and
    delta = rowsum(dO O) in fp32 as the wrapper computes it, and the
    reference (dq, dk, dv) (B*H, N, D) as fp32-held bf16 values."""
    q, k, v, do = bf16_inputs(n, d, seed=100 + n + d, count=4)

    def forward_backward(q, k, v, g):
        o, lse = _flash_forward_lse(q, k, v, causal)
        return o, lse, _flash_backward(q, k, v, o, lse, g, causal)

    o, lse, grads = jax.jit(forward_backward)(*map(to_jax, (q, k, v, do)))
    o, lse = to_torch(o), to_torch(lse)[:, :n, 0]
    delta = (do.float() * o).sum(-1).reshape(BH, n)
    return [rows(t) for t in (q, k, v, do)], lse, delta, [rows(to_torch(g)) for g in grads]


def grad_violation(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max of |diff| / (1e-4 max|ref| + 1e-2 |ref|): the bar holds while <= 1."""
    bar = 1e-4 * ref.abs().max() + 1e-2 * ref.abs()
    return ((out.float() - ref).abs() / bar).max().item()


GRAD_CASES = pytest.mark.parametrize("n,d,causal", [
    (n, d, causal) for n in (150, 563) for d in (16, 32) for causal in (False, True)])


@GRAD_CASES
def test_k2_tensor_core_route_meets_the_card_bar(n, d, causal):
    """dq from the forward's O and lse (both from the Pallas forward)."""
    inputs, lse, delta, (dq_ref, _, _) = jax_backward(n, d, causal)
    dq = flash_bwd_dq_mma_emulation(*inputs, lse, delta, causal)
    assert dq.dtype == torch.bfloat16
    assert grad_violation(dq, dq_ref) <= 1.0


def test_k2_single_bf16_ds_would_miss_the_bar():
    """Why dS enters dS K as bf16 hi + lo: with one bf16 copy of dS the same
    emulation is off by more than the dq bar."""
    inputs, lse, delta, (dq_ref, _, _) = jax_backward(150, 16, False)
    split = flash_bwd_dq_mma_emulation(*inputs, lse, delta, False)
    single = flash_bwd_dq_mma_emulation(*inputs, lse, delta, False, split=False)
    assert grad_violation(split, dq_ref) <= 1.0 < grad_violation(single, dq_ref)


@GRAD_CASES
def test_k3_tensor_core_route_meets_the_card_bar(n, d, causal):
    """dk and dv from the forward's O and lse (both from the Pallas
    forward), delta = rowsum(dO O) in fp32 as the wrapper computes it."""
    inputs, lse, delta, (_, dk_ref, dv_ref) = jax_backward(n, d, causal)
    dk, dv = flash_bwd_dkv_mma_emulation(*inputs, lse, delta, causal)
    for out, ref in ((dk, dk_ref), (dv, dv_ref)):
        assert out.dtype == torch.bfloat16
        assert grad_violation(out, ref) <= 1.0


@pytest.mark.parametrize("dtype,tensor_cores", [(torch.bfloat16, True), (torch.float32, False)])
def test_route_follows_the_dtype(dtype, tensor_cores):
    """bf16 takes K1's, K2's and K3's tensor-core kernels at every head dim
    the wrappers launch (16-256); fp32 keeps the scalar ones."""
    assert fa.tensor_core_route(dtype) is tensor_cores


def test_alignment_check_names_the_tensor_and_its_offset():
    """A bf16 view one element into its storage starts 2 bytes past a
    16-byte boundary; one eight elements in starts on one."""
    buf = torch.zeros(BH * 128 * 16 + 8, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    off_by_one = buf[1:1 + BH * 128 * 16].view(1, BH, 128, 16)
    with pytest.raises(ValueError, match=r"flash_attention_fwd: q starts 2 bytes past a "
                                         r"16-byte boundary.*cp\.async"):
        fa.check_aligned("flash_attention_fwd", [("q", off_by_one)])
    fa.check_aligned("flash_attention_fwd", [("q", buf[8:].view(1, BH, 128, 16))])
