"""Port parity: jen1_tpu_torch flash-attention forward vs the Pallas kernel.

The JAX side is `_flash_forward_lse` / `flash_attention`, whose Pallas
kernel runs in interpret mode on the CPU; the port side is the kernel's
plain version (`flash_attention_reference`), which the dispatcher takes for
CPU tensors. O and the logsumexp are compared at rtol/atol 2e-3 (the fp32
bar of tests/test_flash_attention.py). The CUDA kernel itself is held
against the plain version on the card by tests/test_torch_cuda.py and by
chip_smoke.py.

The gradients of the port's autograd Function (plain backward) are held
against jax.grad through the Pallas backward kernels (interpret mode) at
rtol/atol 5e-3, the bar of tests/test_flash_attention.py:64-98.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jen1_tpu.ops.flash_attention import _flash_forward_lse, flash_attention as jax_flash
from jen1_tpu_torch.ops import flash_attention as fa
from torch_port_util import assert_close, randn, rng

BAR = dict(rtol=2e-3, atol=2e-3)


def qkv(n, d, seed, b=1, h=2):
    g = rng(seed)
    return [randn(g, b, h, n, d) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n,d", [(150, 16), (563, 32), (150, 32)])
def test_forward_and_lse_match_pallas(n, d, causal):
    """Lengths that divide no block size (the kernel masks its ragged edge)."""
    q, k, v = qkv(n, d, seed=n + d)
    o_ref, lse_ref = jax.jit(lambda q, k, v: _flash_forward_lse(q, k, v, causal))(q, k, v)
    o, lse = fa.flash_attention_reference(*map(torch.from_numpy, (q, k, v)), causal)
    assert o.shape == (1, 2, n, d) and lse.shape == (2, n)
    assert_close(o, o_ref, **BAR)
    assert_close(lse, np.asarray(lse_ref)[:, :n, 0], **BAR)


def test_multi_qblock_causal():
    """N = 1024 runs the Pallas kernel with two q blocks of 512."""
    q, k, v = qkv(1024, 32, seed=7)
    ref = jax.jit(lambda q, k, v: jax_flash(q, k, v, True))(q, k, v)
    out = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    assert_close(out, ref, **BAR)


def test_dispatch_on_cpu_takes_plain_version():
    q, k, v = map(torch.from_numpy, qkv(256, 16, seed=1))
    before = fa.LAUNCHES
    out = fa.flash_attention(q, k, v)
    assert torch.equal(out, fa.flash_attention_reference(q, k, v)[0])
    assert fa.LAUNCHES == before


def test_unsupported_shapes_fall_back_like_jax():
    """N < 128 takes dot_product_attention in both packages."""
    q, k, v = qkv(100, 16, seed=2)
    assert not fa.flash_attention_supported(100, 16)
    assert fa.flash_attention_supported(4500, 256)
    assert not fa.flash_attention_supported(4500, 257)
    ref = jax_flash(q, k, v, False)
    assert_close(fa.flash_attention(*map(torch.from_numpy, (q, k, v))), ref, **BAR)


def test_kernel_wrapper_rejects_cpu_tensors():
    """The CUDA wrapper never falls back: a CPU tensor raises."""
    q, k, v = map(torch.from_numpy, qkv(128, 16, seed=3))
    with pytest.raises(ValueError, match="not CUDA"):
        fa.flash_attention_fwd(q, k, v)


# Gradient bar of the Pallas backward against XLA (tests/test_flash_attention.py:64-98).
GRAD_BAR = dict(rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "n,d", [(150, 16), (150, 32), (563, 16), (563, 32), (1024, 16), (1024, 32), (150, 24)]
)
def test_gradients_match_pallas_backward(n, d, causal):
    """dq, dk, dv of the port's autograd Function (plain backward on the CPU)
    against jax.grad of the JAX flash_attention, whose custom_vjp runs the
    Pallas backward kernels in interpret mode. N = 150 and 563 leave ragged
    tiles; N = 1024 has several q and k blocks; D = 24 is a head dim the
    CUDA wrappers zero-pad."""
    q, k, v = qkv(n, d, seed=100 + n + d)
    g = randn(rng(n * d), 1, 2, n, d)
    ref = jax.jit(jax.grad(
        lambda q, k, v: jnp.sum(jax_flash(q, k, v, causal) * g), argnums=(0, 1, 2)
    ))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (fa.flash_attention(tq, tk, tv, causal=causal) * torch.from_numpy(g)).sum().backward()
    for port, r in zip((tq.grad, tk.grad, tv.grad), ref):
        assert_close(port, r, **GRAD_BAR)


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_reference_equals_autograd_of_plain_forward(causal):
    """flash_attention_bwd_reference (P = exp(S - lse) from the forward's
    lse) is the gradient of flash_attention_reference's O."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in qkv(150, 16, seed=9))
    do = torch.from_numpy(randn(rng(10), 1, 2, 150, 16))
    o, lse = fa.flash_attention_reference(q, k, v, causal)
    auto = torch.autograd.grad(o, (q, k, v), do)
    ours = fa.flash_attention_bwd_reference(q, k, v, o.detach(), lse.detach(), do, causal)
    for a, b in zip(ours, auto):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("d,dp", [(24, 32), (96, 128), (200, 256)])
def test_zero_padding_is_exact(d, dp):
    """What the CUDA wrappers do for head dims without a kernel: zero-pad q,
    k, v and dO to the next supported D, pass the unpadded D^-1/2, slice
    the outputs back. Checked on the plain versions."""
    assert fa.kernel_head_dim(d) == dp
    q, k, v, do = (torch.from_numpy(randn(rng(d + i), 1, 2, 150, d)) for i in range(4))
    o, lse = fa.flash_attention_reference(q, k, v, True)
    pad = [fa._pad_head_dim(t, dp) for t in (q, k, v, do)]
    op, lsep = fa.flash_attention_reference(*pad[:3], True, sm_scale=d**-0.5)
    torch.testing.assert_close(op[..., :d], o, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lsep, lse, rtol=1e-5, atol=1e-6)
    grads = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, True)
    grads_p = fa.flash_attention_bwd_reference(*pad[:3], op, lsep, pad[3], True, sm_scale=d**-0.5)
    for a, b in zip(grads_p, grads):
        torch.testing.assert_close(fa._unpad(a, d), b, rtol=1e-5, atol=1e-5)


def test_head_dim_above_256_has_no_kernel():
    with pytest.raises(ValueError, match="head dim 257"):
        fa.kernel_head_dim(257)
