"""Port parity: jen1_tpu_torch flash-attention forward vs the Pallas kernel.

The JAX side is `_flash_forward_lse` / `flash_attention`, whose Pallas
kernel runs in interpret mode on the CPU; the port side is the kernel's
plain version (`flash_attention_reference`), which the dispatcher takes for
CPU tensors. O and the logsumexp are compared at rtol/atol 2e-3 (the fp32
bar of tests/test_flash_attention.py). The CUDA kernel itself is held
against the plain version on the card by tests/test_torch_cuda.py and by
chip_smoke.py.
"""

import jax
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

