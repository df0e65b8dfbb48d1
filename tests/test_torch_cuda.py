"""Card-only tests of jen1_tpu_torch's CUDA kernels (marker `cuda`).

They import neither JAX nor tests/conftest.py's setup, so on a machine with
an NVIDIA GPU and no JAX they run as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card each test skips (decided in the fixture, not at import). The
kernels are held against their plain versions at the bars of chip_smoke.py:
  * K1: O within 2e-3 in fp32 (tests/test_flash_attention.py's bar); O in
    bf16 within 1e-4 + 1e-2*|O_ref| elementwise, one bf16 rounding step,
    since both sides round an fp32 result; lse, fp32 for either input
    dtype, within 1e-4.
  * K2 / K3: dq, dk, dv elementwise within 1e-4*max|ref| in fp32 (the
    kernels and cuBLAS sum the same fp32 products in other orders), plus
    1e-2*|ref| in bf16 (one bf16 rounding step of each side's fp32 result).
"""

import pytest
import torch

from jen1_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

GRAD_ATOL_REL = 1e-4  # times max|ref| of the gradient compared
BF16_RTOL = 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def randn(device, shape, dtype, seed=0, n=3):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=device).to(dtype) for _ in range(n)]


def assert_grad_close(out, ref, dtype, what):
    diff = (out.float() - ref.float()).abs()
    bar = GRAD_ATOL_REL * ref.float().abs().max().item()
    if dtype == torch.bfloat16:
        bar = bar + BF16_RTOL * ref.float().abs()
    assert bool((diff <= bar).all()), f"{what}: max|diff| {diff.max().item():.3e}"


def check_backward(shape, dtype, causal, seed=0):
    """K2 and K3 against flash_attention_bwd_reference on the forward's
    (plain) O and lse."""
    q, k, v, do = randn("cuda", shape, dtype, seed, n=4)
    o, lse = fa.flash_attention_reference(q, k, v, causal)
    b, h, n, _ = shape
    delta = (do.float() * o.float()).sum(-1).reshape(b * h, n)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    refs = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    for name, out, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert out.dtype == dtype and out.shape == shape
        assert_grad_close(out, ref, dtype, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, causal):
    """The generation slice's shape: B=2 (CFG), H=8, N=1125, D=16."""
    q, k, v = randn(cuda_device, (2, 8, 1125, 16), dtype)
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    ro, rlse = fa.flash_attention_reference(q, k, v, causal)
    assert o.dtype == dtype and lse.shape == (16, 1125)
    diff = (o.float() - ro.float()).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 2e-3
    else:
        assert bool((diff <= 1e-4 + 1e-2 * ro.float().abs()).all()), diff.max().item()
    assert (lse - rlse).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_backward_kernels_match_plain_version(cuda_device, dtype, causal):
    """The training step's shape: B=4 (two tasks, CFG-doubled), H=8,
    N=1125, D=16."""
    check_backward((4, 8, 1125, 16), dtype, causal)


@pytest.mark.parametrize("d", [24, 96, 256])
def test_padded_head_dims(cuda_device, d):
    """Head dims the kernels do not instantiate are zero-padded by the
    wrappers; K1, K2 and K3 must still match their plain versions."""
    shape = (1, 2, 563, d)
    q, k, v = randn(cuda_device, shape, torch.float32, seed=d)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ro, rlse = fa.flash_attention_reference(q, k, v, causal=True)
    assert o.shape == shape
    assert (o - ro).abs().max().item() <= 2e-3
    assert (lse - rlse).abs().max().item() <= 1e-4
    check_backward(shape, torch.float32, causal=False, seed=d)


def test_dispatcher_launches_kernel_on_cuda(cuda_device, monkeypatch):
    """A CUDA tensor goes to the kernel, never to the plain version."""

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version was called on a CUDA tensor")

    q, k, v = randn(cuda_device, (1, 2, 256, 32), torch.bfloat16, seed=1)
    monkeypatch.setattr(fa, "flash_attention_reference", refuse)
    before = fa.LAUNCHES
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert out.shape == q.shape and fa.LAUNCHES == before + 1


def test_backward_on_cuda_matches_cpu(cuda_device, monkeypatch):
    """loss.backward() through flash_attention on the card launches K2 and
    K3 (never the plain backward) and gives the CPU path's gradients."""

    def refuse(*args, **kwargs):
        raise AssertionError("the plain backward was called on a CUDA tensor")

    g = torch.Generator().manual_seed(3)
    base = [torch.randn((2, 2, 300, 16), generator=g) for _ in range(4)]
    grads = {}
    for device in ("cpu", "cuda"):
        if device == "cuda":
            monkeypatch.setattr(fa, "flash_attention_bwd_reference", refuse)
        q, k, v = (t.detach().to(device).requires_grad_() for t in base[:3])
        out = fa.flash_attention(q, k, v, causal=True)
        before = (fa.LAUNCHES_DQ, fa.LAUNCHES_DKV)
        (out * base[3].to(device)).sum().backward()
        if device == "cuda":
            torch.cuda.synchronize()
            assert (fa.LAUNCHES_DQ, fa.LAUNCHES_DKV) == (before[0] + 1, before[1] + 1)
        grads[device] = [t.grad.cpu() for t in (q, k, v)]
    for name, out, ref in zip(("dq", "dk", "dv"), grads["cuda"], grads["cpu"]):
        assert_grad_close(out, ref, torch.float32, name)


def test_unsupported_head_dim_raises(cuda_device):
    """Above 256 there is no kernel to pad up to."""
    q, k, v = randn(cuda_device, (1, 1, 128, 264), torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 264"):
        fa.flash_attention_fwd(q, k, v)
