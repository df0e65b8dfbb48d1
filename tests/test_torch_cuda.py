"""Card-only tests of jen1_tpu_torch's CUDA kernels (marker `cuda`).

They import neither JAX nor tests/conftest.py's setup, so on a machine with
an NVIDIA GPU and no JAX they run as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card each test skips (decided in the fixture, not at import). The
kernel is held against its plain version at the bars of chip_smoke.py: O
within 2e-3 in fp32 (tests/test_flash_attention.py's bar); O in bf16 within
1e-4 + 1e-2*|O_ref| elementwise, one bf16 rounding step, since both sides
round an fp32 result; lse, fp32 for either input dtype, within 1e-4.
"""

import pytest
import torch

from jen1_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def qkv(device, shape, dtype, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=device).to(dtype) for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, causal):
    """The generation slice's shape: B=2 (CFG), H=8, N=1125, D=16."""
    q, k, v = qkv(cuda_device, (2, 8, 1125, 16), dtype)
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


def test_dispatcher_launches_kernel_on_cuda(cuda_device, monkeypatch):
    """A CUDA tensor goes to the kernel, never to the plain version."""

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version was called on a CUDA tensor")

    q, k, v = qkv(cuda_device, (1, 2, 256, 32), torch.bfloat16, seed=1)
    monkeypatch.setattr(fa, "flash_attention_reference", refuse)
    before = fa.LAUNCHES
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert out.shape == q.shape and fa.LAUNCHES == before + 1


def test_unsupported_head_dim_raises(cuda_device):
    q, k, v = qkv(cuda_device, (1, 1, 128, 48), torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 48"):
        fa.flash_attention_fwd(q, k, v)
