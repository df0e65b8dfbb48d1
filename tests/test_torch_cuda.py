"""Card-only tests of jen1_tpu_torch's CUDA kernels (marker `cuda`).

They import neither JAX nor tests/conftest.py's setup, so on a machine with
an NVIDIA GPU and no JAX they run as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card each test skips (decided in the fixture, not at import). The
kernels are held against their plain versions at the bars of chip_smoke.py:
  * K1: O within 2e-3 in fp32 (tests/test_flash_attention.py's bar); O in
    bf16 within 1e-4 + 1e-2*|O_ref| elementwise, one bf16 rounding step,
    since both sides round an fp32 result; lse, fp32 for either input
    dtype, within 1e-4. bf16 runs K1's and K3's tensor-core route, fp32
    their scalar route.
  * K2 / K3: dq, dk, dv elementwise within 1e-4*max|ref| in fp32 (the
    kernels and cuBLAS sum the same fp32 products in other orders), plus
    1e-2*|ref| in bf16 (one bf16 rounding step of each side's fp32 result).
  * K4: elementwise within 1e-4*max|ref|: the kernel and the plain version
    sum the same exact products (bf16 x int8 fits an fp32) in other orders.
"""

import pytest
import torch

from jen1_tpu_torch.ops import flash_attention as fa
from jen1_tpu_torch.ops import int8_matmul as im

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


def check_forward(q, k, v, causal):
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    ro, rlse = fa.flash_attention_reference(q, k, v, causal)
    diff = (o.float() - ro.float()).abs()
    assert bool((diff <= 1e-4 + 1e-2 * ro.float().abs()).all()), diff.max().item()
    assert (lse - rlse).abs().max().item() <= 1e-4


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_tensor_core_route_head_dims(cuda_device, d, causal):
    """bf16 K1 and K3 at every head dim the kernels instantiate, at a
    length with a ragged tile, against their plain versions."""
    shape = (1, 2, 563, d)
    q, k, v = randn(cuda_device, shape, torch.bfloat16, seed=d)
    check_forward(q, k, v, causal)
    check_backward(shape, torch.bfloat16, causal, seed=d)


def test_tensor_core_route_counters(cuda_device):
    """bf16 at the slice shape (D = 16, N = 1125) takes K1's, K2's and K3's
    tensor-core route; fp32 takes the scalar one."""

    def counts():
        return (fa.LAUNCHES, fa.LAUNCHES_MMA, fa.LAUNCHES_DQ, fa.LAUNCHES_DQ_MMA,
                fa.LAUNCHES_DKV, fa.LAUNCHES_DKV_MMA)

    for dtype, want in ((torch.bfloat16, 1), (torch.float32, 0)):
        q, k, v, do = randn(cuda_device, (1, 2, 1125, 16), dtype, n=4)
        before = counts()
        o, lse = fa.flash_attention_fwd(q, k, v)
        delta = (do.float() * o.float()).sum(-1).reshape(2, 1125)
        fa.flash_attention_bwd_dq(q, k, v, do, lse, delta)
        fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(counts(), before)] == [1, want] * 3, dtype


def test_misaligned_tensor_refused(cuda_device):
    """A contiguous bf16 view one element into its storage (2-byte aligned)
    is refused before any launch: cp.async needs 16-byte alignment."""
    shape = (1, 2, 256, 16)
    numel = 2 * 256 * 16
    buf = torch.zeros(numel + 1, dtype=torch.bfloat16, device=cuda_device)
    q = buf[1:].view(shape)
    k, v = randn(cuda_device, shape, torch.bfloat16, n=2)
    assert q.is_contiguous() and q.data_ptr() % 16 == 2
    before = fa.LAUNCHES
    with pytest.raises(ValueError, match="q starts 2 bytes past a 16-byte boundary"):
        fa.flash_attention_fwd(q, k, v)
    lse = torch.zeros((2, 256), device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_bwd_dkv(q, k, v, k, lse, lse)
    dq_before = fa.LAUNCHES_DQ
    with pytest.raises(ValueError, match="flash_attention_bwd_dq: q starts 2 bytes past"):
        fa.flash_attention_bwd_dq(q, k, v, k, lse, lse)
    assert fa.LAUNCHES == before and fa.LAUNCHES_DQ == dq_before


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


def int8_inputs(device, m, k, n, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=g).to(dtype)
    w8, scale = im.quantize_weight(torch.randn((k, n), generator=g) * 0.05)
    return x.to(device), w8.to(device), scale.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(10, 3072, 1024), (130, 96, 72), (72, 1024, 512),
                                   (2, 65536, 32), (3, 40000, 24)])
def test_int8_kernel_matches_plain_version(cuda_device, m, k, n, dtype):
    """Flagship shapes (a CFG-doubled deep-level project; M > 16 over three
    row tiles), a ragged one, and two whose K needs several passes over x
    (the second with N % 16 != 0, so its weights take ordinary loads)."""
    x, w8, scale = int8_inputs(cuda_device, m, k, n, dtype)
    out = im.matmul_int8w_cuda(x, w8, scale)
    torch.cuda.synchronize()
    ref = im.matmul_int8w_plain(x, w8, scale)
    assert out.shape == (m, n) and out.dtype == torch.float32
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def test_int8_misaligned_weights_refused(cuda_device):
    """A contiguous w8 view one byte into its storage is refused before any
    launch: K4 streams the weights by cp.async, which needs 16 bytes."""
    x, w8, scale = int8_inputs(cuda_device, 6, 1024, 1024, torch.bfloat16)
    buf = torch.zeros(w8.numel() + 16, dtype=torch.int8, device=cuda_device)
    view = buf[1:1 + w8.numel()].view(w8.shape)
    view.copy_(w8)
    before = im.LAUNCHES
    with pytest.raises(ValueError, match="w8 starts 1 bytes past a 16-byte boundary"):
        im.matmul_int8w_cuda(x, view, scale)
    assert im.LAUNCHES == before


def test_int8_dispatcher_launches_kernel_on_cuda(cuda_device, monkeypatch):
    """A CUDA tensor goes to K4, never to the plain version."""

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version was called on a CUDA tensor")

    x, w8, scale = int8_inputs(cuda_device, 6, 1024, 1024, torch.bfloat16, seed=1)
    monkeypatch.setattr(im, "matmul_int8w_plain", refuse)
    before = im.LAUNCHES
    out = im.matmul_int8w(x, w8, scale)
    torch.cuda.synchronize()
    assert out.shape == (6, 1024) and im.LAUNCHES == before + 1


@pytest.mark.parametrize("causal", [False, True])
def test_quantized_conv_on_cuda_matches_cpu(cuda_device, causal):
    """A quantized stride-1 OmniConv1d (k = 3, dilation 2) on the card
    gives the CPU's output, through K4."""
    from jen1_tpu_torch.ops.conv import OmniConv1d
    from jen1_tpu_torch.ops.initializers import init_module

    conv = OmniConv1d(96, 64, kernel_size=3, dilation=2)
    init_module(conv, torch.Generator().manual_seed(2))
    im.attach_qweights(conv, im.quantize_conv_params(conv, min_weight_bytes=0))
    x = torch.randn((2, 37, 96), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        ref = conv(x, causal=causal)
        conv.to(cuda_device)
        before = im.LAUNCHES
        out = conv(x.to(cuda_device), causal=causal)
        torch.cuda.synchronize()
    assert im.LAUNCHES == before + 1 and conv.kernel8.is_cuda
    assert (out.cpu() - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
