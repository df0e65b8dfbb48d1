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


# -------------------------------------------- training and the tasks slice

TINY_CODEC = dict(sample_rate=1600, channels=2, dimension=8, n_filters=2, ratios=(5, 4, 2),
                  n_q=2, bins=16)
GRAD_LEAF_BAR, GRAD_LEAF_FLOOR = 5e-3, 1e-5


class Coin:
    """The trainer's host stream, fixed to one value."""

    def __init__(self, value):
        self.value = value

    def integers(self, lo, hi):
        return self.value


def test_fp32_train_step_with_tf32_defaults_matches_cpu(cuda_device):
    """An fp32 tiny_test_config() train step on the card with cuDNN's TF32
    flag at its default (True) and cuBLAS's turned on too (the override of
    the `cuda_device` fixture undone for this test): the trainer runs its
    forward and backward without TF32, so losses and gradients meet the
    train bars against the CPU (losses rtol 2e-3; every gradient leaf
    within 5e-3 * max|g_ref| of the leaf, floored at 1e-5 of the largest
    leaf's)."""
    import dataclasses

    import numpy as np

    from jen1_tpu_torch.config import tiny_test_config
    from jen1_tpu_torch.train.train import build_trainer
    from jen1_tpu_torch.train.trainer import StepDraws, step_generator

    cfg = tiny_test_config()
    t5c = cfg.conditioner_config.t5_config
    t5c.t5_model_name, t5c.max_length = "tiny-test", cfg.model_config.context_embedding_max_length
    mc = cfg.model_config
    g = np.random.default_rng(0)
    m = mc.context_embedding_max_length
    host = {"latents": g.standard_normal((3, 96, mc.in_channels)).astype(np.float32),
            "text_emb": g.standard_normal((3, m, mc.context_embedding_features)
                                          ).astype(np.float32),
            "text_mask": np.ones((3, m), bool)}
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        cpu, card = build_trainer(cfg, device="cpu"), build_trainer(cfg, device="cuda")
        card.model.load_state_dict(cpu.model.state_dict())
        draws = cpu.draw_randoms(step_generator("cpu", 0, 0), cpu._causal_flags(Coin(0)),
                                 host["latents"].shape)
        moved = StepDraws(*[{k: v.to("cuda") if torch.is_tensor(v) else v
                             for k, v in getattr(draws, f.name).items()}
                            for f in dataclasses.fields(StepDraws)])
        cpu.draw_randoms = lambda *a: draws
        card.draw_randoms = lambda *a: moved
        metrics = {}
        for name, tr in (("cpu", cpu), ("card", card)):
            batch = {k: torch.as_tensor(v, device=tr.device) for k, v in host.items()}
            _, mt = tr.train_step(tr.init_state(), batch, None, Coin(0))
            metrics[name] = {k: float(v) for k, v in mt.items()}
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (
            True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    for k, ref in metrics["cpu"].items():
        if k.startswith("loss"):
            assert abs(metrics["card"][k] - ref) <= 2e-3 * abs(ref), k
    refs = [p.grad for p in cpu.model.parameters()]
    floor = GRAD_LEAF_FLOOR * max(r.abs().max().item() for r in refs)
    for (name, p), ref in zip(card.model.named_parameters(), refs):
        bar = GRAD_LEAF_BAR * max(ref.abs().max().item(), floor)
        assert (p.grad.cpu() - ref).abs().max().item() <= bar, name


def tiny_codecs():
    """The tiny codec on the CPU and on the card with the same weights."""
    from jen1_tpu_torch.codec.model import EncodecConfig, EncodecModel

    cpu = EncodecModel(EncodecConfig(**TINY_CODEC), device="cpu").eval()
    card = EncodecModel(EncodecConfig(**TINY_CODEC), device="cuda").eval()
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def test_codec_encode_on_cuda_matches_cpu(cuda_device):
    """The SEANet encoder (whole clip), the chunked encode (520 frames, four
    chunks) and the segmented encode on the card against the CPU at 1e-4,
    and the RVQ codes of one latent equal on both (its nearest entries at
    least 1e-3 closer than the second nearest)."""
    import numpy as np

    cpu, card = tiny_codecs()
    g = np.random.default_rng(4)
    t = np.arange(520 * 40 + 13) / 1600
    audio = (0.3 * np.sin(2 * np.pi * np.array([220.0, 330.0]) * t[:, None])
             + 0.05 * g.standard_normal((len(t), 2))).astype(np.float32)[None]
    x = torch.from_numpy(audio)
    for name, kw in (("encode_latent", dict(quantize=False)), ("encode_latent", {}),
                     ("encode_latent_chunked", {}), ("encode_latent_segmented", {})):
        ref = getattr(cpu, name)(x, **kw)
        out = getattr(card, name)(x.to(cuda_device), **kw).cpu()
        assert out.shape == ref.shape, name
        assert ((out - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all(), (name, kw)
    z = cpu.encode_latent_chunked(x, quantize=False)
    residual = z
    for i in range(cpu.quantizer.n_q):
        d = cpu.quantizer.distances(residual, i)
        two = d.topk(2, dim=-1, largest=False).values
        assert (two[..., 1] - two[..., 0]).min().item() > 1e-3
        residual = residual - cpu.quantizer.codebooks[i][d.argmin(-1)]
    codes = cpu.quantizer.encode(z)
    assert torch.equal(card.quantizer.encode(z.to(cuda_device)).cpu(), codes)


def tiny_jen1s():
    """{"cpu": Jen1, "cuda": Jen1} of tiny_test_config widths (one head,
    flash_min_seq_len 128) with the same UNet, T5 and codec weights."""
    import dataclasses

    from jen1_tpu_torch.api.generation import Jen1
    from jen1_tpu_torch.conditioning.conditioners import MultiConditioner, T5Conditioner
    from jen1_tpu_torch.config import tiny_test_config

    cfg = tiny_test_config()
    cfg.model_config = dataclasses.replace(
        cfg.model_config, use_flash_attention=True, flash_min_seq_len=128, attention_heads=1)
    jen1 = {}
    for dev, codec in zip(("cpu", "cuda"), tiny_codecs()):
        t5 = T5Conditioner(16, "tiny-test", cfg.model_config.context_embedding_max_length,
                           device=dev)
        jen1[dev] = Jen1(sample_rate=1600, config=cfg, codec=codec,
                         conditioner=MultiConditioner({"prompt": t5}), device=dev)
    jen1["cuda"].model.load_state_dict(jen1["cpu"].model.state_dict())
    jen1["cuda"].conditioner.conditioners["prompt"].load_state_dict(
        jen1["cpu"].conditioner.conditioners["prompt"].state_dict())
    return jen1


def test_generate_music_cont_on_cuda_matches_cpu(cuda_device, monkeypatch):
    """A tiny Jen1 (tiny_test_config widths, one head, flash_min_seq_len 128)
    continues the first 6 s of a 13 s clip on the card and on the CPU with
    the same weights and x_T: rtol 2e-2 / atol 2e-3, and every K1 launch of
    the card's level-1 attention is causal (fp32, so the scalar route)."""
    import numpy as np

    from jen1_tpu_torch.diffusion import vdm

    jen1 = tiny_jen1s()
    x_t = torch.randn((1, 520, 8), generator=torch.Generator().manual_seed(7))
    monkeypatch.setattr(vdm, "initial_noise", lambda shape, generator, device: x_t.to(device))
    g = np.random.default_rng(5)
    clip = (0.3 * np.sin(np.arange(6 * 1600)[:, None] * np.array([0.7, 1.1]))
            + 0.05 * g.standard_normal((6 * 1600, 2))).astype(np.float32)
    kw = dict(seed=5, steps=4, seconds=13, task="music_cont", init_audio=clip)
    ref = jen1["cpu"].generate("a beautiful song", **kw)
    before = (fa.LAUNCHES, fa.LAUNCHES_CAUSAL)
    out = jen1["cuda"].generate("a beautiful song", **kw)
    launched = (fa.LAUNCHES - before[0], fa.LAUNCHES_CAUSAL - before[1])
    assert out.shape == ref.shape == (1, 2, 13 * 1600) and np.isfinite(out).all()
    assert np.allclose(out, ref, rtol=2e-2, atol=2e-3), float(np.abs(out - ref).max())
    assert launched[0] > 0 and launched[1] == launched[0]


@pytest.mark.parametrize("mode", ["scan", "dpm++"])
def test_encoder_reuse_on_cuda_matches_cpu(cuda_device, monkeypatch, mode):
    """GDM with encoder_reuse=2 over 5 steps of the tiny Jen1 (13 s, 520
    latent frames) on the card against the CPU, the same x_T and step
    noise: rtol 2e-2 / atol 2e-3; K1 runs twice per whole UNet forward and
    once per decoder-only one (DDIM: 3 whole, 2 decoder-only; DPM-Solver++:
    3 and 2 as well, its fifth step a remainder step)."""
    import numpy as np

    from jen1_tpu_torch.diffusion import gdm

    jen1 = tiny_jen1s()
    stream = torch.Generator().manual_seed(7)
    x_t = torch.randn((1, 520, 8), generator=stream)
    noises = [torch.randn((1, 520, 8), generator=stream) for _ in range(5)]
    monkeypatch.setattr(gdm, "initial_noise", lambda shape, generator, device: x_t.to(device))
    monkeypatch.setattr(gdm, "step_noise",
                        lambda x, generator, index, uniform=False: noises[index].to(x.device))
    kw = dict(seed=5, steps=5, seconds=13, use_gdm=True, sampler_mode=mode, encoder_reuse=2)
    ref = jen1["cpu"].generate("a beautiful song", **kw)
    before = fa.LAUNCHES
    out = jen1["cuda"].generate("a beautiful song", **kw)
    whole = gdm.reuse_schedule(5, 2, final_full=mode == "scan")
    assert fa.LAUNCHES - before == 2 * sum(whole) + (5 - sum(whole)) == 8
    assert out.shape == ref.shape == (1, 2, 13 * 1600) and np.isfinite(out).all()
    assert np.allclose(out, ref, rtol=2e-2, atol=2e-3), float(np.abs(out - ref).max())


def test_service_round_trip_on_cuda(cuda_device):
    """The tiny card Jen1 behind GenerationService: a seeded request comes
    back as a host array equal, bit for bit, to lane 0 of generate() with
    the same padded prompts and seed; the padding lanes are dropped."""
    import numpy as np

    from jen1_tpu_torch.serve import GenerationService

    card = tiny_jen1s()["cuda"]
    svc = GenerationService(card, max_batch=3, max_wait_ms=5.0, default_seconds=2.0,
                            default_steps=3)
    try:
        audio = svc.submit("seeded tune", seed=41, timeout=600)
    finally:
        svc.close()
    direct = card.generate(["seeded tune", "", ""], seed=41, steps=3, batch_size=3,
                           seconds=2.0, use_gdm=True)
    assert isinstance(audio, np.ndarray) and audio.shape == (2, 3200)
    np.testing.assert_array_equal(audio, direct[0])
    assert svc.stats["padded_lanes"] == 2 and svc.stats["errors"] == 0


def test_lora_step_on_cuda_matches_cpu(cuda_device):
    """A tiny LoRATrainer step (rank 4, default targets; L = 520, so the
    level-1 attention of 130 frames runs K1 and, in the backward, K2/K3
    with the adapter's gradient flowing through the merged to_q / to_kv /
    to_out weights) on the card against the CPU with the same base, adapter
    and draws: losses and every adapter gradient leaf at the train bars;
    the card's base unchanged and without gradients."""
    import dataclasses

    import numpy as np

    from jen1_tpu_torch.config import tiny_test_config
    from jen1_tpu_torch.train.train import build_trainer
    from jen1_tpu_torch.train.trainer import StepDraws, step_generator

    cfg = tiny_test_config()
    cfg.model_config = dataclasses.replace(cfg.model_config, use_flash_attention=True,
                                           flash_min_seq_len=128)
    t5c = cfg.conditioner_config.t5_config
    t5c.t5_model_name, t5c.max_length = "tiny-test", cfg.model_config.context_embedding_max_length
    cfg.lora_config.rank, cfg.lora_config.alpha = 4, 8.0
    mc = cfg.model_config
    g = np.random.default_rng(1)
    m = mc.context_embedding_max_length
    host = {"latents": g.standard_normal((3, 520, mc.in_channels)).astype(np.float32),
            "text_emb": g.standard_normal((3, m, mc.context_embedding_features)
                                          ).astype(np.float32),
            "text_mask": np.ones((3, m), bool)}
    cpu, card = build_trainer(cfg, device="cpu"), build_trainer(cfg, device="cuda")
    card.model.load_state_dict(cpu.model.state_dict())
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for path, ab in cpu.adapter.items():
            ab["b"].copy_(0.05 * torch.randn(ab["b"].shape, generator=gen))
            for key in ("a", "b"):
                card.adapter[path][key].copy_(ab[key])
    base = [p.detach().clone() for p in card.model.parameters()]
    draws = cpu.draw_randoms(step_generator("cpu", 0, 1), cpu._causal_flags(Coin(1)),
                             host["latents"].shape)
    moved = StepDraws(*[{k: v.to("cuda") if torch.is_tensor(v) else v
                         for k, v in getattr(draws, f.name).items()}
                        for f in dataclasses.fields(StepDraws)])
    cpu.draw_randoms = lambda *a: draws
    card.draw_randoms = lambda *a: moved
    metrics = {}
    before = (fa.LAUNCHES, fa.LAUNCHES_DQ, fa.LAUNCHES_DKV)
    for name, tr in (("cpu", cpu), ("card", card)):
        batch = {k: torch.as_tensor(v, device=tr.device) for k, v in host.items()}
        _, mt = tr.train_step(tr.init_state(), batch, None, Coin(1))
        metrics[name] = {k: float(v) for k, v in mt.items()}
    launched = (fa.LAUNCHES - before[0], fa.LAUNCHES_DQ - before[1], fa.LAUNCHES_DKV - before[2])
    assert min(launched) > 0, launched
    for k, ref in metrics["cpu"].items():
        if k.startswith("loss"):
            assert abs(metrics["card"][k] - ref) <= 2e-3 * abs(ref), k
    refs = [p.grad for p in cpu.params]
    floor = GRAD_LEAF_FLOOR * max(r.abs().max().item() for r in refs)
    for name, p, ref in zip(card._names(), card.params, refs):
        bar = GRAD_LEAF_BAR * max(ref.abs().max().item(), floor)
        assert (p.grad.cpu() - ref).abs().max().item() <= bar, name
    level1 = [p.grad for n, p in zip(card._names(), card.params)
              if "downsample1.transformer" in n and ".attention." in n]
    assert level1 and all(bool((g != 0).any()) for g in level1)
    assert all(torch.equal(a, p) and p.grad is None
               for a, p in zip(base, card.model.parameters()))


def test_generate_tracks_on_cuda_matches_cpu(cuda_device, monkeypatch):
    """A tiny Composer Jen1 (tiny_composer_test_config(2), 4-dim tracks,
    flash_min_seq_len 128) generates 13 s with track 0 given as a clip, GDM
    DDIM over 4 steps, on the card and on the CPU with the same weights,
    x_T and step noise: rtol 2e-2 / atol 2e-3, and K1 runs on the card."""
    import dataclasses

    import numpy as np

    from jen1_tpu_torch.api.generation import Jen1
    from jen1_tpu_torch.codec.model import EncodecConfig, EncodecModel
    from jen1_tpu_torch.conditioning.conditioners import MultiConditioner, T5Conditioner
    from jen1_tpu_torch.config import tiny_composer_test_config
    from jen1_tpu_torch.diffusion import gdm

    cfg = tiny_composer_test_config(2)
    cfg.model_config = dataclasses.replace(cfg.model_config, use_flash_attention=True,
                                           flash_min_seq_len=128)
    jen1 = {}
    for device in ("cpu", "cuda"):
        t5 = T5Conditioner(16, "tiny-test", cfg.model_config.context_embedding_max_length,
                           device=device)
        jen1[device] = Jen1(sample_rate=1600, config=cfg, device=device,
                            codec=EncodecModel(EncodecConfig(**dict(TINY_CODEC, dimension=4)),
                                               device=device).eval(),
                            conditioner=MultiConditioner({"prompt": t5}))
    for part in ("model", "codec"):
        getattr(jen1["cuda"], part).load_state_dict(getattr(jen1["cpu"], part).state_dict())
    jen1["cuda"].conditioner.conditioners["prompt"].load_state_dict(
        jen1["cpu"].conditioner.conditioners["prompt"].state_dict())
    stream = torch.Generator().manual_seed(4)
    x_t = torch.randn((1, 520, 8), generator=stream)
    noises = [torch.randn((1, 520, 8), generator=stream) for _ in range(4)]
    monkeypatch.setattr(gdm, "initial_noise", lambda shape, generator, device: x_t.to(device))
    monkeypatch.setattr(gdm, "step_noise", lambda x, generator, index, uniform=False:
                        noises[index].to(x.device))
    g = np.random.default_rng(6)
    clip = (0.3 * np.sin(np.arange(13 * 1600)[:, None] * np.array([0.5, 0.9]))
            + 0.05 * g.standard_normal((13 * 1600, 2))).astype(np.float32)
    kw = dict(seed=3, steps=4, seconds=13, context_tracks={0: clip})
    ref = jen1["cpu"].generate_tracks("two stems", **kw)
    before = fa.LAUNCHES
    out = jen1["cuda"].generate_tracks("two stems", **kw)
    assert fa.LAUNCHES > before
    assert out.shape == ref.shape == (1, 2, 2, 13 * 1600) and np.isfinite(out).all()
    assert np.allclose(out, ref, rtol=2e-2, atol=2e-3), float(np.abs(out - ref).max())


def test_snake_on_cuda_matches_cpu(cuda_device):
    """snake() in fp32 (rtol 1e-6) and bf16 (one bf16 step, rtol 2^-7)."""
    from jen1_tpu_torch.ops.snake import snake

    g = torch.Generator().manual_seed(3)
    x = 3.0 * torch.randn((2, 64, 16), generator=g)
    alpha = torch.rand(16, generator=g) + 0.5
    for dtype, rtol in ((torch.float32, 1e-6), (torch.bfloat16, 2**-7)):
        ref = snake(x.to(dtype), alpha)
        out = snake(x.to(dtype).cuda(), alpha.cuda())
        assert out.dtype == dtype
        assert torch.allclose(out.float().cpu(), ref.float(), rtol=rtol, atol=1e-6)


def test_stft_on_cuda_matches_cpu_dc_sign_included(cuda_device):
    """STFT encode on the card: the DC phase of frames with a negative DC
    component is +pi as on the CPU (and in JAX), the magnitude within 1e-4
    of the largest; decode1d back to the wave within 1e-5 of its peak."""
    from jen1_tpu_torch.ops.stft import STFT

    g = torch.Generator().manual_seed(4)
    wave = 0.3 * torch.randn((1, 2, 24_000), generator=g) + torch.tensor([-1.0, 1.0])[:, None]
    stft = STFT()
    mag, phase = stft.encode(wave)
    mag_g, phase_g = stft.encode(wave.cuda())
    assert (phase[:, 0, 0] == torch.pi).all()
    assert torch.equal(phase_g[:, :, 0].cpu(), phase[:, :, 0])
    assert torch.allclose(mag_g.cpu(), mag, rtol=1e-4, atol=1e-4 * mag.abs().max().item())
    back = stft.decode1d(stft.encode1d(wave.cuda()), length=wave.shape[-1]).cpu()
    assert (back - wave).abs().max().item() <= 1e-5 * wave.abs().max().item()


def test_stft_snake_unet_on_cuda_matches_cpu(cuda_device):
    """A tiny UNetCFG1d with use_snake, use_stft and use_stft_context,
    fp32: card against CPU at the plain-forward bar (rtol 2e-3, atol 2e-4)."""
    import dataclasses

    from jen1_tpu_torch.config import tiny_test_config
    from jen1_tpu_torch.models.unet import unet_from_model_config
    from jen1_tpu_torch.ops.conv import fp32_precision
    from jen1_tpu_torch.ops.initializers import init_module

    mc = dataclasses.replace(tiny_test_config().model_config, in_channels=2, out_channels=2,
                             context_channels=(3,), use_snake=True, use_stft=True,
                             use_stft_context=True, stft_num_fft=63, stft_hop_length=16)
    cpu = init_module(unet_from_model_config(mc), torch.Generator().manual_seed(5)).eval()
    card = unet_from_model_config(mc).to("cuda").eval()
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(6)
    x, t = torch.randn((2, 1008, 2), generator=g) - 1.0, torch.rand((2,), generator=g)
    emb, ctx = torch.randn((2, 6, 16), generator=g), torch.randn((2, 1008, 3), generator=g)
    with torch.no_grad(), fp32_precision():
        ref = cpu(x, t, embedding=emb, channels_list=[ctx])
        out = card(x.cuda(), t.cuda(), embedding=emb.cuda(), channels_list=[ctx.cuda()])
    assert out.shape == x.shape
    assert torch.allclose(out.cpu(), ref, rtol=2e-3, atol=2e-4)
