#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (`jen1_tpu_torch`) on one card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
  1. device      - require CUDA; print the card's name, count and power limit.
  2. build       - build the kernel library from jen1_tpu_torch/csrc (one
                   nvcc per source, in parallel) and print its `-Xptxas -v`
                   register and shared-memory use.
  3. kernels     - K1 (flash forward), K2 (dq) and K3 (dk, dv) against their
                   plain PyTorch versions over N x D x dtype x causal, padded
                   head dims included, with the stated bars; what a dropped
                   ragged tile would shift; K1 timed at the generation shape,
                   K2/K3 at the training shapes, beside their plain versions,
                   their bounds and the SDPA yardsticks. K4 (int8 weight-only
                   matmul) against its plain version at every int8 shape of
                   the flagship preset and at ragged shapes, x in bf16 and
                   fp32; what a dropped final K tile or a bf16 dequantize
                   before the product would shift; K4 timed per flagship
                   shape with its weights cold in L2, beside its plain
                   version, its bound and a bf16 torch.matmul yardstick.
  4. small       - the generation slice (T5, VDM + UNetCFG1d with its flash
                   path, chunked decode) at tiny widths, on the card against
                   the CPU with the same weights and the same initial noise.
  5. small-gdm   - the same tiny slice with use_gdm=True (DDIM and
                   DPM-Solver++, 4 steps), on the card against the CPU, with
                   fp32 weights and with every UNet conv quantized
                   (thresholds 0), the same x_T and step noise on both.
  6. small-train - one train step of a tiny trainer on the card against the
                   CPU (same weights, batch and draws), both causal variants:
                   per-task losses and every gradient leaf.
  7. main        - Jen1(longform_config()).generate(): one warm-up request,
                   then two timed requests (100 steps, 30 s, B=1); checks
                   shapes, finiteness and K1 launches; then one more request
                   under torch.profiler for the device's busy share.
  8. flagship    - Jen1(Config()) with the UNet's convs quantized at the
                   default thresholds: the census, one UNet forward at
                   (2, 4500, 128) with K4, with the plain version and with
                   fp32 weights; one warm-up and two timed 100-step 30 s
                   DDIM requests (K4 launches, shapes, finiteness), one
                   request with fp32 weights, one 10-step request under
                   torch.profiler.
  9. train       - UnifiedMultiTaskTrainer under longform_config() at 30 s
                   windows, B=3, GDM, fused AdamW, full width: 2 warm-up
                   steps, 5 timed steps, launches of K1/K2/K3 per step, and
                   one more step under torch.profiler.
The line before the last is the `{"kernels": [...]}` record; the last line
is `{"ok": true, "device": {...}}`. Imports nothing of JAX or `jen1_tpu`.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 without
# tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# Bars of K1 against its plain version. O in fp32: the absolute bar of
# tests/test_flash_attention.py. O in bf16: both sides round an fp32 result
# to bf16, so they may differ by one bf16 step (2^-7 of the value); the bar
# is elementwise |dO| <= O_ATOL + O_RTOL * |O_ref|, which a dropped or
# doubled key tile (an O shift of ~20% of |O| at N=1125) fails. lse is fp32
# whatever the input dtype, so it gets an fp32-level bar.
O_ABS_BAR_FP32 = 2e-3
O_ATOL, O_RTOL = 1e-4, 1e-2
LSE_BAR = 1e-4
# Bars of K2 / K3 against their plain version, elementwise per gradient:
# |diff| <= GRAD_ATOL_REL * max|ref| (+ GRAD_RTOL_BF16 * |ref| in bf16). The
# kernels and cuBLAS sum the same fp32 products in other orders; in bf16
# each side also rounds its fp32 result once.
GRAD_ATOL_REL = 1e-4
GRAD_RTOL_BF16 = 1e-2

# Gradient leaves are compared at 5e-3 of their own max|g_ref|, that scale
# floored at this share of the largest leaf's: the biases that feed a
# GroupNorm have an analytically zero gradient, which both devices compute
# as rounding noise (1e-10 to 1e-8 of the largest leaf's).
GRAD_LEAF_FLOOR = 1e-5

KERNEL_NS = (128, 563, 1125, 4500)
KERNEL_DS = (16, 32, 64, 128)
PADDED_DS = (24, 96, 256)  # zero-padded by the wrappers to 32, 128, 256

SLICE_STEPS = 100
# the profiled request is shorter: the profiler's post-processing of a
# 100-step request (~385k kernel events) takes minutes
PROFILE_STEPS = 10
SLICE_SECONDS = 30
SLICE_PROMPTS = [("a calm piano melody over soft strings", 11),
                 ("driving techno with a heavy kick", 12)]

TRAIN_SECONDS = 30
TRAIN_BATCH = 3
TRAIN_WARMUP = 2
TRAIN_STEPS = 5
TRAIN_SEED = 4996
TRAIN_PROMPTS = ["a calm piano melody over soft strings", "driving techno with a heavy kick",
                 "solo cello, slow and sad"]
# K1 / K2 / K3 launches per train step: two causal groups x two level-1
# transformers per UNet forward
TRAIN_LAUNCHES = 4


# K4 at the flagship preset (Config(), 30 s, CFG-doubled B = 1): the
# (M, K, N) of the int8 products of one UNet forward at (2, 4500, 128) and
# how many of each (52 in all). M is 2 x the frames of UNet levels 7-9.
INT8_SHAPES = {
    (10, 3072, 1024): 10, (10, 1024, 1024): 4, (10, 6144, 1024): 4, (10, 2048, 1024): 4,
    (6, 3072, 1024): 8, (6, 1024, 1024): 6, (6, 6144, 1024): 2, (6, 2048, 1024): 2,
    (18, 1024, 512): 4, (36, 1024, 512): 4, (72, 1024, 512): 4,
}
INT8_RAGGED = ((130, 96, 72), (1, 1000, 1000), (7, 3072, 1000))
# K4 against its plain version, elementwise: |diff| <= INT8_REL_BAR *
# max|ref|. Both sum the same exact products (bf16 x int8 fits an fp32) in
# other orders.
INT8_REL_BAR = 1e-4
# bytes of distinct weight copies a K4 timing cycles through, so that every
# call finds its weights cold in the 50 MB L2, as a UNet forward does (its
# 52 int8 kernels hold 124 MB)
L2_FLUSH_BYTES = 128 << 20
FLAGSHIP_STEPS = 100
FLAGSHIP_SECONDS = 30
FLAGSHIP_READ_CONVS = 52  # stride-1 convs that read their int8 kernel
FLAGSHIP_QUANTIZED = 56  # conv kernels the JAX rule selects


_START = time.perf_counter()


def log(msg: str) -> None:
    """Print a progress line, stamped with the seconds since the start."""
    print(f"{msg}  [+{time.perf_counter() - _START:.1f} s]", flush=True)


def time_ms(torch, fn, iters: int) -> float:
    """Mean device time of `fn` in ms, by CUDA events after a warm-up."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device(torch) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(f"[device] {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi, flush=True)
    return {"kind": name, "count": count, "smi": smi}


def phase_build() -> None:
    from jen1_tpu_torch.ops import kernels

    info = kernels.build()
    kernels.library()
    log(f"[build] {info.path} in {info.seconds:.1f} s")
    for line in info.log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            log(f"[build] {line.strip()}")


def grad_violation(out, ref, dtype_name: str):
    """(max|out - ref|, max of |out - ref| / bar): the check passes while
    the second stays <= 1."""
    ref = ref.float()
    diff = (out.float() - ref).abs()
    bar = GRAD_ATOL_REL * ref.abs().max()
    if dtype_name == "bfloat16":
        bar = bar + GRAD_RTOL_BF16 * ref.abs()
    return diff.max().item(), (diff / bar).max().item()


def bwd_inputs(torch, fa, gen, bh, n, d, dtype, causal):
    """q, k, v, dO and the forward's plain O and lse, with delta."""
    q, k, v, do = [torch.randn((1, bh, n, d), generator=gen, device="cuda").to(dtype)
                   for _ in range(4)]
    o, lse = fa.flash_attention_reference(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).reshape(bh, n)
    return q, k, v, do, o, lse, delta


def check_bwd(torch, fa, gen, bh, n, d, dt, dtype, causal) -> dict:
    """K2 and K3 against flash_attention_bwd_reference; returns errors."""
    q, k, v, do, o, lse, delta = bwd_inputs(torch, fa, gen, bh, n, d, dtype, causal)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    refs = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    errs = {name: grad_violation(out, ref, dt)
            for name, out, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs)}
    ok = all(ratio <= 1.0 for _, ratio in errs.values())
    log(f"[kernels] flash_attention_bwd bh={bh} n={n} d={d} {dt} causal={causal}: "
        + " ".join(f"max|{k}|={e:.3e} ({r:.3f} of bar)" for k, (e, r) in errs.items())
        + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: K2/K3 disagree with their plain version")
    return errs


def dropped_tile_shift(torch, fa, gen, n, d) -> None:
    """What the bf16 bar would see if K2 skipped the ragged key tile or K3
    the ragged query tile (keys / queries >= 64 * (n // 64)) at N = n."""
    q, k, v, do, o, lse, _ = bwd_inputs(torch, fa, gen, 16, n, d, torch.bfloat16, False)
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, False)
    start = 64 * (n // 64)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    scale = d ** -0.5
    p = torch.exp(qf @ kf.transpose(-1, -2) * scale - lse.reshape(1, 16, n, 1))
    ds = p * (dof @ vf.transpose(-1, -2) - (dof * o.float()).sum(-1, keepdim=True)) * scale
    keep = (torch.arange(n, device="cuda") < start).float()
    dq = (ds * keep) @ kf
    dk = (ds * keep[:, None]).transpose(-1, -2) @ qf
    dv = (p * keep[:, None]).transpose(-1, -2) @ dof
    parts = []
    for name, drop, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        shift, ratio = grad_violation(drop.to(torch.bfloat16), r, "bfloat16")
        parts.append(f"{name} max shift {shift:.3e} = {ratio:.2f}x the bar")
    log(f"[kernels] a dropped ragged tile at n={n} d={d} bf16 (rows/keys {start}-{n - 1}): "
        + "; ".join(parts))


def phase_kernels(torch) -> list:
    import torch.nn.functional as F

    from jen1_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}

    def qkv(bh, n, d, dtype):
        return [torch.randn((1, bh, n, d), generator=gen, device="cuda").to(dtype)
                for _ in range(3)]

    # N = 1125, D = 16 is the slice shape; the others are the head dims the
    # repo's configs produce, lengths that are, and are not, tile multiples,
    # and head dims the wrappers zero-pad
    cases = [(16, n, d, dt, c) for n in KERNEL_NS for d in KERNEL_DS
             for dt in ("bfloat16", "float32") for c in (False, True)]
    cases += [(16, n, d, dt, c) for n in (563, 1125) for d in PADDED_DS
              for dt in ("bfloat16", "float32") for c in (False, True)]
    k1_err = 0.0
    for bh, n, d, dt, causal in cases:
        q, k, v = qkv(bh, n, d, dtypes[dt])
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        ro, rlse = fa.flash_attention_reference(q, k, v, causal)
        diff = (o.float() - ro.float()).abs()
        err_o = diff.max().item()
        err_lse = (lse - rlse).abs().max().item()
        if dt == "float32":
            ok_o, bar = err_o <= O_ABS_BAR_FP32, f"{O_ABS_BAR_FP32}"
        else:
            ok_o = bool((diff <= O_ATOL + O_RTOL * ro.float().abs()).all())
            bar = f"{O_ATOL} + {O_RTOL}*|O|"
        ok = ok_o and err_lse <= LSE_BAR
        log(f"[kernels] flash_attention_fwd bh={bh} n={n} d={d} {dt} causal={causal}: "
            f"max|dO|={err_o:.3e} (bar {bar}) max|dlse|={err_lse:.3e} (bar {LSE_BAR}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("chip_smoke: flash_attention_fwd disagrees with its plain version")
        if (bh, n, d, dt, causal) == (16, 1125, 16, "bfloat16", False):
            k1_err = max(err_o, err_lse)
    for bh, n, d, dt, causal in cases:
        check_bwd(torch, fa, gen, bh, n, d, dt, dtypes[dt], causal)
    dropped_tile_shift(torch, fa, gen, 1125, 16)

    # K1 timing at the generation shape: B*H = 16 (CFG-doubled batch 2 x 8
    # heads), N = 1125, D = 16, bf16, non-causal
    bh, n, d = 16, 1125, 16
    q, k, v = qkv(bh, n, d, torch.bfloat16)
    ms = time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, False), 200)
    plain_ms = time_ms(torch, lambda: fa.flash_attention_reference(q, k, v, False), 50)
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v), 200)
    flops = 4 * bh * n * n * d
    nbytes = 4 * bh * n * d * q.element_size() + bh * n * 4
    t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    log(f"[kernels] K1 generation shape timing: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
        f"sdpa {library_ms:.5f} ms, bound {bound_ms:.6f} ms "
        f"({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB)")
    rows = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "jen1_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "jen1_tpu/ops/flash_attention.py:45",
        "max_abs_err": k1_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }]
    rows += time_backward(torch, F, fa, gen)
    rows.append(int8_kernel_row(torch))
    return rows


def int8_case(torch, im, gen, m, k, n, dtype):
    """x (M, K) in `dtype` and the int8 quantization of a (K, N) weight."""
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    w8, scale = im.quantize_weight(torch.randn((k, n), generator=gen, device="cuda") * 0.05)
    return x, w8, scale


def check_int8(torch, im, gen, m, k, n, dtype) -> float:
    """K4 against matmul_int8w_plain at (m, k, n); returns max|diff|."""
    x, w8, scale = int8_case(torch, im, gen, m, k, n, dtype)
    out = im.matmul_int8w_cuda(x, w8, scale)
    torch.cuda.synchronize()
    ref = im.matmul_int8w_plain(x, w8, scale)
    err = (out - ref).abs().max().item()
    bar = INT8_REL_BAR * ref.abs().max().item()
    ok = out.shape == ref.shape and err <= bar
    log(f"[kernels] matmul_int8w m={m} k={k} n={n} x {str(dtype)[6:]} splits "
        f"{im.split_k(m, k, n)[0]}: max|diff|={err:.3e} (bar {bar:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: K4 disagrees with its plain version")
    return err


def int8_shifts(torch, im, gen, m, k, n) -> None:
    """What the K4 bar would see if the kernel dropped the last 64 rows of
    K, or dequantized the weights to bf16 before the product."""
    x, w8, scale = int8_case(torch, im, gen, m, k, n, torch.bfloat16)
    ref = im.matmul_int8w_plain(x, w8, scale)
    bar = INT8_REL_BAR * ref.abs().max().item()
    dropped = im.matmul_int8w_plain(x[:, : k - 64].contiguous(), w8[: k - 64], scale)
    early = x.float() @ (w8.float() * scale).to(torch.bfloat16).float()
    log(f"[kernels] K4 at m={m} k={k} n={n} bf16: a dropped final K tile would shift "
        f"{(dropped - ref).abs().max().item():.3e} = "
        f"{(dropped - ref).abs().max().item() / bar:.1f}x the bar; a bf16 dequantize "
        f"before the product {(early - ref).abs().max().item():.3e} = "
        f"{(early - ref).abs().max().item() / bar:.1f}x the bar")


def time_cycled(torch, fn, args, iters: int) -> float:
    """Mean device ms of `fn(*args[i % len(args)])` by CUDA events."""
    for a in args[:3]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args[i % len(args)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, args, iters: int) -> float:
    """Mean device time per call of `fn(*args[i % len(args)])`: the CUDA
    kernel time it launched, summed by torch.profiler, over `iters` calls.
    At K4's shapes a call's kernels take a few us, less than the host takes
    to enqueue it, so CUDA events around back-to-back calls time the host."""
    from torch.profiler import ProfilerActivity, profile

    for a in args[:3]:
        fn(*a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*args[i % len(args)])
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in kernels) * 1e-3 / iters


def int8_kernel_row(torch) -> dict:
    """K4 checked at every flagship and ragged shape (x bf16 and fp32) and
    timed per flagship shape by device time (the host's enqueue rate, by CUDA
    events, beside it); the record row holds the per-call mean over the 52
    launches of one flagship UNet forward."""
    from jen1_tpu_torch.ops import int8_matmul as im

    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = 0.0
    for m, k, n in list(INT8_SHAPES) + list(INT8_RAGGED):
        for dtype in (torch.bfloat16, torch.float32):
            err = check_int8(torch, im, gen, m, k, n, dtype)
            if (m, k, n) in INT8_SHAPES and dtype == torch.bfloat16:
                worst = max(worst, err)
    int8_shifts(torch, im, gen, 10, 3072, 1024)
    int8_shifts(torch, im, gen, 6, 1024, 1024)

    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    sum_ops = sum_bytes = 0.0
    for (m, k, n), count in INT8_SHAPES.items():
        x, w8, scale = int8_case(torch, im, gen, m, k, n, torch.bfloat16)
        copies = -(-L2_FLUSH_BYTES // (k * n))
        weights = [(x, w8.clone(), scale) for _ in range(copies)]
        ms = device_ms(torch, im.matmul_int8w_cuda, weights, 400)
        enqueue_ms = time_cycled(torch, im.matmul_int8w_cuda, weights, 400)
        plain = device_ms(torch, im.matmul_int8w_plain, weights, 100)
        del weights
        deq = (w8.float() * scale).to(torch.bfloat16)
        dense = [(x, deq.clone()) for _ in range(-(-copies // 2))]
        library = device_ms(torch, torch.matmul, dense, 400)
        library_enqueue = time_cycled(torch, torch.matmul, dense, 400)
        del dense
        if min(ms, plain, library) <= 0.0:
            raise SystemExit("chip_smoke: the profiler saw no device time for K4's timing")
        nbytes = k * n + 2 * m * k + 4 * m * n + 4 * n
        flops = 2 * m * k * n
        t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
        bound = max(t_ops, t_bytes) * 1e3
        log(f"[kernels] K4 m={m} k={k} n={n} bf16 x ({count} / forward), device ms per call: "
            f"kernel {ms:.5f}, plain {plain:.5f}, torch.matmul bf16 {library:.5f}, bound "
            f"{bound:.6f} ({'operations' if t_ops >= t_bytes else 'bytes'}; "
            f"{nbytes / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP); back-to-back calls by CUDA "
            f"events {enqueue_ms:.5f} (K4) and {library_enqueue:.5f} (torch.matmul) ms; weights "
            f"cold in L2 ({copies} copies)")
        for key, value in (("ms", ms), ("plain_ms", plain), ("bound_ms", bound),
                           ("library_ms", library)):
            total[key] += count * value
        sum_ops, sum_bytes = sum_ops + count * t_ops, sum_bytes + count * t_bytes
    launches = sum(INT8_SHAPES.values())
    row = {key: value / launches for key, value in total.items()}
    log(f"[kernels] K4 per call over one flagship forward's {launches} launches: "
        + " ".join(f"{k}={v:.6f}" for k, v in row.items()))
    return {"name": "matmul_int8w", "route": "cuda",
            "source": "jen1_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "jen1_tpu/ops/int8_matmul.py:48", "max_abs_err": worst,
            "bound_by": "operations" if sum_ops >= sum_bytes else "bytes", **row}


def time_backward(torch, F, fa, gen) -> list:
    """K2 and K3 at the train step's shapes (B*H = 32 and 16, N = 1125,
    D = 16, bf16, both causal values), each checked once more, beside the
    plain backward (both gradients) and SDPA's backward (all three
    gradients together). The record rows are those of B*H = 32, non-causal."""
    n, d = 1125, 16
    rows = {}
    for bh in (32, 16):
        for causal in (False, True):
            q, k, v, do, o, lse, delta = bwd_inputs(torch, fa, gen, bh, n, d,
                                                    torch.bfloat16, causal)
            errs = check_bwd(torch, fa, gen, bh, n, d, "bfloat16", torch.bfloat16, causal)
            ms_dq = time_ms(torch, lambda: fa.flash_attention_bwd_dq(
                q, k, v, do, lse, delta, causal), 100)
            ms_dkv = time_ms(torch, lambda: fa.flash_attention_bwd_dkv(
                q, k, v, do, lse, delta, causal), 100)
            plain = time_ms(torch, lambda: fa.flash_attention_bwd_reference(
                q, k, v, o, lse, do, causal), 30)
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
            out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
            sdpa = time_ms(torch, lambda: torch.autograd.grad(
                out, (qg, kg, vg), do, retain_graph=True), 100)
            # work this causal setting needs: N^2 pairs, or N(N+1)/2
            pairs = n * n if not causal else n * (n + 1) // 2
            es = q.element_size()
            for name, ms, fl, nbytes, err in (
                ("flash_attention_bwd_dq", ms_dq, 6 * bh * pairs * d,
                 5 * bh * n * d * es + 2 * bh * n * 4, errs["dq"][0]),
                ("flash_attention_bwd_dkv", ms_dkv, 8 * bh * pairs * d,
                 6 * bh * n * d * es + 2 * bh * n * 4, max(errs["dk"][0], errs["dv"][0])),
            ):
                t_ops, t_bytes = fl / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
                bound = max(t_ops, t_bytes) * 1e3
                log(f"[kernels] {name} bh={bh} n={n} d={d} bf16 causal={causal}: kernel "
                    f"{ms:.5f} ms, plain (dq+dk+dv) {plain:.5f} ms, sdpa backward {sdpa:.5f} ms, "
                    f"bound {bound:.6f} ms ({fl / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB)")
                if bh == 32 and not causal:
                    rows[name] = {
                        "name": name,
                        "route": "cuda",
                        "source": "jen1_tpu_torch/csrc/flash_attention_bwd.cu",
                        "replaces": ("jen1_tpu/ops/flash_attention.py:173"
                                     if name.endswith("dq") else
                                     "jen1_tpu/ops/flash_attention.py:222"),
                        "max_abs_err": err,
                        "ms": ms,
                        "plain_ms": plain,
                        "bound_ms": bound,
                        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                        "library_ms": sdpa,
                    }
    return [rows["flash_attention_bwd_dq"], rows["flash_attention_bwd_dkv"]]


def tiny_pair(torch):
    """Two tiny Jen1s, on the CPU and on the card, with the same T5, UNet
    and codec weights: tiny_test_config widths, fp32, one attention head
    and flash_min_seq_len 128, a 1600 Hz codec with a 40-sample hop."""
    import dataclasses

    from jen1_tpu_torch.api.generation import Jen1
    from jen1_tpu_torch.codec.model import EncodecConfig, EncodecModel
    from jen1_tpu_torch.conditioning.conditioners import MultiConditioner, T5Conditioner
    from jen1_tpu_torch.config import tiny_test_config

    cfg = tiny_test_config()
    # one head, so the level-1 transformer (16 channels) has head dim 16
    cfg.model_config = dataclasses.replace(
        cfg.model_config, use_flash_attention=True, flash_min_seq_len=128, attention_heads=1,
    )
    codec_cfg = EncodecConfig(sample_rate=1600, channels=2, dimension=8, n_filters=2,
                              ratios=(5, 4, 2))

    def build(device):
        t5 = T5Conditioner(16, "tiny-test", cfg.model_config.context_embedding_max_length,
                           device=device)
        return Jen1(sample_rate=1600, config=cfg, codec=EncodecModel(codec_cfg, device=device),
                    conditioner=MultiConditioner({"prompt": t5}), device=device)

    cpu, card = build("cpu"), build("cuda")
    card.model.load_state_dict(cpu.model.state_dict())
    card.codec.load_state_dict(cpu.codec.state_dict())
    card.conditioner.conditioners["prompt"].load_state_dict(
        cpu.conditioner.conditioners["prompt"].state_dict())
    return cpu, card


def phase_small(torch) -> None:
    """The whole slice at tiny widths, on the card against the CPU: the
    same T5, UNet and codec weights and the same x_T, fp32, 13 s at 1600 Hz
    (520 latent frames, so the level-1 transformer attends over 260 frames
    through the flash path and the decode takes 4 chunks). Bar: rtol 2e-2 /
    atol 2e-3, the sampler-trajectory bar of the CPU parity tests."""
    import numpy as np

    from jen1_tpu_torch.diffusion import vdm
    from jen1_tpu_torch.ops import flash_attention as fa

    cpu, card = tiny_pair(torch)
    # the CPU and CUDA generators draw different numbers: give both x_T
    # from one CPU stream
    draw = vdm.initial_noise
    vdm.initial_noise = lambda shape, generator, device: torch.randn(
        tuple(shape), generator=torch.Generator().manual_seed(7)).to(device)
    kw = dict(seed=5, steps=4, seconds=13)
    ref = cpu.generate("a beautiful song", **kw)
    before = fa.LAUNCHES
    out = card.generate("a beautiful song", **kw)
    launched = fa.LAUNCHES - before
    vdm.initial_noise = draw
    err = float(np.abs(out - ref).max())
    close = out.shape == ref.shape and np.allclose(out, ref, rtol=2e-2, atol=2e-3)
    log(f"[small] tiny generate() card vs CPU: shape {out.shape} max|diff|={err:.3e} "
        f"(rtol 2e-2, atol 2e-3) flash launches={launched}")
    if not close or launched == 0:
        raise SystemExit("chip_smoke: the tiny generate() on the card disagrees with the CPU")


def phase_small_gdm(torch) -> None:
    """The tiny slice with use_gdm=True on the card against the CPU: DDIM
    (4 of 8 timesteps) and DPM-Solver++ (4 calls), x_T and each step's noise
    drawn from one CPU stream for both devices. With fp32 weights the bar is
    rtol 2e-2 / atol 2e-3, as in phase small. With every UNet conv quantized
    (thresholds 0, the same tree attached on both devices) each conv rounds
    its input to bf16, so the request is as sensitive to a 1e-6 relative
    change upstream as to a bf16 step (tests/test_torch_generation.py); the
    bar is then three times the CPU's own spread under a 1e-6 relative
    change of x_T, in mean and in max of |diff|. K4 runs once per quantized
    stride-1 conv and step."""
    import numpy as np

    from jen1_tpu_torch.diffusion import gdm
    from jen1_tpu_torch.ops import int8_matmul as im

    cpu, card = tiny_pair(torch)
    q = im.quantize_conv_params(cpu.model, min_weight_bytes=0, min_weight_bytes_k1=0)
    steps, kw = 4, dict(seed=5, steps=4, seconds=13, use_gdm=True)
    shape = (1, 520, 8)
    stream = torch.Generator().manual_seed(7)
    x_t = torch.randn(shape, generator=stream)
    noises = [torch.randn(shape, generator=stream) for _ in range(steps)]
    draws = (gdm.initial_noise, gdm.step_noise)
    gdm.step_noise = lambda x, generator, index, uniform=False: noises[index].to(x.device)

    def run(jen1, mode, start=x_t):
        gdm.initial_noise = lambda shape, generator, device: start.to(device)
        return jen1.generate("a beautiful song", sampler_mode=mode, **kw)

    try:
        for quantized in (False, True):
            if quantized:
                attached = im.attach_qweights(cpu.model, q)
                if im.attach_qweights(card.model, q) != attached or attached == 0:
                    raise SystemExit("chip_smoke: the quantized tree attached unevenly")
            for mode in ("scan", "dpm++"):
                ref = run(cpu, mode)
                im.LAUNCHES = 0
                out = run(card, mode)
                launched = im.LAUNCHES
                diff = np.abs(out - ref)
                want = attached * steps if quantized else 0
                if quantized:
                    spread = [np.abs(run(cpu, mode, x_t * (1 + sign * 1e-6 * noises[0])) - ref)
                              for sign in (1, -1)]
                    bar_mean = 3 * max(d.mean() for d in spread)
                    bar_max = 3 * max(d.max() for d in spread)
                    close = diff.mean() <= bar_mean and diff.max() <= bar_max
                    bar = f"mean <= {bar_mean:.3e}, max <= {bar_max:.3e}"
                else:
                    close = np.allclose(out, ref, rtol=2e-2, atol=2e-3)
                    bar = "rtol 2e-2, atol 2e-3"
                ok = close and out.shape == ref.shape and launched == want
                log(f"[small-gdm] {'int8' if quantized else 'fp32'} weights, sampler_mode="
                    f"{mode}: card vs CPU max|diff|={diff.max():.3e} mean={diff.mean():.3e} "
                    f"({bar}); K4 launches {launched} (want {want}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit("chip_smoke: the tiny GDM generate() on the card "
                                     "disagrees with the CPU")
    finally:
        gdm.initial_noise, gdm.step_noise = draws


def launch_counts():
    from jen1_tpu_torch.ops import flash_attention as fa

    return fa.LAUNCHES, fa.LAUNCHES_DQ, fa.LAUNCHES_DKV


def phase_small_train(torch) -> None:
    """One train step of a tiny trainer (tiny_test_config widths, fp32,
    flash_min_seq_len 128, so the level-1 transformer's 130 frames at
    L = 520 take the flash path with head dim 8, zero-padded to 16) on the
    card against the CPU: same weights, same batch, same draws, for both
    causal variants of text_guided. Bars of the CPU parity tests: per-task
    losses rtol 2e-3; every gradient leaf within 5e-3 * max|g_ref| of the
    leaf, that scale floored at GRAD_LEAF_FLOOR of the largest leaf's."""
    import dataclasses

    import numpy as np

    from jen1_tpu_torch.config import tiny_test_config
    from jen1_tpu_torch.train.train import build_trainer
    from jen1_tpu_torch.train.trainer import StepDraws, step_generator

    cfg = tiny_test_config()
    cfg.model_config = dataclasses.replace(cfg.model_config, use_flash_attention=True,
                                           flash_min_seq_len=128)
    cfg.conditioner_config.t5_config.t5_model_name = "tiny-test"
    cfg.conditioner_config.t5_config.max_length = cfg.model_config.context_embedding_max_length
    cpu, card = build_trainer(cfg, device="cpu"), build_trainer(cfg, device="cuda")
    mc = cfg.model_config
    g = np.random.default_rng(0)
    m = mc.context_embedding_max_length
    mask = np.ones((3, m), bool)
    mask[-1, m // 2:] = False
    host = {
        "latents": g.standard_normal((3, 520, mc.in_channels)).astype(np.float32),
        "text_emb": g.standard_normal((3, m, mc.context_embedding_features)).astype(np.float32),
        "text_mask": mask,
    }

    class Coin:
        def __init__(self, value):
            self.value = value

        def integers(self, lo, hi):
            return self.value

    for coin in (0, 1):
        card.model.load_state_dict(cpu.model.state_dict())
        flags = cpu._causal_flags(Coin(coin))
        draws = type(cpu).draw_randoms(cpu, step_generator("cpu", 0, coin), flags,
                                       host["latents"].shape)
        moved = StepDraws(*[{k: v.to("cuda") if torch.is_tensor(v) else v
                             for k, v in getattr(draws, f.name).items()}
                            for f in dataclasses.fields(StepDraws)])
        cpu.draw_randoms = lambda *a: draws
        card.draw_randoms = lambda *a: moved
        metrics = {}
        for name, tr in (("cpu", cpu), ("card", card)):
            batch = {k: torch.as_tensor(v, device=tr.device) for k, v in host.items()}
            before = launch_counts()
            _, mt = tr.train_step(tr.init_state(), batch, None, Coin(coin))
            launched = [a - b for a, b in zip(launch_counts(), before)]
            metrics[name] = {k: float(v) for k, v in mt.items()}
        losses_ok = all(np.isclose(metrics["card"][k], metrics["cpu"][k], rtol=2e-3, atol=0)
                        for k in metrics["cpu"] if k.startswith("loss"))
        refs = [p.grad for p in cpu.model.parameters()]
        floor = GRAD_LEAF_FLOOR * max(r.abs().max().item() for r in refs)
        worst, worst_name = 0.0, ""
        for (name, pg), ref in zip(card.model.named_parameters(), refs):
            bar = 5e-3 * max(ref.abs().max().item(), floor)
            ratio = (pg.grad.cpu() - ref).abs().max().item() / bar
            if ratio >= worst:
                worst, worst_name = ratio, name
        log(f"[small-train] text_guided causal={bool(coin)}: losses card "
            + " ".join(f"{k}={v:.6f}" for k, v in metrics["card"].items())
            + f"; cpu loss/train={metrics['cpu']['loss/train']:.6f} "
            f"grad_norm={metrics['cpu']['grad_norm']:.6f}; worst gradient leaf {worst_name} "
            f"at {worst:.4f} of its bar; K1/K2/K3 launches {launched}")
        if not losses_ok or worst > 1.0 or min(launched) == 0:
            raise SystemExit("chip_smoke: the tiny train step on the card disagrees with the CPU")


def phase_main(torch) -> int:
    """Returns the K1 launches of the two counted requests."""
    import numpy as np

    from jen1_tpu_torch.api.generation import Jen1
    from jen1_tpu_torch.config import longform_config
    from jen1_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    jen1 = Jen1(config=longform_config(), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in jen1.model.parameters())
    log(f"[main] Jen1(longform_config()) built in {time.perf_counter() - t0:.2f} s; "
        f"UNet params {n_params}")
    expected = 2 * SLICE_STEPS  # two flash launches per UNet forward
    samples = SLICE_SECONDS * jen1.sample_rate

    t0 = time.perf_counter()
    out = jen1.generate("warm-up", seed=1, steps=SLICE_STEPS, seconds=SLICE_SECONDS)
    log(f"[main] warm-up request {time.perf_counter() - t0:.3f} s, shape {out.shape}")

    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = fa.LAUNCHES_DQ = fa.LAUNCHES_DKV = 0
    launches = []
    outs = []
    for prompt, seed in SLICE_PROMPTS:
        before = fa.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = jen1.generate(prompt, seed=seed, steps=SLICE_STEPS, batch_size=1,
                            seconds=SLICE_SECONDS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches.append(fa.LAUNCHES - before)
        outs.append(out)
        phases = " ".join(f"{k}={v:.4f}" for k, v in jen1.last_timings.items())
        log(f"[main] request seed={seed}: wall {wall:.4f} s; phases (s): {phases}; "
            f"flash launches {launches[-1]}; shape {out.shape}; "
            f"finite {bool(np.isfinite(out).all())}; "
            f"rms {float(np.sqrt((out.astype(np.float64) ** 2).mean())):.4e}")
    total, bwd = fa.LAUNCHES, (fa.LAUNCHES_DQ, fa.LAUNCHES_DKV)
    log(f"[main] peak device memory {torch.cuda.max_memory_allocated()} bytes")
    for out in outs:
        if out.shape != (1, 2, samples) or not np.isfinite(out).all():
            raise SystemExit(f"chip_smoke: bad output shape {out.shape} or non-finite values")
    if np.array_equal(outs[0], outs[1]):
        raise SystemExit("chip_smoke: two prompts and seeds gave identical audio")
    if launches != [expected] * len(SLICE_PROMPTS):
        raise SystemExit(f"chip_smoke: flash launches per request {launches}, want {expected}")
    if bwd != (0, 0):
        raise SystemExit(f"chip_smoke: generation launched backward kernels {bwd}")
    prompt, seed = SLICE_PROMPTS[0]
    profile_window(torch, "profile", f"{PROFILE_STEPS}-step request", lambda: jen1.generate(
        prompt, seed=seed, steps=PROFILE_STEPS, seconds=SLICE_SECONDS))
    return total


def flagship_forwards(torch, im, jen1, q) -> None:
    """One UNet forward at (2, 4500, 128) (the flagship's CFG-doubled
    batch, no guidance mix) with K4, with K4's plain version on the card,
    and with fp32 weights; logs the K4 shapes of the forward (which must be
    INT8_SHAPES), K4 against the plain version, and the int8 drift from the
    fp32 weights. The forward rounds every product's fp32 result to its bf16
    activations, so K4's other summation order flips single bf16 steps that
    the layers after carry on. The bar is the forward's own spread: K4
    against the plain version may differ, in max and in mean of |diff|, by
    at most three times what the plain version moves under a 1e-6 relative
    change of its input. The plain-forward bar (rtol 2e-3, atol 2e-4 of
    max|ref|) is logged beside it as a share of elements."""
    import collections

    gen = torch.Generator(device="cuda").manual_seed(21)
    mc = jen1.config.model_config
    x = torch.randn((2, 4500, mc.in_channels), generator=gen, device="cuda")
    x_moved = x * (1 + 1e-6 * torch.randn(x.shape, generator=gen, device="cuda"))
    t = torch.full((2,), 500, dtype=torch.long, device="cuda")
    emb = torch.randn((2, mc.context_embedding_max_length, mc.context_embedding_features),
                      generator=gen, device="cuda")
    mask = torch.ones((2, mc.context_embedding_max_length), dtype=torch.bool, device="cuda")
    chans = torch.randn((2, 4500, mc.context_channels[0]), generator=gen, device="cuda")

    def forward(inp=x):
        with torch.no_grad():
            out = jen1._model_fn(inp, t, embedding=emb, embedding_mask=mask,
                                 channels_list=[chans])
        torch.cuda.synchronize()
        return out

    kernel = im.matmul_int8w_cuda
    shapes = collections.Counter()

    def recording(a, w8, scale):
        shapes[(a.shape[0], a.shape[1], w8.shape[1])] += 1
        return kernel(a, w8, scale)

    im.matmul_int8w_cuda = recording
    try:
        out = forward()
        im.matmul_int8w_cuda = lambda a, w8, scale: im.matmul_int8w_plain(a, w8, scale)
        ref = forward()
        ref_moved = forward(x_moved)
    finally:
        im.matmul_int8w_cuda = kernel
    im.clear_qweights(jen1.model)
    fp = forward()
    im.attach_qweights(jen1.model, q)
    log("[flagship] K4 shapes of one forward (M, K, N): launches "
        + ", ".join(f"{k}: {v}" for k, v in sorted(shapes.items())))
    if dict(shapes) != INT8_SHAPES:
        raise SystemExit("chip_smoke: the flagship forward's K4 shapes differ from INT8_SHAPES")
    scale = ref.abs().max().item()
    diff, spread = (out - ref).abs(), (ref_moved - ref).abs()
    violations = (diff > 2e-4 * scale + 2e-3 * ref.abs()).float().mean().item()
    drift = (out - fp).abs().max().item() / fp.abs().max().item()
    ok = (bool(torch.isfinite(out).all()) and diff.max() <= 3 * spread.max()
          and diff.mean() <= 3 * spread.mean())
    log(f"[flagship] UNet forward (2, 4500, 128), max|ref| {scale:.4e}: K4 vs plain "
        f"max|diff| {diff.max().item():.4e}, mean {diff.mean().item():.4e}; plain vs plain "
        f"at a 1e-6 relative change of x: max {spread.max().item():.4e}, mean "
        f"{spread.mean().item():.4e}; share of elements beyond rtol 2e-3 / atol "
        f"2e-4*max|ref| {violations:.3e}; int8 vs fp32 weights max|diff|/max|ref| "
        f"{drift:.3e} (no bar) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: the flagship forward with K4 disagrees with its "
                         "plain version")


def phase_flagship(torch) -> int:
    """The int8 flagship slice; returns the K4 launches of the two timed
    requests."""
    import numpy as np

    from jen1_tpu_torch.api.generation import Jen1
    from jen1_tpu_torch.config import Config
    from jen1_tpu_torch.ops import flash_attention as fa
    from jen1_tpu_torch.ops import int8_matmul as im

    t0 = time.perf_counter()
    jen1 = Jen1(config=Config(), device="cuda")
    q = im.quantize_conv_params(jen1.model)
    read = im.attach_qweights(jen1.model, q)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in jen1.model.parameters())
    int8_bytes = sum(w8.numel() for w8, _ in q.values())
    read_bytes = sum(w8.numel() for p, (w8, _) in q.items()
                     if im.reads_qweights(jen1.model.get_submodule(p)))
    log(f"[flagship] Jen1(Config()) built and quantized in {time.perf_counter() - t0:.2f} s; "
        f"UNet params {n_params}; {len(q)} conv kernels quantized ({int8_bytes} int8 bytes), "
        f"{read} read by stride-1 convs ({read_bytes} bytes per forward)")
    if (len(q), read) != (FLAGSHIP_QUANTIZED, FLAGSHIP_READ_CONVS):
        raise SystemExit(f"chip_smoke: census {len(q)} / {read}, want "
                         f"{FLAGSHIP_QUANTIZED} / {FLAGSHIP_READ_CONVS}")
    flagship_forwards(torch, im, jen1, q)

    kw = dict(steps=FLAGSHIP_STEPS, seconds=FLAGSHIP_SECONDS, use_gdm=True)
    expected = read * FLAGSHIP_STEPS
    samples = FLAGSHIP_SECONDS * jen1.sample_rate
    t0 = time.perf_counter()
    out = jen1.generate("warm-up", seed=1, **kw)
    log(f"[flagship] warm-up request {time.perf_counter() - t0:.3f} s, shape {out.shape}")

    torch.cuda.reset_peak_memory_stats()
    im.LAUNCHES = fa.LAUNCHES = fa.LAUNCHES_DQ = fa.LAUNCHES_DKV = 0
    launches, outs = [], []
    for prompt, seed in SLICE_PROMPTS:
        before = im.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = jen1.generate(prompt, seed=seed, batch_size=1, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches.append(im.LAUNCHES - before)
        outs.append(out)
        phases = " ".join(f"{k}={v:.4f}" for k, v in jen1.last_timings.items())
        log(f"[flagship] int8 request seed={seed}: wall {wall:.4f} s; phases (s): {phases}; "
            f"K4 launches {launches[-1]}; shape {out.shape}; "
            f"finite {bool(np.isfinite(out).all())}; "
            f"rms {float(np.sqrt((out.astype(np.float64) ** 2).mean())):.4e}")
    total, flash = im.LAUNCHES, (fa.LAUNCHES, fa.LAUNCHES_DQ, fa.LAUNCHES_DKV)
    log(f"[flagship] peak device memory {torch.cuda.max_memory_allocated()} bytes")
    for out in outs:
        if out.shape != (1, 2, samples) or not np.isfinite(out).all():
            raise SystemExit(f"chip_smoke: bad output shape {out.shape} or non-finite values")
    if np.array_equal(outs[0], outs[1]):
        raise SystemExit("chip_smoke: two prompts and seeds gave identical audio")
    if launches != [expected] * len(SLICE_PROMPTS):
        raise SystemExit(f"chip_smoke: K4 launches per request {launches}, want {expected}")
    if flash != (0, 0, 0):
        raise SystemExit(f"chip_smoke: the flagship launched flash kernels {flash}")

    prompt, seed = SLICE_PROMPTS[0]
    im.clear_qweights(jen1.model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fp = jen1.generate(prompt, seed=seed, batch_size=1, **kw)
    torch.cuda.synchronize()
    log(f"[flagship] fp32-weight request seed={seed}: wall {time.perf_counter() - t0:.4f} s; "
        f"phases (s): " + " ".join(f"{k}={v:.4f}" for k, v in jen1.last_timings.items())
        + f"; rms of int8 - fp32 audio {float(np.sqrt(((outs[0] - fp) ** 2).mean())):.4e}")
    im.attach_qweights(jen1.model, q)
    by_name = profile_window(torch, "flagship-profile", f"{PROFILE_STEPS}-step int8 request",
                             lambda: jen1.generate(prompt, seed=seed, steps=PROFILE_STEPS,
                                                   seconds=FLAGSHIP_SECONDS, use_gdm=True))
    k4 = [(n, t) for name, (n, t) in by_name.items() if "int8w_" in name]
    log(f"[flagship-profile] K4 device time {sum(t for _, t in k4):.4f} s in "
        f"{sum(n for n, _ in k4)} kernel launches (both passes)")
    return total


def profile_window(torch, tag: str, what: str, fn) -> dict:
    """Run `fn` once under torch.profiler: the device's busy share of its
    wall (sum of kernel times over the wall) and the kernels that take the
    most device time. Returns {kernel name: (launches, device s)}."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in kernels) * 1e-6
    log(f"[{tag}] {what} wall {wall:.4f} s (profiler on); device kernels "
        f"{len(kernels)}, busy {busy_s:.4f} s = {busy_s / wall:.4f} of the wall")
    by_name: dict = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() * 1e-6)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    # the top twelve, and the port's own kernels wherever they rank
    for name, (n, t) in ranked[:12] + [kv for kv in ranked[12:] if is_port_kernel(kv[0])]:
        log(f"[{tag}]   {t:.4f} s in {n} launches: {name[:110]}")
    return by_name


def is_port_kernel(name: str) -> bool:
    return "flash_" in name or "int8w_" in name


def phase_train(torch) -> tuple:
    """The training slice at full width; returns the K1/K2/K3 launches of
    the timed steps."""
    import numpy as np

    from jen1_tpu_torch.config import longform_config
    from jen1_tpu_torch.ops import flash_attention as fa
    from jen1_tpu_torch.train.train import build_trainer
    from jen1_tpu_torch.train.trainer import step_generator

    cfg = longform_config()
    cfg.dataset_config.sample_duration = TRAIN_SECONDS
    cfg.dataset_config.batch_size = TRAIN_BATCH
    cfg.grad_accum_every = 1
    cfg.seed = TRAIN_SEED
    frames = int(TRAIN_SECONDS * 150)
    t0 = time.perf_counter()
    trainer = build_trainer(cfg, device="cuda")
    state = trainer.init_state()
    torch.cuda.synchronize()
    params = trainer.params
    log(f"[train] trainer built in {time.perf_counter() - t0:.2f} s; UNet params "
        f"{sum(p.numel() for p in params)}; diffusion {cfg.diffusion_type}, "
        f"fused AdamW {trainer._use_fused}, compute {cfg.model_config.dtype}")

    latents = np.random.default_rng(TRAIN_SEED).standard_normal(
        (TRAIN_BATCH, frames, cfg.model_config.in_channels)).astype(np.float32)
    t0 = time.perf_counter()
    batch = trainer.prepare_batch(latents, [{"prompt": p} for p in TRAIN_PROMPTS])
    torch.cuda.synchronize()
    log(f"[train] prepare_batch (full-width T5, byte tokens) {time.perf_counter() - t0:.3f} s; "
        f"latents {tuple(batch['latents'].shape)}, text_emb {tuple(batch['text_emb'].shape)}")

    def step(index: int, draws_index: int):
        nonlocal state
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, batch,
                                      step_generator(trainer.device, TRAIN_SEED, draws_index),
                                      np.random.default_rng((TRAIN_SEED, draws_index)))
        loss = m["loss/train"].item()  # a host read ends every step
        wall = time.perf_counter() - t0
        vals = {k: float(v) for k, v in m.items()}
        log(f"[train] step {index}: wall {wall:.4f} s; "
            + " ".join(f"{k}={v:.6f}" for k, v in vals.items()))
        if not all(np.isfinite(v) for v in vals.values()):
            raise SystemExit("chip_smoke: non-finite loss or grad norm")
        return loss, wall

    before = [p.detach().clone() for p in params]
    # the warm-up steps repeat one batch with the same draws, so their
    # losses differ only through the parameter update between them
    losses = [step(i, 0)[0] for i in range(TRAIN_WARMUP)]
    changed = sum(not torch.equal(a, p.detach()) for a, p in zip(before, params))
    del before
    log(f"[train] warm-up losses {losses}; parameter tensors changed {changed} of {len(params)}")
    if losses[1] == losses[0] or changed == 0:
        raise SystemExit("chip_smoke: the train step did not change the parameters")

    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = fa.LAUNCHES_DQ = fa.LAUNCHES_DKV = 0
    walls, per_step = [], []
    for i in range(1, TRAIN_STEPS + 1):
        b = launch_counts()
        walls.append(step(TRAIN_WARMUP + i, i)[1])
        per_step.append(tuple(a - c for a, c in zip(launch_counts(), b)))
    total = launch_counts()
    med = statistics.median(walls)
    log(f"[train] {TRAIN_STEPS} timed steps: wall median {med:.4f} s, min {min(walls):.4f} s, "
        f"max {max(walls):.4f} s; audio-seconds trained per second "
        f"{TRAIN_BATCH * TRAIN_SECONDS / med:.3f}; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes; K1/K2/K3 launches per step {per_step}")
    if any(s != (TRAIN_LAUNCHES,) * 3 for s in per_step):
        raise SystemExit(f"chip_smoke: K1/K2/K3 launches per step {per_step}, "
                         f"want {TRAIN_LAUNCHES} each")
    profile_window(torch, "train-profile", "one train step",
                   lambda: step(TRAIN_WARMUP + TRAIN_STEPS + 1, TRAIN_STEPS + 1))
    return total


def main() -> int:
    import torch

    if not (ROOT / "jen1_tpu_torch").is_dir():
        print("chip_smoke: jen1_tpu_torch/ is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    device = phase_device(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    rows = phase_kernels(torch)
    phase_small(torch)
    phase_small_gdm(torch)
    phase_small_train(torch)
    k1_generation = phase_main(torch)
    gc.collect()
    torch.cuda.empty_cache()
    k4 = phase_flagship(torch)
    gc.collect()
    torch.cuda.empty_cache()
    k1_train, k2, k3 = phase_train(torch)
    for row, launches in zip(rows, (k1_generation + k1_train, k2, k3, k4)):
        row["launches"] = launches
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
