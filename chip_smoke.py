#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (`jen1_tpu_torch`) on one card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
  1. device      - require CUDA; print the card's name, count and power limit.
  2. build       - build the kernel library from jen1_tpu_torch/csrc (one
                   nvcc per source, in parallel) and print its `-Xptxas -v`
                   register and shared-memory use, and the SASS instruction
                   mix of the main loop of K1's, K2's and K3's tensor-core
                   kernels at head dim 16 and of K4 at the 10-row shapes.
  3. kernels     - K1 (flash forward), K2 (dq) and K3 (dk, dv) against their
                   plain PyTorch versions over N x D x dtype x causal, padded
                   head dims included, with the stated bars, each launch on
                   its route (bf16: tensor cores; fp32: scalar); what a
                   dropped ragged tile, K1 with a single bf16 P or K2 with a
                   single bf16 dS would shift; K1 timed at the generation
                   shape and N = 4500, K2/K3
                   at the training shape, both causal values, in device time
                   (torch.profiler; CUDA events beside it), beside their plain
                   versions, their bounds (bytes / operations, and the ex2
                   unit) and the SDPA yardsticks. K4 (int8 weight-only
                   matmul) against its plain version at every int8 shape of
                   the flagship preset, at ragged shapes and at K sizes
                   that take several passes over x, x in bf16 and
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
  7. small-tasks - the tiny slice's music_inpaint and music_cont (VDM) and
                   music_cont (GDM DDIM) of a seeded clip on the card against
                   the CPU (same weights and draws), with their causal K1
                   launches; the codec's chunked and segmented encodes and
                   the RVQ codes on the card against the CPU.
  8. main        - Jen1(longform_config()).generate(): one warm-up request,
                   then two timed requests (100 steps, 30 s, B=1); checks
                   shapes, finiteness and K1 launches, every one on the
                   tensor-core route; then one more request under
                   torch.profiler for the device's busy share and K1's
                   device time.
  9. tasks       - the same Jen1: music_inpaint of a seeded 30 s clip over
                   10-20 s and music_cont of its first 10 s to 30 s, 100 VDM
                   steps each after a short warm-up: walls, phase walls
                   (encode included), peak memory, K1 launches (200 each,
                   all on the tensor-core route, the continuation's all
                   causal); the 30 s encode chunked against whole-clip; the
                   bf16 chunked decode against the fp32 one; one 10-step
                   continuation under torch.profiler.
 10. flagship    - Jen1(Config()) with the UNet's convs quantized at the
                   default thresholds: the census, one UNet forward at
                   (2, 4500, 128) with K4, with the plain version and with
                   fp32 weights; one warm-up and two timed 100-step 30 s
                   DDIM requests (K4 launches, shapes, finiteness), one
                   request with fp32 weights, one 10-step request under
                   torch.profiler.
 11. train       - UnifiedMultiTaskTrainer under longform_config() at 30 s
                   windows, B=3, GDM, fused AdamW, full width: 2 warm-up
                   steps, 5 timed steps, launches of K1/K2/K3 per step (all
                   on the tensor-core route), and one more step under
                   torch.profiler with K1+K3's and K2's device time.
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
# The exp of every score runs on the special-function unit: 16 ex2 results
# per clock per SM on compute capability 9.0 (CUDA programming guide,
# arithmetic-instruction throughput table), 132 SMs on the H100 SXM. At head
# dim 16 this bounds the flash kernels above the tensor-core rate.
SM_COUNT = 132
EX2_PER_CLOCK_PER_SM = 16

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
# K sizes that take K4 through several passes over x, the second with
# N % 16 != 0 (weights by ordinary loads instead of cp.async)
INT8_PASSES = ((2, 65536, 32), (3, 40000, 24))
# K4's instantiation at the 10-row flagship shapes (bf16 x, two m8 tiles),
# as its mangled name reads in the SASS
K4_SASS_KEY = "int8w_matmul_kernelI13__nv_bfloat16Li2E"
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

# the tasks slice: a seeded 30 s clip, inpainted over 10-20 s, and its
# first 10 s continued to 30 s
TASKS_SEED = 31
TASKS_SCOPE = (10.0, 20.0)
TASKS_CONT_SECONDS = 10
# the tiny slice's codec: 1600 Hz, a 40-sample hop, a 2 x 16-entry RVQ
TINY_CODEC = dict(sample_rate=1600, channels=2, dimension=8, n_filters=2, ratios=(5, 4, 2),
                  n_q=2, bins=16)


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


def nvidia_smi(query: str) -> str:
    """The first card's `query` fields, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_device(torch) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    log(f"[device] {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"max SM clock {clock_mhz:.0f} MHz")
    print(smi, flush=True)
    return {"kind": name, "count": count, "smi": smi, "sm_clock_hz": clock_mhz * 1e6}


def exp_bound_ms(bh: int, pairs: int, clock_hz: float) -> float:
    """Least time for the B*H*pairs exponentials on the ex2 units."""
    return bh * pairs / (SM_COUNT * EX2_PER_CLOCK_PER_SM * clock_hz) * 1e3


def phase_build() -> None:
    from jen1_tpu_torch.ops import kernels

    info = kernels.build()
    kernels.library()
    log(f"[build] {info.path} in {info.seconds:.1f} s")
    for line in info.log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            log(f"[build] {line.strip()}")
    sass_loops(info.path, ("flash_fwd_mma_kernelILi16E", "flash_bwd_dq_mma_kernelILi16E",
                           "flash_bwd_dkv_mma_kernelILi16E", K4_SASS_KEY))


def sass_loops(lib: Path, kernels) -> None:
    """For each named kernel, the instructions of its largest loop that
    holds an `mma` (the span of its longest such backward branch, branches
    not taken on most tiles included) by opcode, from `cuobjdump -sass`: at
    head dim 16 the flash kernels' pace follows this count."""
    import collections
    import re

    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(lib)], check=True,
                          capture_output=True, text=True, timeout=120).stdout
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.splitlines()[0]
        if not any(k in name for k in kernels):
            continue
        code = re.findall(r"/\*([0-9a-f]{4,})\*/\s+((?:@!?U?P\w+\s+)?[A-Z][^;]*);", func)
        where = {int(a, 16): i for i, (a, _) in enumerate(code)}
        loops = [(where[int(t, 16)], i) for i, (_, ins) in enumerate(code)
                 for t in re.findall(r"\bBRA (?:\S+, )?0x([0-9a-f]+)", ins)
                 if int(t, 16) in where and where[int(t, 16)] < i]
        # the product loop: K4's x staging loop can be longer
        loops = [(s, e) for s, e in loops
                 if any("HMMA" in ins for _, ins in code[s:e + 1])] or loops
        start, end = max(loops, key=lambda se: se[1] - se[0])
        ops = collections.Counter(re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0].split(".")[0]
                                  for _, ins in code[start:end + 1] if "@!PT" not in ins)
        short = next(k for k in kernels if k in name)
        log(f"[build] SASS of {short}: {len(code)} instructions, main loop "
            f"{sum(ops.values())}: " + " ".join(f"{k}={v}" for k, v in ops.most_common(16)))


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
    before = (fa.LAUNCHES_DQ_MMA, fa.LAUNCHES_DKV_MMA)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    mma = (fa.LAUNCHES_DQ_MMA - before[0], fa.LAUNCHES_DKV_MMA - before[1])
    torch.cuda.synchronize()
    refs = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    errs = {name: grad_violation(out, ref, dt)
            for name, out, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs)}
    want = int(dt == "bfloat16")
    ok = all(ratio <= 1.0 for _, ratio in errs.values()) and mma == (want, want)
    routes = ["tensor-core" if m else "scalar" for m in mma]
    log(f"[kernels] flash_attention_bwd bh={bh} n={n} d={d} {dt} causal={causal} K2 route "
        f"{routes[0]}, K3 route {routes[1]}: "
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


def k1_shifts(torch, fa, gen, n, d) -> None:
    """What the bf16 bar on K1's O would see if K1 skipped the ragged key
    tile (keys >= 64 * (n // 64)), or multiplied P V with one bf16 copy of
    P instead of its hi + lo split, at B*H = 16, bf16, non-causal."""
    q, k, v = [torch.randn((1, 16, n, d), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3)]
    ref = fa.flash_attention_reference(q, k, v)[0].float()
    bar = O_ATOL + O_RTOL * ref.abs()
    s = q.float() @ k.float().transpose(-1, -2) * d ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    single = (p.to(torch.bfloat16).float() @ v.float()) / p.sum(-1, keepdim=True)
    parts = [f"one bf16 P shifts O by {(single.to(torch.bfloat16).float() - ref).abs().max():.3e}"
             f" = {((single.to(torch.bfloat16).float() - ref).abs() / bar).max():.2f}x the bar"]
    start = 64 * (n // 64)
    if start < n:
        keep = torch.arange(n, device="cuda") < start
        pk = p * keep
        drop = ((pk @ v.float()) / pk.sum(-1, keepdim=True)).to(torch.bfloat16).float()
        parts.append(f"a dropped ragged key tile (keys {start}-{n - 1}) "
                     f"{(drop - ref).abs().max():.3e} = {((drop - ref).abs() / bar).max():.2f}x")
    log(f"[kernels] K1 at n={n} d={d} bf16: " + "; ".join(parts))


def k2_shifts(torch, fa, gen, n, d) -> None:
    """What the bf16 bar on K2's dq would see if dS K took one bf16 copy of
    dS instead of its hi + lo split, at B*H = 16, bf16, non-causal."""
    q, k, v, do, o, lse, delta = bwd_inputs(torch, fa, gen, 16, n, d, torch.bfloat16, False)
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, False)[0]
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    scale = d ** -0.5
    p = torch.exp(qf @ kf.transpose(-1, -2) * scale - lse.reshape(1, 16, n, 1))
    ds = p * (dof @ vf.transpose(-1, -2) - delta.reshape(1, 16, n, 1))
    single = ((ds.to(torch.bfloat16).float() @ kf) * scale).to(torch.bfloat16)
    shift, ratio = grad_violation(single, ref, "bfloat16")
    log(f"[kernels] K2 at n={n} d={d} bf16: one bf16 dS shifts dq by {shift:.3e} = "
        f"{ratio:.2f}x the bar")


def phase_kernels(torch, clock_hz: float) -> list:
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
        before = fa.LAUNCHES_MMA
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
        mma = fa.LAUNCHES_MMA - before
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
        ok = ok_o and err_lse <= LSE_BAR and mma == (dt == "bfloat16")
        log(f"[kernels] flash_attention_fwd bh={bh} n={n} d={d} {dt} causal={causal} route "
            f"{'tensor-core' if mma else 'scalar'}: max|dO|={err_o:.3e} (bar {bar}) "
            f"max|dlse|={err_lse:.3e} (bar {LSE_BAR}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("chip_smoke: flash_attention_fwd disagrees with its plain version")
        if (bh, n, d, dt, causal) == (16, 1125, 16, "bfloat16", False):
            k1_err = max(err_o, err_lse)
    for bh, n, d, dt, causal in cases:
        check_bwd(torch, fa, gen, bh, n, d, dt, dtypes[dt], causal)
    dropped_tile_shift(torch, fa, gen, 1125, 16)
    for n in (128, 563, 1125):
        k1_shifts(torch, fa, gen, n, 16)
    for n in (128, 563, 1125):
        k2_shifts(torch, fa, gen, n, 16)

    rows = [time_forward(torch, F, fa, qkv, clock_hz, k1_err)]
    rows += time_backward(torch, F, fa, gen, clock_hz)
    rows.append(int8_kernel_row(torch))
    return rows


def time_forward(torch, F, fa, qkv, clock_hz: float, err: float) -> dict:
    """K1 at the generation shape (B*H = 16: CFG-doubled batch 2 x 8 heads,
    N = 1125, D = 16, bf16) and at N = 4500 (a 2-minute window), both
    causal values, by device time beside the CUDA-event time of back-to-back
    calls, its plain version and SDPA's forward. The record row is the
    generation shape's, non-causal."""
    def sdpa(q, k, v, causal):
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal)

    row = None
    for n in (1125, 4500):
        bh, d = 16, 16
        q, k, v = qkv(bh, n, d, torch.bfloat16)
        for causal in (False, True):
            args = [(q, k, v, causal)]
            ms = device_ms(torch, fa.flash_attention_fwd, args, 200)
            event_ms = time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, causal), 200)
            plain_ms = device_ms(torch, fa.flash_attention_reference, args, 20)
            library_ms = device_ms(torch, sdpa, args, 200)
            library_event_ms = time_ms(torch, lambda: sdpa(q, k, v, causal), 200)
            if min(ms, plain_ms, library_ms) <= 0.0:
                raise SystemExit("chip_smoke: the profiler saw no device time for K1's timing")
            pairs = n * n if not causal else n * (n + 1) // 2
            flops = 4 * bh * pairs * d
            nbytes = 4 * bh * n * d * q.element_size() + bh * n * 4
            t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
            bound_ms = max(t_ops, t_bytes) * 1e3
            ex_ms = exp_bound_ms(bh, pairs, clock_hz)
            log(f"[kernels] K1 bh={bh} n={n} d={d} bf16 causal={causal}, device ms per call: "
                f"kernel {ms:.5f}, plain {plain_ms:.5f}, sdpa {library_ms:.5f}; bound "
                f"{bound_ms:.6f} ({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB), exp bound "
                f"{ex_ms:.6f} ({bh * pairs / 1e6:.3f} M ex2); back-to-back calls by CUDA "
                f"events {event_ms:.5f} (K1) and {library_event_ms:.5f} (sdpa) ms")
            if (n, causal) == (1125, False):
                row = {
                    "name": "flash_attention_fwd",
                    "route": "cuda",
                    "source": "jen1_tpu_torch/csrc/flash_attention_fwd.cu",
                    "replaces": "jen1_tpu/ops/flash_attention.py:45",
                    "max_abs_err": err,
                    "ms": ms,
                    "event_ms": event_ms,
                    "plain_ms": plain_ms,
                    "bound_ms": bound_ms,
                    "exp_bound_ms": ex_ms,
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "library_ms": library_ms,
                }
    return row


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
    for m, k, n in list(INT8_SHAPES) + list(INT8_RAGGED) + list(INT8_PASSES):
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


def time_backward(torch, F, fa, gen, clock_hz: float) -> list:
    """K2 and K3 at the train step's shape (B*H = 32, N = 1125, D = 16,
    bf16, both causal values), each checked once more, by device time
    beside the CUDA-event time of back-to-back calls, the plain backward
    (both gradients) and SDPA's backward (all three gradients together).
    The record rows are the non-causal ones."""
    bh, n, d = 32, 1125, 16
    rows = {}
    for causal in (False, True):
        q, k, v, do, o, lse, delta = bwd_inputs(torch, fa, gen, bh, n, d,
                                                torch.bfloat16, causal)
        errs = check_bwd(torch, fa, gen, bh, n, d, "bfloat16", torch.bfloat16, causal)
        args = [(q, k, v, do, lse, delta, causal)]
        timed = {}
        for name, fn in (("flash_attention_bwd_dq", fa.flash_attention_bwd_dq),
                         ("flash_attention_bwd_dkv", fa.flash_attention_bwd_dkv)):
            timed[name] = (device_ms(torch, fn, args, 100),
                           time_ms(torch, lambda: fn(*args[0]), 100))
        plain = device_ms(torch, fa.flash_attention_bwd_reference,
                          [(q, k, v, o, lse, do, causal)], 20)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)

        def sdpa_backward():
            return torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)

        sdpa = device_ms(torch, sdpa_backward, [()], 100)
        sdpa_event = time_ms(torch, sdpa_backward, 100)
        if min(plain, sdpa, *(t[0] for t in timed.values())) <= 0.0:
            raise SystemExit("chip_smoke: the profiler saw no device time for K2/K3's timing")
        # work this causal setting needs: N^2 pairs, or N(N+1)/2
        pairs = n * n if not causal else n * (n + 1) // 2
        es = q.element_size()
        ex_ms = exp_bound_ms(bh, pairs, clock_hz)
        for name, fl, nbytes, err in (
            ("flash_attention_bwd_dq", 6 * bh * pairs * d,
             5 * bh * n * d * es + 2 * bh * n * 4, errs["dq"][0]),
            ("flash_attention_bwd_dkv", 8 * bh * pairs * d,
             6 * bh * n * d * es + 2 * bh * n * 4, max(errs["dk"][0], errs["dv"][0])),
        ):
            ms, event_ms = timed[name]
            t_ops, t_bytes = fl / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
            bound = max(t_ops, t_bytes) * 1e3
            log(f"[kernels] {name} bh={bh} n={n} d={d} bf16 causal={causal}, device ms per "
                f"call: kernel {ms:.5f}, plain (dq+dk+dv) {plain:.5f}, sdpa backward "
                f"{sdpa:.5f}; bound {bound:.6f} ({fl / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB), "
                f"exp bound {ex_ms:.6f}; back-to-back calls by CUDA events {event_ms:.5f} "
                f"(kernel) and {sdpa_event:.5f} (sdpa backward) ms")
            if not causal:
                rows[name] = {
                    "name": name,
                    "route": "cuda",
                    "source": "jen1_tpu_torch/csrc/flash_attention_bwd.cu",
                    "replaces": ("jen1_tpu/ops/flash_attention.py:173"
                                 if name.endswith("dq") else
                                 "jen1_tpu/ops/flash_attention.py:222"),
                    "max_abs_err": err,
                    "ms": ms,
                    "event_ms": event_ms,
                    "plain_ms": plain,
                    "bound_ms": bound,
                    "exp_bound_ms": ex_ms,
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
    codec_cfg = EncodecConfig(**TINY_CODEC)

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


def synthetic_clip(np, seed: int, seconds: float, sr: int):
    """A seeded stereo clip (T, 2): two sines per channel plus noise."""
    g = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    freqs = g.uniform(40.0, 0.4 * sr, (2, 2))
    tones = sum(np.sin(2 * np.pi * freqs[:, i] * t[:, None] + g.uniform(0, 6.3))
                for i in range(2))
    return (0.3 * tones + 0.05 * g.standard_normal((len(t), 2))).astype(np.float32)


def code_gap(torch, rvq, latent) -> float:
    """The smallest distance from a frame's nearest codebook entry to the
    second nearest, over every frame and stage of `latent`'s encode."""
    residual, gap = latent.float(), float("inf")
    for i in range(rvq.n_q):
        d = rvq.distances(residual, i)
        two = d.topk(2, dim=-1, largest=False).values
        gap = min(gap, (two[..., 1] - two[..., 0]).min().item())
        residual = residual - rvq.codebooks[i][d.argmin(-1)]
    return gap


def phase_small_tasks(torch) -> None:
    """Inpainting and continuation at tiny widths, on the card against the
    CPU: the tiny pair of phase small, a seeded 13 s clip (520 latent
    frames), music_inpaint over 0.3-0.7 of it and music_cont of its first
    half (VDM), music_cont with GDM DDIM; x_T (and DDIM's step noise) from
    one CPU stream for both devices. Bar: rtol 2e-2 / atol 2e-3, as in
    phase small. Every K1 launch of a continuation is causal, none of an
    inpainting. The codec alone: the chunked (520 frames) and segmented
    encodes at 1e-4 + 1e-4*|ref| elementwise, the RVQ codes of one latent
    equal (its smallest best-to-second-best distance gap logged and held
    above 1e-3)."""
    import numpy as np

    from jen1_tpu_torch.diffusion import gdm, vdm
    from jen1_tpu_torch.ops import flash_attention as fa

    cpu, card = tiny_pair(torch)
    clip = synthetic_clip(np, 41, 13, 1600)
    x = torch.from_numpy(clip[None])
    for name in ("encode_latent_chunked", "encode_latent_segmented"):
        ref = getattr(cpu.codec, name)(x)
        out = getattr(card.codec, name)(x.to("cuda")).cpu()
        err = (out - ref).abs().max().item()
        ok = out.shape == ref.shape and bool(((out - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all())
        log(f"[small-tasks] codec {name} card vs CPU: shape {tuple(out.shape)} max|diff| "
            f"{err:.3e} (1e-4 + 1e-4*|ref|) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: the card's {name} disagrees with the CPU")
    z = cpu.codec.encode_latent_chunked(x, quantize=False)
    gap = code_gap(torch, cpu.codec.quantizer, z)
    same = torch.equal(card.codec.quantizer.encode(z.to("cuda")).cpu(),
                       cpu.codec.quantizer.encode(z))
    log(f"[small-tasks] RVQ codes of a (1, 520, 8) latent card vs CPU: "
        f"{'equal' if same else 'DIFFER'}; smallest distance gap {gap:.3e} (> 1e-3)")
    if not same or gap <= 1e-3:
        raise SystemExit("chip_smoke: the card's RVQ codes differ from the CPU's")

    stream = torch.Generator().manual_seed(7)
    x_t = torch.randn((1, 520, 8), generator=stream)
    noises = [torch.randn((1, 520, 8), generator=stream) for _ in range(4)]
    draws = (vdm.initial_noise, gdm.initial_noise, gdm.step_noise)
    vdm.initial_noise = gdm.initial_noise = lambda shape, generator, device: x_t.to(device)
    gdm.step_noise = lambda x, generator, index, uniform=False: noises[index].to(x.device)
    cases = [
        ("music_inpaint", "VDM", dict(task="music_inpaint", init_audio=clip,
                                      inpainting_scope=(0.3 * 13, 0.7 * 13))),
        ("music_cont", "VDM", dict(task="music_cont", init_audio=clip[: 13 * 800])),
        ("music_cont", "GDM DDIM", dict(task="music_cont", init_audio=clip[: 13 * 800],
                                        use_gdm=True)),
    ]
    try:
        for task, sampler, kw in cases:
            kw = dict(kw, seed=5, steps=4, seconds=13)
            ref = cpu.generate("a beautiful song", **kw)
            before = (fa.LAUNCHES, fa.LAUNCHES_CAUSAL)
            out = card.generate("a beautiful song", **kw)
            launched = fa.LAUNCHES - before[0]
            causal = fa.LAUNCHES_CAUSAL - before[1]
            err = float(np.abs(out - ref).max())
            ok = (out.shape == ref.shape == (1, 2, 13 * 1600) and np.isfinite(out).all()
                  and np.allclose(out, ref, rtol=2e-2, atol=2e-3) and launched > 0
                  and causal == (launched if task == "music_cont" else 0))
            log(f"[small-tasks] {task} ({sampler}) card vs CPU: max|diff|={err:.3e} "
                f"(rtol 2e-2, atol 2e-3); K1 launches {launched}, causal {causal} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"chip_smoke: the tiny {task} on the card disagrees with "
                                 "the CPU")
    finally:
        vdm.initial_noise, gdm.initial_noise, gdm.step_noise = draws


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


def phase_main(torch) -> tuple:
    """Returns the K1 launches of the two counted requests and the Jen1."""
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
    fa.LAUNCHES = fa.LAUNCHES_MMA = fa.LAUNCHES_DQ = fa.LAUNCHES_DKV = 0
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
    log(f"[main] peak device memory {torch.cuda.max_memory_allocated()} bytes; K1 launches "
        f"{total}, {fa.LAUNCHES_MMA} on the tensor-core route")
    for out in outs:
        if out.shape != (1, 2, samples) or not np.isfinite(out).all():
            raise SystemExit(f"chip_smoke: bad output shape {out.shape} or non-finite values")
    if np.array_equal(outs[0], outs[1]):
        raise SystemExit("chip_smoke: two prompts and seeds gave identical audio")
    if launches != [expected] * len(SLICE_PROMPTS):
        raise SystemExit(f"chip_smoke: flash launches per request {launches}, want {expected}")
    if bwd != (0, 0):
        raise SystemExit(f"chip_smoke: generation launched backward kernels {bwd}")
    if fa.LAUNCHES_MMA != total:
        raise SystemExit(f"chip_smoke: {total - fa.LAUNCHES_MMA} of {total} K1 launches "
                         "missed the tensor-core route")
    prompt, seed = SLICE_PROMPTS[0]
    by_name = profile_window(torch, "profile", f"{PROFILE_STEPS}-step request",
                             lambda: jen1.generate(prompt, seed=seed, steps=PROFILE_STEPS,
                                                   seconds=SLICE_SECONDS))
    log_kernel_time(by_name, "profile", ("flash_fwd_mma",), "K1", "the profiled request")
    return total, jen1


def sync_wall(torch, fn):
    """(result, seconds) of fn() between two synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_tasks(torch, jen1) -> int:
    """Inpainting and continuation at full width (the phase-main Jen1,
    longform_config(), VDM, B=1): a seeded 30 s clip at 48 kHz, inpainted
    over TASKS_SCOPE, and its first TASKS_CONT_SECONDS continued to 30 s.
    Each request runs once short (warm-up) and once at SLICE_STEPS, counted:
    K1 launches 2 per UNet forward, all on the tensor-core route, the
    continuation's all causal and the inpainting's none, no backward
    kernel. Then the 30 s encode chunked against whole-clip, the bf16
    chunked decode against the fp32 one, and one PROFILE_STEPS
    continuation under torch.profiler. Returns the counted K1 launches."""
    import numpy as np

    from jen1_tpu_torch.ops import flash_attention as fa

    sr = jen1.sample_rate
    clip = synthetic_clip(np, TASKS_SEED, SLICE_SECONDS, sr)
    samples = SLICE_SECONDS * sr
    requests = [
        ("music_inpaint", dict(task="music_inpaint", init_audio=clip,
                               inpainting_scope=TASKS_SCOPE), 0),
        ("music_cont", dict(task="music_cont", init_audio=clip[: TASKS_CONT_SECONDS * sr]),
         2 * SLICE_STEPS),
    ]
    expected = 2 * SLICE_STEPS
    total = 0
    torch.cuda.reset_peak_memory_stats()
    for task, kw, want_causal in requests:
        prompt, seed = SLICE_PROMPTS[0]
        _, wall = sync_wall(torch, lambda: jen1.generate(
            prompt, seed=seed, steps=PROFILE_STEPS, seconds=SLICE_SECONDS, **kw))
        log(f"[tasks] {task} warm-up ({PROFILE_STEPS} steps) {wall:.3f} s")
        fa.LAUNCHES = fa.LAUNCHES_MMA = fa.LAUNCHES_CAUSAL = 0
        fa.LAUNCHES_DQ = fa.LAUNCHES_DKV = 0
        out, wall = sync_wall(torch, lambda: jen1.generate(
            prompt, seed=seed, steps=SLICE_STEPS, seconds=SLICE_SECONDS, **kw))
        counts = (fa.LAUNCHES, fa.LAUNCHES_MMA, fa.LAUNCHES_CAUSAL)
        bwd = (fa.LAUNCHES_DQ, fa.LAUNCHES_DKV)
        total += counts[0]
        phases = " ".join(f"{k}={v:.4f}" for k, v in jen1.last_timings.items())
        finite = bool(np.isfinite(out).all())
        log(f"[tasks] {task} request seed={seed}, {SLICE_STEPS} steps: wall {wall:.4f} s; "
            f"phases (s): {phases}; K1 launches {counts[0]}, tensor-core {counts[1]}, causal "
            f"{counts[2]}; backward launches {bwd}; shape {out.shape}; finite {finite}; rms "
            f"{float(np.sqrt((out.astype(np.float64) ** 2).mean())):.4e}")
        if out.shape != (1, 2, samples) or not finite:
            raise SystemExit(f"chip_smoke: {task} gave shape {out.shape} or non-finite values")
        if counts != (expected, expected, want_causal) or bwd != (0, 0):
            raise SystemExit(f"chip_smoke: {task} K1 launches (all, tensor-core, causal) "
                             f"{counts}, backward {bwd}; want ({expected}, {expected}, "
                             f"{want_causal}), (0, 0)")
    log(f"[tasks] peak device memory {torch.cuda.max_memory_allocated()} bytes")

    audio = torch.from_numpy(clip[None]).to("cuda")
    walls = {}
    for name in ("encode_latent_chunked", "encode_latent"):
        fn = getattr(jen1.codec, name)
        fn(audio)  # warm-up
        latent, walls[name] = sync_wall(torch, lambda: fn(audio))
        log(f"[tasks] 30 s encode {name}: wall {walls[name]:.4f} s, latent "
            f"{tuple(latent.shape)}, finite {bool(torch.isfinite(latent).all())}")
        if not bool(torch.isfinite(latent).all()):
            raise SystemExit(f"chip_smoke: {name} gave non-finite values")
    log(f"[tasks] whole-clip / chunked encode wall: "
        f"{walls['encode_latent'] / walls['encode_latent_chunked']:.3f}")
    cc = jen1.codec.config
    z = torch.randn((1, int(SLICE_SECONDS * cc.frame_rate), cc.dimension),
                    generator=torch.Generator(device="cuda").manual_seed(TASKS_SEED),
                    device="cuda")
    outs = {}
    for dtype in (None, torch.bfloat16):
        jen1.codec.decode_latent_chunked(z, dtype=dtype)  # warm-up
        outs[dtype], wall = sync_wall(torch, lambda: jen1.codec.decode_latent_chunked(
            z, dtype=dtype))
        log(f"[tasks] chunked decode of a {tuple(z.shape)} latent, "
            f"{'bf16' if dtype else 'fp32'} decoder: wall {wall:.4f} s")
    rel = ((outs[torch.bfloat16] - outs[None]).abs().max()
           / outs[None].abs().max()).item()
    log(f"[tasks] chunked_bf16 vs chunked: max|diff| / max|fp32| = {rel:.4e}")
    if not bool(torch.isfinite(outs[torch.bfloat16]).all()):
        raise SystemExit("chip_smoke: the bf16 chunked decode gave non-finite values")

    prompt, seed = SLICE_PROMPTS[0]
    cont = requests[1][1]
    by_name = profile_window(torch, "tasks-profile", f"{PROFILE_STEPS}-step music_cont request",
                             lambda: jen1.generate(prompt, seed=seed, steps=PROFILE_STEPS,
                                                   seconds=SLICE_SECONDS, **cont))
    log_kernel_time(by_name, "tasks-profile", ("flash_fwd_mma",), "causal K1",
                    "the profiled continuation")
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
        f"{sum(n for n, _ in k4)} kernel launches")
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


def log_kernel_time(by_name: dict, tag: str, keys, what: str, where: str) -> None:
    """The device time and launches of the kernels whose names hold a key."""
    hits = [(n, t) for name, (n, t) in by_name.items() if any(key in name for key in keys)]
    log(f"[{tag}] {what} device time {sum(t for _, t in hits):.6f} s in "
        f"{sum(n for n, _ in hits)} launches in {where}")


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
    fa.LAUNCHES_MMA = fa.LAUNCHES_DQ_MMA = fa.LAUNCHES_DKV_MMA = 0
    walls, per_step = [], []
    for i in range(1, TRAIN_STEPS + 1):
        b = launch_counts()
        walls.append(step(TRAIN_WARMUP + i, i)[1])
        per_step.append(tuple(a - c for a, c in zip(launch_counts(), b)))
    total = launch_counts()
    mma = (fa.LAUNCHES_MMA, fa.LAUNCHES_DQ_MMA, fa.LAUNCHES_DKV_MMA)
    med = statistics.median(walls)
    log(f"[train] {TRAIN_STEPS} timed steps: wall median {med:.4f} s, min {min(walls):.4f} s, "
        f"max {max(walls):.4f} s; audio-seconds trained per second "
        f"{TRAIN_BATCH * TRAIN_SECONDS / med:.3f}; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes; K1/K2/K3 launches per step {per_step}; "
        f"K1/K2/K3 on the tensor-core route {mma} of {total}")
    if any(s != (TRAIN_LAUNCHES,) * 3 for s in per_step):
        raise SystemExit(f"chip_smoke: K1/K2/K3 launches per step {per_step}, "
                         f"want {TRAIN_LAUNCHES} each")
    if mma != total:
        raise SystemExit(f"chip_smoke: K1/K2/K3 launches on the tensor-core route {mma}, "
                         f"want {total}")
    by_name = profile_window(torch, "train-profile", "one train step",
                             lambda: step(TRAIN_WARMUP + TRAIN_STEPS + 1, TRAIN_STEPS + 1))
    log_kernel_time(by_name, "train-profile", ("flash_fwd_mma", "flash_bwd_dkv_mma"), "K1+K3",
                    "the profiled step")
    log_kernel_time(by_name, "train-profile", ("flash_bwd_dq_mma",), "K2", "the profiled step")
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
    rows = phase_kernels(torch, device["sm_clock_hz"])
    phase_small(torch)
    phase_small_gdm(torch)
    phase_small_train(torch)
    phase_small_tasks(torch)
    k1_generation, jen1 = phase_main(torch)
    k1_generation += phase_tasks(torch, jen1)
    del jen1
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
