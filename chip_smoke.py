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
                   shape, at N = 4500, at the serving batch (B*H 64) and at
                   the STFT UNet's level 1 (N = 1407; checked there too), K2/K3
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
  7. small-ckpt  - a tiny trainer (with EMA) on the card takes 2 steps, saves
                   its state (CheckpointManager), and a fresh trainer restores
                   it bit for bit; both take one more step with the same
                   draws (losses and gradient leaves at the small-train
                   bars). Jen1(ckpt_path=dir, use_ema_params=True) loads the
                   saved EMA, and its 2-step bf16-compute generate() with
                   weights_dtype="bfloat16" equals the fp32-weights one.
  8. small-tasks - the tiny slice's music_inpaint and music_cont (VDM) and
                   music_cont (GDM DDIM) of a seeded clip on the card against
                   the CPU (same weights and draws), with their causal K1
                   launches; the codec's chunked and segmented encodes and
                   the RVQ codes on the card against the CPU.
  9. small-long  - the tiny pair's generate_long_stream (three 13 s windows,
                   4 s of context) on the card against the CPU's
                   generate_long with the same weights and draws, K1 launches
                   per window (the continuation windows' all causal);
                   save_audio to WAV (reads back as its int16 quantization)
                   and FLAC (STREAMINFO checked).
 10. small-reuse - the tiny pair's UNet forward with its encoder cache (output
                   and every cache leaf) on the card against the CPU; DDIM and
                   DPM-Solver++ at encoder_reuse 2 and 3, 5 and 6 steps, fp32
                   and bf16 compute, card against CPU with the same draws,
                   K1 launches per request as reuse_schedule gives them.
 11. small-serve - the tiny card Jen1 behind GenerationService and its HTTP
                   server on 127.0.0.1: co-batching, a seeded request equal
                   to lane 0 of generate(), /healthz, /generate (WAV, npy),
                   /generate_long, 503 under overload, close() draining;
                   batch_generate on 3 prompts.
 12. main        - Jen1(longform_config()).generate(): one warm-up request,
                   then two timed requests (100 steps, 30 s, B=1); checks
                   shapes, finiteness and K1 launches, every one on the
                   tensor-core route; then one more request under
                   torch.profiler for the device's busy share and K1's
                   device time.
 13. tasks       - the same Jen1: music_inpaint of a seeded 30 s clip over
                   10-20 s and music_cont of its first 10 s to 30 s, 100 VDM
                   steps each after a short warm-up: walls, phase walls
                   (encode included), peak memory, K1 launches (200 each,
                   all on the tensor-core route, the continuation's all
                   causal); the 30 s encode chunked against whole-clip; the
                   bf16 chunked decode against the fp32 one; one 10-step
                   continuation under torch.profiler, then the chunked
                   encode and the chunked decode each under torch.profiler
                   (their fp32 GEMM launches: the codec LSTMs' steps).
 14. long        - the same Jen1: generate_long_stream over 70 s (three 30 s
                   windows, 10 s of context, 100 VDM steps each): the wall
                   to the first chunk, each window's wall and phase walls,
                   peak memory, K1 launches (600, all on the tensor-core
                   route, 400 causal); save_audio to WAV and FLAC: walls and
                   bytes.
 15. bf16-weights- a second Jen1(longform_config(), weights_dtype="bfloat16")
                   with the same seed: the UNet's weight bytes, then paired
                   100-step 30 s requests (fp32, bf16): walls,
                   peak memory, max|diff| (0 expected: bf16 storage under
                   bf16 compute is bit-identical).
 16. reuse       - the same Jen1, GDM, 30 s, 100 steps: DDIM at encoder_reuse
                   1 and 2 and DPM-Solver++ at 2: walls, the relative L2
                   of each latent and audio from k = 1, K1 launches (200,
                   151, 150: reuse_schedule's count, all tensor-core); the
                   device busy seconds of a 10-step request at k = 1 and 2.
 17. serve       - the same Jen1 behind GenerationService(max_batch 4,
                   max_wait_ms 200, 30 s, 100 DDIM steps): a 10-step warm-up
                   batch, 6 requests at once (2 batches, 2 padded lanes), a
                   seeded request twice, one POST /generate over HTTP: latencies,
                   batch walls, audio-s per wall-s, phase_totals, peak
                   memory, K1 launches, stats; the busy share of a 10-step
                   B=4 request.
 18. flagship    - Jen1(Config()) with the UNet's convs quantized at the
                   default thresholds: the census, one UNet forward at
                   (2, 4500, 128) with K4, with the plain version and with
                   fp32 weights; one warm-up and two timed 100-step 30 s
                   DDIM requests (K4 launches, shapes, finiteness), one
                   request with fp32 weights, one 10-step request under
                   torch.profiler.
 19. train       - UnifiedMultiTaskTrainer under longform_config() at 30 s
                   windows, B=3, GDM, fused AdamW, full width: 2 warm-up
                   steps, 5 timed steps, launches of K1/K2/K3 per step (all
                   on the tensor-core route), and one more step under
                   torch.profiler with K1+K3's and K2's device time; then
                   the whole train state (305 M parameters, AdamW moments)
                   saved by CheckpointManager and restored into a fresh
                   trainer: bytes, walls, free disk; one more step on each,
                   with the same draws, gives equal losses (train bars); then
                   a remat=True trainer takes the same state and both take two
                   steps with the same draws: losses and gradient leaves at
                   the train bars, walls and peak memory of every step,
                   K1/K2/K3 8/4/4 per remat step.
 20. small-data  - two WAV and one FLAC file (48 kHz stereo, sidecar prompts)
                   written by the port's writers; the native decoders built
                   from native/*.cpp; load_audio against the written samples;
                   preprocess scan, and preprocess encode on the card against
                   the CPU with one tiny codec.
 21. small-lora  - a tiny LoRATrainer (rank 4) takes two steps on the card and
                   on the CPU with the same base, adapter and draws, plain and
                   with remat: losses and adapter gradients, base unchanged;
                   Jen1(ckpt_path=base, lora_path=run) generates, card vs CPU.
 22. small-composer - a tiny track_gen train step and a tiny generate_tracks
                   with one context track, card vs CPU.
 23. lora        - LoRA at full width (longform_config(), rank 16, B=3, 30 s):
                   three steps, K1/K2/K3 4/4/4 each on the tensor-core route;
                   walls, peak memory, adapter and checkpoint bytes;
                   Jen1(lora_path=...) load-and-merge wall and merged weights.
 24. wav-train   - four 30 s WAV files; train.run(dataset_dir=...) for 5
                   steps with profile=True: encode and step walls, K1/K2/K3
                   4/4/4 per step, the trace naming the port's kernels.
 25. composer    - Jen1(composer_config(4)).generate_tracks at 30 s, GDM DDIM
                   cut to 20 steps, one context track: wall, peak memory, K1
                   launches.
 26. small-features - tiny widths, card against CPU: Snake generate() (VDM,
                   DDIM) and a Snake train step (alpha gradients included),
                   the .pth export -> import round trip, the STFT's DC phase
                   sign and STFT UNet forwards with and without
                   use_stft_context, the three-type MultiConditioner and a
                   UNet with global features, log-mel FAD, SNR, spectral
                   convergence and a random VGGish's embeddings.
 27. snake       - Jen1(longform_config(), use_snake=True): two 100-step 30 s
                   VDM requests (walls, peak memory, K1 200 each, all
                   tensor-core), device kernels of a profiled 10-step request
                   against phase main's, export to a reference .pth read back
                   by Jen1(ckpt_path=...) bit for bit (bf16 weights keep alpha
                   fp32), two train steps at B = 3 (K1/K2/K3 4/4/4, alpha
                   gradients finite and nonzero).
 28. stft        - UNetCFG1d at longform widths with use_stft and
                   use_stft_context on 30 s of 48 kHz stereo, B = 1 with batch
                   CFG: forward walls, peak memory, output shape, K1 at the
                   level-1 length 1407 (4 launches in two forwards).
 29. eval        - phase main's and phase snake's requests as WAV; run_eval on
                   the card and on the CPU (log-mel FAD, SNR, spectral
                   convergence) and a random VGGish FAD on both: walls,
                   card against CPU.
The phases run in the order small-*, main .. serve, flagship, train, lora,
wav-train, composer, snake, stft, eval (small-data, small-lora,
small-composer and small-features after small-serve). The line before the
last is the `{"kernels": [...]}` record;
the last line
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
# long-form: three 30 s windows with 10 s of context make 70 s
LONG_TOTAL_SECONDS = 70
LONG_WINDOW_SECONDS = 30
LONG_CONTEXT_SECONDS = 10
LONG_WINDOWS = 3
# the tiny long-form: 13 s windows (520 latent frames: the level-1
# transformer's 130 frames take the flash path), 4 s of context, 29 s
SMALL_LONG = dict(total_seconds=29, window_seconds=13, context_seconds=4, seed=5, steps=4)
# bf16-weights: the storages of its paired requests, in order (since the
# serving phases joined, one pair, to keep the run under ten minutes)
BF16_ORDER = ("fp32", "bf16")
# encoder reuse at full width: DDIM requests at these k (k = 1 first and
# last, to pair the walls), then DPM-Solver++ at REUSE_DPM_K
REUSE_KS = (1, 2)  # each once, to keep the whole run well under ten minutes
REUSE_DPM_K = 2
# the tiny reuse cases: k x S (S % k == 0 and not) x compute dtype
SMALL_REUSE_KS = (2, 3)
SMALL_REUSE_STEPS = (5, 6)
# serving: GenerationService(max_batch=SERVE_BATCH, max_wait_ms=SERVE_WAIT_MS)
# over the phase-main Jen1, GDM DDIM; SERVE_REQUESTS default-seed requests
# at once (one full batch and one padded); K1 sees the CFG-doubled batch
# x 8 heads
SERVE_BATCH = 4
SERVE_WAIT_MS = 200.0
SERVE_REQUESTS = 6
SERVE_BH = 2 * SERVE_BATCH * 8
SERVE_SEED = 77
# the tiny slice's codec: 1600 Hz, a 40-sample hop, a 2 x 16-entry RVQ
TINY_CODEC = dict(sample_rate=1600, channels=2, dimension=8, n_filters=2, ratios=(5, 4, 2),
                  n_q=2, bins=16)
# the LoRA, wav-train and composer phases (full width)
LORA_RANK = 16
LORA_ALPHA = 16.0
LORA_STEPS = 3
WAV_FILES = 4
WAV_STEPS = 5
COMPOSER_TRACKS = 4
COMPOSER_STEPS = 20  # cut from 100 to keep the run's time
COMPOSER_SECONDS = 30
# Snake at full width: longform_config() with use_snake (and tied transformer
# projections, which the reference .pth layout needs), two 100-step 30 s VDM
# requests (SLICE_PROMPTS, as phase main), two train steps at B = 3
SNAKE_TRAIN_STEPS = 2
# the STFT-domain UNet: 30 s of 48 kHz stereo is 5625 STFT frames (hop 256),
# 1407 at level 1 after the factor-4 downsample, where K1 runs
STFT_SECONDS = 30
STFT_N = 1407
# small-features: Snake alphas drawn from U(0.5, 1.5), as a trained Snake keeps them
SMALL_ALPHA_SEED = 3
# eval: the random VGGish weights' seed
VGGISH_SEED = 0


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
    # the serving batch: max_batch 4, CFG-doubled, 8 heads
    cases += [(SERVE_BH, 1125, 16, dt, c) for dt in ("bfloat16", "float32")
              for c in (False, True)]
    # the STFT-domain UNet's level 1 (phase stft)
    cases += [(16, STFT_N, 16, dt, c) for dt in ("bfloat16", "float32") for c in (False, True)]
    k1_err = serve_err = stft_err = 0.0
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
        if (bh, n, d, dt, causal) == (SERVE_BH, 1125, 16, "bfloat16", False):
            serve_err = max(err_o, err_lse)
        if (bh, n, d, dt, causal) == (16, STFT_N, 16, "bfloat16", False):
            stft_err = max(err_o, err_lse)
    for bh, n, d, dt, causal in cases:
        check_bwd(torch, fa, gen, bh, n, d, dt, dtypes[dt], causal)
    dropped_tile_shift(torch, fa, gen, 1125, 16)
    for n in (128, 563, 1125):
        k1_shifts(torch, fa, gen, n, 16)
    for n in (128, 563, 1125):
        k2_shifts(torch, fa, gen, n, 16)

    rows = [time_forward(torch, F, fa, qkv, clock_hz, k1_err, serve_err, stft_err)]
    rows += time_backward(torch, F, fa, gen, clock_hz)
    rows.append(int8_kernel_row(torch))
    return rows


def time_forward(torch, F, fa, qkv, clock_hz: float, err: float, serve_err: float,
                 stft_err: float) -> dict:
    """K1 at the generation shape (B*H = 16: CFG-doubled batch 2 x 8 heads,
    N = 1125, D = 16, bf16), at N = 4500 (a 2-minute window), at the
    serving batch (B*H = SERVE_BH at N = 1125) and at the STFT UNet's level 1
    (N = STFT_N), both causal values, by device time beside the CUDA-event
    time of back-to-back calls, its plain version and SDPA's forward. The
    record row is the generation shape's, non-causal; its "serving_shape"
    and "stft_shape" entries hold those shapes'."""
    def sdpa(q, k, v, causal):
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal)

    row = None
    shapes = {}
    for bh, n in ((16, 1125), (16, 4500), (SERVE_BH, 1125), (16, STFT_N)):
        d = 16
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
            if (bh, n, causal) in ((SERVE_BH, 1125, False), (16, STFT_N, False)):
                key = "serving_shape" if bh == SERVE_BH else "stft_shape"
                shapes[key] = {"bh": bh, "n": n, "d": d, "ms": ms, "plain_ms": plain_ms,
                               "max_abs_err": serve_err if bh == SERVE_BH else stft_err,
                               "bound_ms": bound_ms, "exp_bound_ms": ex_ms,
                               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                               "library_ms": library_ms}
            if (bh, n, causal) == (16, 1125, False):
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
    row.update(shapes)
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


def device_ms(torch, fn, args, iters: int, attempts: int = 3) -> float:
    """Mean device time per call of `fn(*args[i % len(args)])`: the CUDA
    kernel time it launched, summed by torch.profiler, over `iters` calls.
    At K4's shapes a call's kernels take a few us, less than the host takes
    to enqueue it, so CUDA events around back-to-back calls time the host.
    A window in which the profiler recorded no device event at all (it
    happens, rarely, with kernels that did run) is measured again, up to
    `attempts` windows; 0.0 if none recorded one, which the callers
    refuse."""
    from torch.profiler import ProfilerActivity, profile

    for a in args[:3]:
        fn(*a)
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(*args[i % len(args)])
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            return sum(e.time_range.elapsed_us() for e in kernels) * 1e-3 / iters
        log(f"[kernels] the profiler recorded no device event in window {attempt} of "
            f"{attempts} for {getattr(fn, '__name__', 'a call')}")
    return 0.0


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


def tiny_pair(torch, dtype: str = "float32", cfg=None, codec=TINY_CODEC, **jen1_kw):
    """Two tiny Jen1s, on the CPU and on the card, with the same T5, UNet
    and codec weights: tiny_test_config widths, `dtype` compute (fp32 by
    default), one attention head and flash_min_seq_len 128, a 1600 Hz codec
    with a 40-sample hop; or the config `cfg` and the codec `codec`.
    `jen1_kw` (a checkpoint, an adapter) go to both constructors."""
    import dataclasses

    from jen1_tpu_torch.api.generation import Jen1
    from jen1_tpu_torch.codec.model import EncodecConfig, EncodecModel
    from jen1_tpu_torch.conditioning.conditioners import MultiConditioner, T5Conditioner
    from jen1_tpu_torch.config import tiny_test_config

    if cfg is None:
        cfg = tiny_test_config()
        # one head, so the level-1 transformer (16 channels) has head dim 16
        cfg.model_config = dataclasses.replace(
            cfg.model_config, use_flash_attention=True, flash_min_seq_len=128,
            attention_heads=1, dtype=dtype,
        )
    codec_cfg = EncodecConfig(**codec)

    def build(device):
        t5 = T5Conditioner(16, "tiny-test", cfg.model_config.context_embedding_max_length,
                           device=device)
        return Jen1(sample_rate=1600, config=cfg, codec=EncodecModel(codec_cfg, device=device),
                    conditioner=MultiConditioner({"prompt": t5}), device=device, **jen1_kw)

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


def phase_small_ckpt(torch) -> None:
    """Checkpoints at tiny widths on the card: a tiny trainer with EMA
    (tiny_train_config, fused AdamW) takes 2 steps and saves its state; a
    fresh trainer restores it, every tensor bit-identical to the saved one;
    then both take one more step with the same batch and draws, held to
    the small-train bars (losses rtol 2e-3, every gradient leaf within
    5e-3 * max|g| of the first trainer's). Jen1(ckpt_path=dir,
    use_ema_params=True) holds the saved EMA bit for bit; under bf16
    compute its 2-step generate() with weights_dtype="bfloat16" must equal
    the fp32-weights one exactly."""
    import copy
    import dataclasses

    import numpy as np

    from jen1_tpu_torch.api.generation import Jen1
    from jen1_tpu_torch.ckpt.checkpoint import CheckpointManager
    from jen1_tpu_torch.codec.model import EncodecConfig, EncodecModel
    from jen1_tpu_torch.train.train import build_trainer
    from jen1_tpu_torch.train.trainer import step_generator

    cfg = tiny_train_config()
    cfg.use_ema, cfg.ema_decay = True, 0.5
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in tiny_batch(cfg.model_config).items()}

    def step(trainer, state, i: int):
        return trainer.train_step(state, batch, step_generator("cuda", 0, i),
                                  np.random.default_rng((0, i)))

    trainer = build_trainer(cfg, device="cuda")
    state = trainer.init_state()
    for i in range(2):
        state, _ = step(trainer, state, i)
    saved = {k: v.clone() for k, v in trainer.state_dict(state).items()}
    with scratch_dir() as d:
        CheckpointManager(d).save(state.step, trainer.state_dict(state), loss=0.0)
        fresh = build_trainer(cfg, device="cuda")
        flat, _ = CheckpointManager(d).restore(map_location="cuda")
        fresh_state = fresh.load_state_dict(flat)
        identical = all(torch.equal(t, saved[k]) for k, t in fresh.state_dict(fresh_state).items())
        _, m_a = step(trainer, state, 2)
        _, m_b = step(fresh, fresh_state, 2)
        losses_ok = all(np.isclose(float(m_b[k]), float(m_a[k]), rtol=2e-3, atol=0)
                        for k in m_a if k.startswith("loss"))
        worst, worst_name = worst_grad_leaf(fresh.model, [p.grad for p in trainer.params])
        log(f"[small-ckpt] {len(saved)} tensors saved at step 2 and restored: "
            f"{'bit-identical' if identical else 'DIFFER'}; step 3 loss/train "
            f"{float(m_a['loss/train']):.6f} (saving trainer) vs {float(m_b['loss/train']):.6f} "
            f"(restored); worst gradient leaf {worst_name} at {worst:.4f} of its bar")
        if not identical or not losses_ok or worst > 1.0:
            raise SystemExit("chip_smoke: the restored tiny trainer differs from the saved one")

        gcfg = copy.deepcopy(cfg)
        gcfg.model_config = dataclasses.replace(gcfg.model_config, dtype="bfloat16")
        codec = EncodecModel(EncodecConfig(**TINY_CODEC), device="cuda")
        jen1 = {dtype: Jen1(d, sample_rate=1600, config=gcfg, codec=codec, use_ema_params=True,
                            weights_dtype=dtype, device="cuda")
                for dtype in ("float32", "bfloat16")}
    ema = all(torch.equal(p, saved[f"ema_params/{n}"])
              for n, p in jen1["float32"].model.named_parameters())
    outs = {dtype: j.generate("a beautiful song", seed=5, steps=2, seconds=13)
            for dtype, j in jen1.items()}
    diff = float(np.abs(outs["float32"] - outs["bfloat16"]).max())
    n_bf16 = sum(p.dtype == torch.bfloat16 for p in jen1["bfloat16"].model.parameters())
    log(f"[small-ckpt] Jen1(ckpt_path, use_ema_params=True) holds the saved EMA: {ema}; "
        f"bf16-compute generate() with bf16 weights ({n_bf16} tensors bf16) vs fp32 weights: "
        f"shape {outs['bfloat16'].shape}, max|diff| = {diff:.3e} (want 0)")
    if not ema or diff != 0.0 or not np.isfinite(outs["float32"]).all():
        raise SystemExit("chip_smoke: the checkpoint-loaded tiny Jen1 failed its checks")


def flac_streaminfo(data: bytes):
    """(sample rate, channels, bits, total samples) of a FLAC's STREAMINFO."""
    if data[:4] != b"fLaC" or data[4] & 0x7F != 0:
        raise SystemExit("chip_smoke: the FLAC file does not start with STREAMINFO")
    bits = int.from_bytes(data[18:26], "big")
    return bits >> 44, ((bits >> 41) & 7) + 1, ((bits >> 36) & 31) + 1, bits & ((1 << 36) - 1)


def save_both(out, sample_rate: int, tag: str):
    """save_audio of `out` to WAV and FLAC in a scratch directory: logs
    walls and bytes, checks that the WAV reads back as the int16
    quantization of example 0 and that the FLAC's STREAMINFO holds its
    rate, channels and length. Returns {ext: (wall s, bytes)}."""
    import numpy as np

    from jen1_tpu_torch.api.generation import save_audio
    from jen1_tpu_torch.data.audio_io import read_wav

    result = {}
    with scratch_dir() as d:
        for ext in ("wav", "flac"):
            path = str(Path(d) / f"out.{ext}")
            t0 = time.perf_counter()
            save_audio(out, path, sample_rate)
            wall = time.perf_counter() - t0
            data = Path(path).read_bytes()
            result[ext] = (wall, len(data))
            if ext == "wav":
                back, sr = read_wav(path)
                want = (np.clip(out[0].T, -1, 1) * 32767.0).astype(np.int16)
                ok = sr == sample_rate and np.array_equal(back, want.astype(np.float32) / 32768.0)
            else:
                ok = flac_streaminfo(data) == (sample_rate, out.shape[1], 16, out.shape[-1])
            log(f"[{tag}] save_audio .{ext}: wall {wall:.3f} s, {len(data)} bytes, "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"chip_smoke: save_audio .{ext} wrote a bad file")
    return result


def phase_small_long(torch) -> None:
    """Long-form at tiny widths, on the card against the CPU: the tiny pair
    of phase small, generate_long_stream over SMALL_LONG (three 13 s
    windows, 4 s of context) on the card, generate_long on the CPU, each
    window's x_T from one CPU stream for both devices. Bar: rtol 2e-2 /
    atol 2e-3, as in phase small. K1 per window: 2 per UNet forward x 4
    steps, the continuation windows' all causal. Then save_audio to WAV and
    FLAC."""
    import numpy as np

    from jen1_tpu_torch.diffusion import vdm
    from jen1_tpu_torch.ops import flash_attention as fa

    cpu, card = tiny_pair(torch)
    stream = torch.Generator().manual_seed(7)
    noises = [torch.randn((1, 520, 8), generator=stream) for _ in range(3)]
    draw = vdm.initial_noise

    def feed():
        it = iter(noises)
        vdm.initial_noise = lambda shape, generator, device: next(it).to(device)

    try:
        feed()
        ref = cpu.generate_long("a beautiful song", **SMALL_LONG)
        feed()
        chunks, per_window = [], []
        fa.LAUNCHES = fa.LAUNCHES_CAUSAL = 0
        seen = (0, 0)
        for chunk in card.generate_long_stream("a beautiful song", **SMALL_LONG):
            now = (fa.LAUNCHES, fa.LAUNCHES_CAUSAL)
            per_window.append((now[0] - seen[0], now[1] - seen[1]))
            seen = now
            chunks.append(chunk)
    finally:
        vdm.initial_noise = draw
    out = np.concatenate(chunks, axis=-1)
    k1 = 2 * SMALL_LONG["steps"]
    want = [(k1, 0)] + [(k1, k1)] * 2
    err = float(np.abs(out - ref).max())
    ok = (out.shape == ref.shape == (1, 2, 29 * 1600) and np.isfinite(out).all()
          and np.allclose(out, ref, rtol=2e-2, atol=2e-3) and per_window == want)
    log(f"[small-long] generate_long_stream card vs generate_long CPU: {len(chunks)} chunks "
        f"{[c.shape[-1] for c in chunks]}, shape {out.shape}, max|diff|={err:.3e} (rtol 2e-2, "
        f"atol 2e-3); K1 launches (all, causal) per window {per_window} (want {want}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: the tiny long-form output on the card disagrees with "
                         "the CPU")
    save_both(out, 1600, "small-long")


def launch_counts():
    from jen1_tpu_torch.ops import flash_attention as fa

    return fa.LAUNCHES, fa.LAUNCHES_DQ, fa.LAUNCHES_DKV


def worst_grad_leaf(model, refs):
    """(largest share of its bar, leaf name) of `model`'s gradient leaves
    against `refs`: each leaf within 5e-3 * max|ref| of the leaf, that
    scale floored at GRAD_LEAF_FLOOR of the largest leaf's."""
    floor = GRAD_LEAF_FLOOR * max(r.abs().max().item() for r in refs)
    worst, worst_name = 0.0, ""
    for (name, p), ref in zip(model.named_parameters(), refs):
        bar = 5e-3 * max(ref.abs().max().item(), floor)
        ratio = (p.grad.cpu() - ref.cpu()).abs().max().item() / bar
        if ratio >= worst:
            worst, worst_name = ratio, name
    return worst, worst_name


def scratch_dir():
    """A temporary directory under build/ (which .gitignore lists)."""
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    return tempfile.TemporaryDirectory(dir=ROOT / "build")


def tiny_train_config():
    """tiny_test_config widths, fp32, flash_min_seq_len 128 and the tiny T5:
    the level-1 transformer's 130 frames at L = 520 take the flash path
    with head dim 8, zero-padded to 16."""
    import dataclasses

    from jen1_tpu_torch.config import tiny_test_config

    cfg = tiny_test_config()
    cfg.model_config = dataclasses.replace(cfg.model_config, use_flash_attention=True,
                                           flash_min_seq_len=128)
    cfg.conditioner_config.t5_config.t5_model_name = "tiny-test"
    cfg.conditioner_config.t5_config.max_length = cfg.model_config.context_embedding_max_length
    return cfg


def tiny_batch(mc):
    """A seeded host batch of 3 at L = 520 with one half-masked prompt."""
    import numpy as np

    g = np.random.default_rng(0)
    m = mc.context_embedding_max_length
    mask = np.ones((3, m), bool)
    mask[-1, m // 2:] = False
    return {
        "latents": g.standard_normal((3, 520, mc.in_channels)).astype(np.float32),
        "text_emb": g.standard_normal((3, m, mc.context_embedding_features)).astype(np.float32),
        "text_mask": mask,
    }


def phase_small_train(torch) -> None:
    """One train step of a tiny trainer (tiny_test_config widths, fp32,
    flash_min_seq_len 128, so the level-1 transformer's 130 frames at
    L = 520 take the flash path with head dim 8, zero-padded to 16) on the
    card against the CPU: same weights, same batch, same draws, for both
    causal variants of text_guided. Bars of the CPU parity tests: per-task
    losses rtol 2e-3; every gradient leaf within 5e-3 * max|g_ref| of the
    leaf, that scale floored at GRAD_LEAF_FLOOR of the largest leaf's."""
    small_train_compare(torch, tiny_train_config(), "small-train", (0, 1))


def small_train_compare(torch, cfg, tag: str, coins, prepare=None) -> None:
    """One train step per text_guided coin of trainers built from `cfg` on
    the card and on the CPU, with the CPU trainer's weights (after
    `prepare(model)`, when given), batch and draws on both: losses and
    every gradient leaf at phase small-train's bars. Returns the (CPU,
    card) trainers, holding the last step's gradients."""
    import dataclasses

    import numpy as np

    from jen1_tpu_torch.train.train import build_trainer
    from jen1_tpu_torch.train.trainer import StepDraws, step_generator

    cpu, card = build_trainer(cfg, device="cpu"), build_trainer(cfg, device="cuda")
    if prepare is not None:
        prepare(cpu.model)
    host = tiny_batch(cfg.model_config)

    for coin in coins:
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
        worst, worst_name = worst_grad_leaf(card.model, [p.grad for p in cpu.model.parameters()])
        log(f"[{tag}] text_guided causal={bool(coin)}: losses card "
            + " ".join(f"{k}={v:.6f}" for k, v in metrics["card"].items())
            + f"; cpu loss/train={metrics['cpu']['loss/train']:.6f} "
            f"grad_norm={metrics['cpu']['grad_norm']:.6f}; worst gradient leaf {worst_name} "
            f"at {worst:.4f} of its bar; K1/K2/K3 launches {launched}")
        if not losses_ok or worst > 1.0 or min(launched) == 0:
            raise SystemExit("chip_smoke: the tiny train step on the card disagrees with the CPU")
    return cpu, card


def phase_main(torch) -> tuple:
    """Returns the K1 launches of the two counted requests, the Jen1, the
    two requests' audio and the device kernels of the profiled request."""
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
    return total, jen1, outs, sum(n for n, _ in by_name.values())


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
    log_kernel_time(by_name, "tasks-profile", ("sgemm",), "fp32 sgemm",
                    "the profiled continuation")
    # the codec alone: each LSTM layer runs one fp32 GEMM per time step
    for what, fn in (("30 s chunked encode", lambda: jen1.codec.encode_latent_chunked(audio)),
                     ("30 s chunked decode", lambda: jen1.codec.decode_latent_chunked(z))):
        by_name = profile_window(torch, "tasks-codec-profile", what, fn)
        log_kernel_time(by_name, "tasks-codec-profile", ("sgemm",), "fp32 sgemm", what)
    return total


def phase_long(torch, jen1) -> int:
    """Long-form at full width on the phase-main Jen1: generate_long_stream
    over LONG_TOTAL_SECONDS in LONG_WINDOW_SECONDS windows with
    LONG_CONTEXT_SECONDS of context, SLICE_STEPS VDM steps, B=1. Logs the
    wall to the first chunk, each window's wall and phase walls, the total
    wall and the peak device memory; K1 launches must be 2 per UNet
    forward in every window, all on the tensor-core route, the
    continuation windows' all causal. Then save_audio to WAV and FLAC.
    Returns the counted K1 launches."""
    import numpy as np

    from jen1_tpu_torch.ops import flash_attention as fa

    prompt, seed = SLICE_PROMPTS[0]
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = fa.LAUNCHES_MMA = fa.LAUNCHES_CAUSAL = 0
    fa.LAUNCHES_DQ = fa.LAUNCHES_DKV = 0
    chunks = []
    torch.cuda.synchronize()
    t0 = prev = time.perf_counter()
    for i, chunk in enumerate(jen1.generate_long_stream(
            prompt, total_seconds=LONG_TOTAL_SECONDS, window_seconds=LONG_WINDOW_SECONDS,
            context_seconds=LONG_CONTEXT_SECONDS, seed=seed, steps=SLICE_STEPS)):
        now = time.perf_counter()  # generate() ends in a host copy of its output
        phases = " ".join(f"{k}={v:.4f}" for k, v in jen1.last_timings.items())
        what = "wall to the first chunk" if i == 0 else "wall"
        log(f"[long] window {i}: {what} {now - prev:.4f} s; phases (s): {phases}; chunk "
            f"{chunk.shape}; K1 launches so far {fa.LAUNCHES}, causal {fa.LAUNCHES_CAUSAL}")
        prev = now
        chunks.append(chunk)
    total_wall = time.perf_counter() - t0
    out = np.concatenate(chunks, axis=-1)
    counts = (fa.LAUNCHES, fa.LAUNCHES_MMA, fa.LAUNCHES_CAUSAL)
    bwd = (fa.LAUNCHES_DQ, fa.LAUNCHES_DKV)
    samples = LONG_TOTAL_SECONDS * jen1.sample_rate
    finite = bool(np.isfinite(out).all())
    log(f"[long] {LONG_TOTAL_SECONDS} s in {len(chunks)} windows: total wall {total_wall:.4f} s; "
        f"peak device memory {torch.cuda.max_memory_allocated()} bytes; shape {out.shape}; "
        f"finite {finite}; rms {float(np.sqrt((out.astype(np.float64) ** 2).mean())):.4e}; "
        f"K1 launches (all, tensor-core, causal) {counts}; backward {bwd}")
    per_window = 2 * SLICE_STEPS
    want = (LONG_WINDOWS * per_window, LONG_WINDOWS * per_window,
            (LONG_WINDOWS - 1) * per_window)
    if out.shape != (1, 2, samples) or not finite or len(chunks) != LONG_WINDOWS:
        raise SystemExit(f"chip_smoke: long-form gave shape {out.shape} in {len(chunks)} "
                         f"chunks, or non-finite values")
    if counts != want or bwd != (0, 0):
        raise SystemExit(f"chip_smoke: long-form K1 launches {counts}, backward {bwd}; want "
                         f"{want}, (0, 0)")
    save_both(out, jen1.sample_rate, "long")
    return counts[0]


def phase_bf16_weights(torch, jen1) -> int:
    """bf16 weight storage at full width: a second Jen1(longform_config(),
    weights_dtype="bfloat16") with the same seed, sharing the T5 and the
    codec; the UNet's weight bytes of both; paired 100-step 30 s requests
    (BF16_ORDER) with walls and peak memory; the two storages'
    outputs must be equal (bf16 compute casts every matrix weight to bf16
    at use). Returns the counted K1 launches."""
    import numpy as np

    from jen1_tpu_torch.api.generation import Jen1
    from jen1_tpu_torch.config import longform_config
    from jen1_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    half = Jen1(config=longform_config(), sample_rate=jen1.sample_rate, codec=jen1.codec,
                conditioner=jen1.conditioner, weights_dtype="bfloat16", device="cuda")
    torch.cuda.synchronize()
    models = {"fp32": jen1, "bf16": half}

    def weight_bytes(model):
        return sum(p.numel() * p.element_size() for p in model.parameters())

    log(f"[bf16-weights] Jen1(weights_dtype='bfloat16') built in "
        f"{time.perf_counter() - t0:.2f} s; UNet weight bytes fp32 storage "
        f"{weight_bytes(jen1.model)}, bf16 storage {weight_bytes(half.model)} "
        f"({sum(p.dtype == torch.bfloat16 for p in half.model.parameters())} tensors bf16)")
    prompt, seed = SLICE_PROMPTS[1]
    fa.LAUNCHES = fa.LAUNCHES_MMA = 0
    outs = {}
    for name in BF16_ORDER:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out, wall = sync_wall(torch, lambda: models[name].generate(
            prompt, seed=seed, steps=SLICE_STEPS, seconds=SLICE_SECONDS))
        log(f"[bf16-weights] {name} weights: wall {wall:.4f} s; peak device memory "
            f"{torch.cuda.max_memory_allocated()} bytes ({base} allocated before); "
            f"finite {bool(np.isfinite(out).all())}")
        outs.setdefault(name, []).append(out)
    launches, mma = fa.LAUNCHES, fa.LAUNCHES_MMA
    diff = float(np.abs(outs["fp32"][0] - outs["bf16"][0]).max())
    log(f"[bf16-weights] max|diff| bf16 vs fp32 weights {diff:.3e} (want 0); K1 launches "
        f"{launches}, {mma} on the tensor-core route")
    del half, models
    want = len(BF16_ORDER) * 2 * SLICE_STEPS
    if diff != 0.0 or launches != want or mma != want or not np.isfinite(outs["bf16"][0]).all():
        raise SystemExit(f"chip_smoke: bf16 weights gave max|diff| {diff} against fp32 "
                         f"weights, or K1 launches {launches} ({mma} tensor-core), want {want}")
    return launches


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
    most device time. Returns {kernel name: (launches, device s)}. Only the
    CUDA activity is traced: recording every CPU op of ~40,000 launches
    slows the host (so the wall) and takes ~25 s to post-process."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    if not kernels:
        raise SystemExit(f"chip_smoke: the profiler saw no device kernels in {what}")
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
    the timed steps, of the checkpoint's two steps and of the remat
    comparison's two steps."""
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
    more = train_checkpoint(torch, cfg, trainer, state, batch)
    remat = train_remat(torch, cfg, trainer, state, batch)
    return tuple(a + b + c for a, b, c in zip(total, more, remat))


def train_checkpoint(torch, cfg, trainer, state, batch) -> tuple:
    """The full-width train state through a checkpoint: CheckpointManager
    saves it (every parameter, AdamW moment and counter) into a scratch
    directory and a fresh trainer restores it; bytes, walls and the free
    disk before the save are logged. Then each trainer takes one step with
    the same draws: losses within the train bar (rtol 2e-3), and each step
    launches K1, K2 and K3 TRAIN_LAUNCHES times, all on the tensor-core
    route, counted from 0. Returns the K1/K2/K3 launches of those two steps."""
    import shutil

    import numpy as np

    from jen1_tpu_torch.ckpt.checkpoint import CheckpointManager
    from jen1_tpu_torch.ops import flash_attention as fa
    from jen1_tpu_torch.train.train import build_trainer
    from jen1_tpu_torch.train.trainer import step_generator

    draws = TRAIN_STEPS + 2
    losses, launched = {}, (0, 0, 0)
    with scratch_dir() as d:
        free = shutil.disk_usage(d).free
        flat = trainer.state_dict(state)
        n_bytes = sum(t.numel() * t.element_size() for t in flat.values())
        mngr = CheckpointManager(d)
        t0 = time.perf_counter()
        mngr.save(state.step, flat, loss=0.0, learning_rate=cfg.optimizer_config.lr)
        save_wall = time.perf_counter() - t0
        on_disk = sum(f.stat().st_size for f in Path(d).rglob("*") if f.is_file())
        fresh = build_trainer(cfg, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored, _ = mngr.restore(map_location="cuda")
        fresh_state = fresh.load_state_dict(restored)
        torch.cuda.synchronize()
        restore_wall = time.perf_counter() - t0
        del restored
    log(f"[train-ckpt] {len(flat)} tensors, {n_bytes} bytes of state, {on_disk} bytes on disk "
        f"({free} bytes free before the save): save wall {save_wall:.3f} s, restore into a "
        f"fresh trainer {restore_wall:.3f} s")
    del flat
    per_step = []
    for name, tr, st in (("saving", trainer, state), ("restored", fresh, fresh_state)):
        fa.LAUNCHES = fa.LAUNCHES_DQ = fa.LAUNCHES_DKV = 0
        fa.LAUNCHES_MMA = fa.LAUNCHES_DQ_MMA = fa.LAUNCHES_DKV_MMA = 0
        _, m = tr.train_step(st, batch, step_generator(tr.device, TRAIN_SEED, draws),
                             np.random.default_rng((TRAIN_SEED, draws)))
        losses[name] = {k: float(v) for k, v in m.items()}
        counts = launch_counts()
        mma = (fa.LAUNCHES_MMA, fa.LAUNCHES_DQ_MMA, fa.LAUNCHES_DKV_MMA)
        per_step.append(counts)
        if counts != (TRAIN_LAUNCHES,) * 3 or mma != counts:
            raise SystemExit(f"chip_smoke: the {name} trainer's step launched K1/K2/K3 "
                             f"{counts}, {mma} on the tensor-core route; want "
                             f"{TRAIN_LAUNCHES} each, all on the tensor-core route")
        launched = tuple(a + b for a, b in zip(launched, counts))
    ok = all(np.isclose(losses["restored"][k], losses["saving"][k], rtol=2e-3, atol=0)
             for k in losses["saving"] if k.startswith("loss"))
    log(f"[train-ckpt] one more step each: loss/train saving trainer "
        f"{losses['saving']['loss/train']:.6f}, restored {losses['restored']['loss/train']:.6f}; "
        f"grad_norm {losses['saving']['grad_norm']:.6f} / {losses['restored']['grad_norm']:.6f}; "
        f"K1/K2/K3 launches per step {per_step}, all on the tensor-core route; "
        f"losses {'ok' if ok else 'FAIL'}")
    del fresh, fresh_state
    if not ok:
        raise SystemExit("chip_smoke: the restored full-width trainer's step differs")
    return launched


def reuse_k1(steps: int, k: int, final_full: bool) -> int:
    """K1 launches of one request under encoder reuse: 2 per whole UNet
    forward (the level-1 down and up transformers), 1 per decoder-only one
    (the up transformer), as `reuse_schedule` marks the steps."""
    from jen1_tpu_torch.diffusion.gdm import reuse_schedule

    whole = reuse_schedule(steps, k, final_full)
    return 2 * sum(whole) + (len(whole) - sum(whole))


def cache_leaves(cache):
    x, skips = cache
    return [x] + [s for level in skips for s in level]


def phase_small_reuse(torch) -> None:
    """Encoder reuse at tiny widths, on the card against the CPU: the tiny
    pair's UNet forward with return_encoder_cache (output and every cache
    leaf, rtol 5e-3 / atol 5e-4, the CFG bar), then DDIM and DPM-Solver++
    at encoder_reuse k in SMALL_REUSE_KS x S in SMALL_REUSE_STEPS, in fp32
    and in bf16 compute, with x_T and each step's noise from one CPU stream.
    fp32: rtol 2e-2 / atol 2e-3, the bar of phase small-gdm. bf16 compute
    rounds x to bf16 at the UNet's input and every activation after it, so
    the request moves with any rounding change; the bar is phase
    small-gdm's spread bar, three times the CPU's own spread (mean and max
    of |diff|), under a change of x_T at bf16's rounding step (2^-8
    relative: a 1e-6 change does not survive the input rounding). K1
    launches per request: 2 per whole forward, 1 per decoder-only one, on
    the tensor-core route in bf16 and the scalar one in fp32."""
    import numpy as np

    from jen1_tpu_torch.diffusion import gdm
    from jen1_tpu_torch.ops import flash_attention as fa

    cpu, card = tiny_pair(torch)
    g = torch.Generator().manual_seed(3)
    b, length, m = 2, 520, cpu.config.model_config.context_embedding_max_length
    e = cpu.config.model_config.context_embedding_features
    inp = dict(x=torch.randn(b, length, 8, generator=g), t=torch.tensor([3, 5]),
               embedding=torch.randn(b, m, e, generator=g),
               channels_list=[torch.randn(b, length, 9, generator=g)])
    outs = {}
    for name, jen1 in (("cpu", cpu), ("card", card)):
        dev = jen1.device
        with torch.no_grad():
            outs[name] = jen1.model(
                inp["x"].to(dev), inp["t"].to(dev), embedding=inp["embedding"].to(dev),
                channels_list=[c.to(dev) for c in inp["channels_list"]], embedding_scale=0.8,
                batch_cfg=True, scale_cfg=True, return_encoder_cache=True)
    pairs = [(outs["card"][0], outs["cpu"][0])] + list(
        zip(cache_leaves(outs["card"][1]), cache_leaves(outs["cpu"][1])))
    worst = max(((a.cpu() - r).abs() / (5e-4 + 5e-3 * r.abs())).max().item() for a, r in pairs)
    log(f"[small-reuse] UNet forward with its encoder cache, card vs CPU: output and "
        f"{len(pairs) - 1} cache leaves {[tuple(a.shape) for a, _ in pairs[1:]]}, worst "
        f"|diff| at {worst:.4f} of the bar (rtol 5e-3, atol 5e-4)")
    if worst > 1.0:
        raise SystemExit("chip_smoke: the UNet's encoder cache on the card disagrees with the CPU")

    draws = (gdm.initial_noise, gdm.step_noise)
    try:
        for dtype in ("float32", "bfloat16"):
            if dtype == "bfloat16":
                cpu, card = tiny_pair(torch, dtype)
            for mode in ("scan", "dpm++"):
                for k in SMALL_REUSE_KS:
                    for steps in SMALL_REUSE_STEPS:
                        shape = (1, 520, 8)
                        stream = torch.Generator().manual_seed(7)
                        x_t = torch.randn(shape, generator=stream)
                        noises = [torch.randn(shape, generator=stream) for _ in range(steps)]
                        gdm.step_noise = lambda x, generator, index, uniform=False: \
                            noises[index].to(x.device)

                        def run(jen1, start=x_t):
                            gdm.initial_noise = lambda shape, generator, device: start.to(device)
                            return jen1.generate("a beautiful song", seed=5, steps=steps,
                                                 seconds=13, use_gdm=True, sampler_mode=mode,
                                                 encoder_reuse=k)

                        ref = run(cpu)
                        fa.LAUNCHES = fa.LAUNCHES_MMA = 0
                        out = run(card)
                        launched, mma = fa.LAUNCHES, fa.LAUNCHES_MMA
                        want = reuse_k1(steps, k, final_full=mode == "scan")
                        diff = np.abs(out - ref)
                        if dtype == "bfloat16":
                            spread = [np.abs(run(cpu, x_t * (1 + sign * 2**-8 * noises[0]))
                                             - ref) for sign in (1, -1)]
                            bar_mean = 3 * max(d.mean() for d in spread)
                            bar_max = 3 * max(d.max() for d in spread)
                            close = diff.mean() <= bar_mean and diff.max() <= bar_max
                            bar = f"mean <= {bar_mean:.3e}, max <= {bar_max:.3e}"
                        else:
                            close = np.allclose(out, ref, rtol=2e-2, atol=2e-3)
                            bar = "rtol 2e-2, atol 2e-3"
                        want_mma = want if dtype == "bfloat16" else 0
                        ok = (close and out.shape == ref.shape and np.isfinite(out).all()
                              and launched == want and mma == want_mma)
                        log(f"[small-reuse] {dtype} compute, {mode}, encoder_reuse={k}, "
                            f"S={steps}: card vs CPU max|diff|={diff.max():.3e} mean="
                            f"{diff.mean():.3e} ({bar}); K1 launches {launched} (want {want}), "
                            f"tensor-core {mma} (want {want_mma}) {'ok' if ok else 'FAIL'}")
                        if not ok:
                            raise SystemExit("chip_smoke: a tiny encoder-reuse request on the "
                                             "card disagrees with the CPU")
    finally:
        gdm.initial_noise, gdm.step_noise = draws


def http_post(url: str, body: dict, timeout: float = 600.0):
    """(status, headers, body bytes) of a JSON POST; HTTP errors included."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def start_http(service, sample_rate: int):
    """A ThreadingHTTPServer on 127.0.0.1 (a free port) over `service`,
    serving from a daemon thread; returns (server, base URL)."""
    import threading
    from http.server import ThreadingHTTPServer

    from jen1_tpu_torch.serve import make_handler

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service, sample_rate))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def phase_small_serve(torch) -> None:
    """The serving path at tiny widths on the card: the tiny pair's card
    Jen1 behind GenerationService (max_batch 3, GDM DDIM, 3 steps, 2 s) and
    its HTTP server on 127.0.0.1. Concurrent requests co-batch; a seeded
    request equals lane 0 of generate() with the same padded prompts and
    seed, bit for bit; GET /healthz; POST /generate as WAV and as npy; one
    POST /generate_long stream (equal to generate_long's PCM); a 503 with
    Retry-After under overload; close() drains admitted work. Then
    batch_generate on 3 prompts into a temporary directory."""
    import io
    import threading
    import urllib.request
    import wave

    import numpy as np

    from jen1_tpu_torch.serve import GenerationService, ServiceClosed

    _, card = tiny_pair(torch)
    seconds, steps, sr = 2.0, 3, card.sample_rate
    svc = GenerationService(card, max_batch=3, max_wait_ms=300.0, default_seconds=seconds,
                            default_steps=steps)
    httpd, url = start_http(svc, sr)
    try:
        results = [None] * 3

        def worker(i):
            results[i] = svc.submit(f"tune {i}", timeout=600)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        batches = svc.stats["batches"]
        shapes_ok = all(r is not None and r.shape == (2, int(seconds * sr))
                        and np.isfinite(r).all() for r in results)
        seeded = svc.submit("seeded tune", seed=SERVE_SEED, timeout=600)
        direct = card.generate(["seeded tune", "", ""], seed=SERVE_SEED, steps=steps,
                               batch_size=3, seconds=seconds, use_gdm=True)[0]
        seed_diff = float(np.abs(seeded - direct).max())
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        code_wav, head_wav, wav_bytes = http_post(f"{url}/generate", {"prompt": "hi"})
        with wave.open(io.BytesIO(wav_bytes)) as w:
            wav_shape = (w.getnchannels(), w.getframerate(), w.getnframes())
        code_npy, _, npy_bytes = http_post(f"{url}/generate", {"prompt": "hi", "format": "npy"})
        npy = np.load(io.BytesIO(npy_bytes))
        long_body = {"prompt": "stream me", "total_seconds": 2.5, "window_seconds": 1.0,
                     "context_seconds": 0.5, "steps": 2, "seed": 13}
        code_long, head_long, pcm = http_post(f"{url}/generate_long", long_body)
        got = np.frombuffer(pcm, "<i2").reshape(-1, 2)
        want = card.generate_long("stream me", total_seconds=2.5, window_seconds=1.0,
                                  context_seconds=0.5, seed=13, steps=2, use_gdm=True)[0]
        long_equal = np.array_equal(got, (np.clip(want.T, -1, 1) * 32767.0).astype("<i2"))
    finally:
        httpd.shutdown()
        svc.close()
    log(f"[small-serve] 3 concurrent requests in {batches} batch(es), shapes ok {shapes_ok}; "
        f"seeded request vs lane 0 of generate(): max|diff| {seed_diff:.3e} (want 0); /healthz "
        f"{health}; /generate WAV {code_wav} {head_wav['Content-Type']} {wav_shape}, npy "
        f"{code_npy} {npy.shape} {npy.dtype}; /generate_long {code_long} "
        f"{head_long.get('X-Sample-Rate')} Hz, {got.shape} samples, equal to generate_long "
        f"{long_equal}")
    if not (shapes_ok and batches <= 2 and seed_diff == 0.0 and health["ok"]
            and (code_wav, code_npy, code_long) == (200, 200, 200)
            and wav_shape == (2, sr, int(seconds * sr)) and npy.shape == (2, int(seconds * sr))
            and long_equal and svc.stats["errors"] == 0):
        raise SystemExit("chip_smoke: the tiny serving path on the card failed a check")

    # overload: one admitted request at a time, four at once
    over = GenerationService(card, max_batch=1, max_wait_ms=5.0, max_queue=1,
                             default_seconds=seconds, default_steps=steps)
    httpd, url = start_http(over, sr)
    codes, retry = [], []
    lock = threading.Lock()

    def hammer():
        code, head, _ = http_post(f"{url}/generate", {"prompt": "x"})
        with lock:
            codes.append(code)
            if code == 503:
                retry.append(head.get("Retry-After"))

    try:
        threads = [threading.Thread(target=hammer) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        httpd.shutdown()
        over.close()
    # close() drains: three admitted requests finish, a later one is refused
    drain_svc = GenerationService(card, max_batch=1, max_wait_ms=5.0, max_queue=8,
                                  default_seconds=seconds, default_steps=steps)
    drained = []
    threads = [threading.Thread(target=lambda i=i: drained.append(
        drain_svc.submit(f"drain {i}", timeout=600))) for i in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    drain_svc.close()
    for t in threads:
        t.join()
    try:
        drain_svc.submit("too late", timeout=5)
        refused = False
    except ServiceClosed:
        refused = True
    log(f"[small-serve] overload (max_queue 1, 4 at once): HTTP codes {sorted(codes)}, "
        f"Retry-After {retry}; close() drained {len(drained)} of 3 admitted requests, a later "
        f"submit refused {refused}")
    if 200 not in codes or 503 not in codes or not all(r and int(r) >= 1 for r in retry) \
            or len(drained) != 3 or not refused:
        raise SystemExit("chip_smoke: overload shedding or close() draining failed")
    small_batch_generate(torch)


def small_batch_generate(torch) -> None:
    """`python -m jen1_tpu_torch.api.batch_generate` on the card: 3 prompts
    in batches of 2 (the second padded with ""), 1 s, 2 DDIM steps, a tiny
    UNet with the EnCodec-48k codec's 128 latent channels (random weights):
    one WAV per prompt and the manifest."""
    import dataclasses
    import wave

    from jen1_tpu_torch.api import batch_generate

    cfg = tiny_train_config()
    cfg.model_config = dataclasses.replace(cfg.model_config, in_channels=128,
                                           out_channels=128, context_channels=(129,))
    with scratch_dir() as d:
        d = Path(d)
        cfg.to_json(str(d / "cfg.json"))
        (d / "prompts.txt").write_text("warm jazz\nsolo cello\nfast drums\n")
        t0 = time.perf_counter()
        batch_generate.main(["--prompts", str(d / "prompts.txt"), "--out", str(d / "out"),
                             "--config", str(d / "cfg.json"), "--seconds", "1", "--steps", "2",
                             "--batch-size", "2", "--use-gdm", "--device", "cuda"])
        wall = time.perf_counter() - t0
        manifest = json.loads((d / "out" / "manifest.json").read_text())
        shapes = []
        for entry in manifest:
            with wave.open(str(d / "out" / entry["file"])) as w:
                shapes.append((w.getnchannels(), w.getframerate(), w.getnframes()))
    log(f"[small-serve] batch_generate: 3 prompts in {wall:.2f} s, manifest "
        f"{[e['file'] for e in manifest]}, WAV (channels, rate, frames) {shapes}")
    if [e["prompt"] for e in manifest] != ["warm jazz", "solo cello", "fast drums"] \
            or shapes != [(2, 48_000, 48_000)] * 3:
        raise SystemExit("chip_smoke: batch_generate wrote the wrong files")


def phase_reuse(torch, jen1) -> int:
    """Encoder reuse at full width on the phase-main Jen1 (longform_config(),
    GDM, 30 s, SLICE_STEPS steps, B=1, one seed): DDIM requests at
    encoder_reuse REUSE_KS and one DPM-Solver++ request at REUSE_DPM_K.
    Walls; the relative L2 distance of each k > 1 latent and audio from the
    first k = 1 request's; K1 launches per request, which must equal what
    `reuse_schedule` gives (2 per whole forward, 1 per decoder-only one),
    all on the tensor-core route. Then the device busy seconds of a
    PROFILE_STEPS request at k = 1 and at k = 2 under torch.profiler.
    Returns the counted K1 launches."""
    import numpy as np

    from jen1_tpu_torch.ops import flash_attention as fa

    prompt, seed = SLICE_PROMPTS[0]
    latents = []
    decode = jen1.codec.decode_latent_chunked

    def recording(z, **kw):
        latents.append(z.float().cpu().numpy())
        return decode(z, **kw)

    requests = [("scan", k) for k in REUSE_KS] + [("dpm++", REUSE_DPM_K)]
    total = 0
    outs = []
    jen1.codec.decode_latent_chunked = recording
    try:
        _, wall = sync_wall(torch, lambda: jen1.generate(
            prompt, seed=seed, steps=PROFILE_STEPS, seconds=SLICE_SECONDS, use_gdm=True,
            encoder_reuse=2))
        log(f"[reuse] warm-up ({PROFILE_STEPS} DDIM steps, k=2) {wall:.3f} s")
        latents.clear()
        torch.cuda.reset_peak_memory_stats()
        for mode, k in requests:
            fa.LAUNCHES = fa.LAUNCHES_MMA = fa.LAUNCHES_DQ = fa.LAUNCHES_DKV = 0
            out, wall = sync_wall(torch, lambda: jen1.generate(
                prompt, seed=seed, steps=SLICE_STEPS, seconds=SLICE_SECONDS, use_gdm=True,
                sampler_mode=mode, encoder_reuse=k))
            counts = (fa.LAUNCHES, fa.LAUNCHES_MMA, fa.LAUNCHES_DQ + fa.LAUNCHES_DKV)
            want = reuse_k1(SLICE_STEPS, k, final_full=mode == "scan")
            total += counts[0]
            outs.append(out)
            ref_z, ref_a = latents[0], outs[0]
            rel_z = float(np.linalg.norm(latents[-1] - ref_z) / np.linalg.norm(ref_z))
            rel_a = float(np.linalg.norm(out - ref_a) / np.linalg.norm(ref_a))
            phases = " ".join(f"{p}={v:.4f}" for p, v in jen1.last_timings.items())
            finite = bool(np.isfinite(out).all())
            log(f"[reuse] {mode} encoder_reuse={k}: wall {wall:.4f} s; phases (s): {phases}; "
                f"K1 launches {counts[0]} (want {want}), tensor-core {counts[1]}, backward "
                f"{counts[2]}; relative L2 from the first k=1 request: latent {rel_z:.4e}, "
                f"audio {rel_a:.4e}; shape {out.shape}; finite {finite}")
            if out.shape != (1, 2, SLICE_SECONDS * jen1.sample_rate) or not finite:
                raise SystemExit(f"chip_smoke: reuse gave shape {out.shape} or non-finite values")
            if counts != (want, want, 0):
                raise SystemExit(f"chip_smoke: {mode} encoder_reuse={k} K1 launches (all, "
                                 f"tensor-core, backward) {counts}, want ({want}, {want}, 0)")
    finally:
        del jen1.codec.decode_latent_chunked
    log(f"[reuse] peak device memory {torch.cuda.max_memory_allocated()} bytes")
    for k in (1, 2):
        by_name = profile_window(torch, "reuse-profile", f"{PROFILE_STEPS}-step DDIM, k={k}",
                                 lambda: jen1.generate(prompt, seed=seed, steps=PROFILE_STEPS,
                                                       seconds=SLICE_SECONDS, use_gdm=True,
                                                       encoder_reuse=k))
        log_kernel_time(by_name, "reuse-profile", ("flash_fwd_mma",), "K1",
                        f"the profiled k={k} request")
    return total


def phase_serve(torch, jen1) -> int:
    """The serving path at full width: GenerationService(max_batch=
    SERVE_BATCH, max_wait_ms=SERVE_WAIT_MS, 30 s, SLICE_STEPS DDIM steps) over
    the phase-main Jen1. One warm-up batch of PROFILE_STEPS steps;
    SERVE_REQUESTS default-seed requests submitted at once from as many
    threads (two batches: a full one and one padded); one seeded request
    twice (max|diff| between them); one POST /generate over HTTP on
    127.0.0.1. Logs each request's latency (submit to return), each batch's
    generate() wall, audio-seconds per wall-second over the concurrent
    requests, phase_totals, the peak device memory at B=4, K1 launches and
    stats. K1 is held to 2 launches per forward of the CFG-doubled batch, all
    on the tensor-core route, for the concurrent batches, each seeded request
    and the HTTP request. Then the busy share of a PROFILE_STEPS B=4 request
    under torch.profiler. Returns the counted K1 launches."""
    import io
    import threading
    import wave

    import numpy as np

    from jen1_tpu_torch.ops import flash_attention as fa
    from jen1_tpu_torch.serve import GenerationService

    sr = jen1.sample_rate
    samples = SLICE_SECONDS * sr
    walls = []
    generate = jen1.generate

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = generate(*a, **kw)
        walls.append((len([p for p in a[0] if p]), time.perf_counter() - t0))
        return out

    jen1.generate = timed
    svc = GenerationService(jen1, max_batch=SERVE_BATCH, max_wait_ms=SERVE_WAIT_MS,
                            default_seconds=SLICE_SECONDS, default_steps=SLICE_STEPS)
    httpd, url = start_http(svc, sr)
    try:
        t0 = time.perf_counter()
        warm = svc.submit("warm-up", steps=PROFILE_STEPS, timeout=900)
        log(f"[serve] warm-up batch (1 request, padded to {SERVE_BATCH}, {PROFILE_STEPS} "
            f"steps) {time.perf_counter() - t0:.3f} s, shape {warm.shape}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.LAUNCHES = fa.LAUNCHES_MMA = fa.LAUNCHES_DQ = fa.LAUNCHES_DKV = 0
        before = dict(svc.stats)
        batches_before = len(walls)
        results, latencies = [None] * SERVE_REQUESTS, [0.0] * SERVE_REQUESTS
        prompts = [p for p, _ in SLICE_PROMPTS] + TRAIN_PROMPTS + ["warm jazz trio"]

        def worker(i):
            t = time.perf_counter()
            results[i] = svc.submit(prompts[i % len(prompts)], timeout=900)
            latencies[i] = time.perf_counter() - t

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(SERVE_REQUESTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        span = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        k1 = (fa.LAUNCHES, fa.LAUNCHES_MMA, fa.LAUNCHES_DQ + fa.LAUNCHES_DKV)
        batch_walls = walls[batches_before:]
        padded = svc.stats["padded_lanes"] - before["padded_lanes"]
        n_batches = svc.stats["batches"] - before["batches"]
        log(f"[serve] {SERVE_REQUESTS} concurrent requests: latencies (s) "
            f"{[round(x, 4) for x in latencies]}; {n_batches} batches, (requests, generate() "
            f"wall s) {[(n, round(w, 4)) for n, w in batch_walls]}; {padded} padded lanes; "
            f"span {span:.4f} s, audio-s per wall-s {SERVE_REQUESTS * SLICE_SECONDS / span:.4f}; "
            f"peak device memory {peak} bytes; K1 launches (all, tensor-core, backward) {k1}")
        want_batches = -(-SERVE_REQUESTS // SERVE_BATCH)
        want_padded = want_batches * SERVE_BATCH - SERVE_REQUESTS
        want_k1 = want_batches * 2 * SLICE_STEPS
        shapes_ok = all(r is not None and r.shape == (2, samples) and np.isfinite(r).all()
                        for r in results)
        if not shapes_ok or n_batches != want_batches or padded != want_padded \
                or k1 != (want_k1, want_k1, 0):
            raise SystemExit(f"chip_smoke: serving gave {n_batches} batches, {padded} padded "
                             f"lanes, K1 {k1}, shapes ok {shapes_ok}; want {want_batches}, "
                             f"{want_padded}, ({want_k1}, {want_k1}, 0)")
        launched = k1[0]

        def one_batch_k1(what: str) -> int:
            # every single-batch request runs SLICE_STEPS full forwards of
            # the CFG-doubled batch, all on the tensor-core route
            k1 = (fa.LAUNCHES, fa.LAUNCHES_MMA, fa.LAUNCHES_DQ + fa.LAUNCHES_DKV)
            want = (2 * SLICE_STEPS, 2 * SLICE_STEPS, 0)
            if k1 != want:
                raise SystemExit(f"chip_smoke: {what} launched K1 (all, tensor-core, "
                                 f"backward) {k1}, want {want}")
            return k1[0]

        seeded = []
        for _ in range(2):
            fa.LAUNCHES = fa.LAUNCHES_MMA = fa.LAUNCHES_DQ = fa.LAUNCHES_DKV = 0
            t = time.perf_counter()
            seeded.append(svc.submit(SLICE_PROMPTS[1][0], seed=SERVE_SEED, timeout=900))
            log(f"[serve] seeded request (seed {SERVE_SEED}, lane 0 of its own batch): "
                f"latency {time.perf_counter() - t:.4f} s; K1 launches {fa.LAUNCHES}, "
                f"tensor-core {fa.LAUNCHES_MMA}")
            launched += one_batch_k1("the seeded request")
        seed_diff = float(np.abs(seeded[0] - seeded[1]).max())
        log(f"[serve] the seeded request twice: max|diff| {seed_diff:.3e} (0 when the same "
            f"kernels run)")

        fa.LAUNCHES = fa.LAUNCHES_MMA = fa.LAUNCHES_DQ = fa.LAUNCHES_DKV = 0
        t = time.perf_counter()
        code, head, body = http_post(f"{url}/generate", {"prompt": SLICE_PROMPTS[0][0]},
                                     timeout=900)
        http_wall = time.perf_counter() - t
        with wave.open(io.BytesIO(body)) as w:
            wav = (w.getnchannels(), w.getframerate(), w.getnframes())
        log(f"[serve] POST /generate over HTTP: {code} {head['Content-Type']} {wav}, "
            f"{len(body)} bytes, latency {http_wall:.4f} s; K1 launches {fa.LAUNCHES}, "
            f"tensor-core {fa.LAUNCHES_MMA}")
        launched += one_batch_k1("the HTTP request")
        phases = " ".join(f"{k}={v:.4f}" for k, v in svc.phase_totals.items())
        log(f"[serve] phase_totals (s): {phases}; stats {svc.stats}")
        if code != 200 or wav != (2, sr, samples) or svc.stats["errors"] != 0 \
                or not all(np.isfinite(x).all() for x in seeded):
            raise SystemExit("chip_smoke: the HTTP request or the seeded requests failed")
    finally:
        httpd.shutdown()
        svc.close()
        del jen1.generate
    prompt, seed = SLICE_PROMPTS[0]
    by_name = profile_window(
        torch, "serve-profile", f"{PROFILE_STEPS}-step B={SERVE_BATCH} DDIM request",
        lambda: jen1.generate([prompt] * SERVE_BATCH, seed=seed, steps=PROFILE_STEPS,
                              batch_size=SERVE_BATCH, seconds=SLICE_SECONDS, use_gdm=True))
    log_kernel_time(by_name, "serve-profile", ("flash_fwd_mma",), "K1",
                    f"the profiled B={SERVE_BATCH} request")
    return launched


def train_remat(torch, cfg, trainer, state, batch) -> tuple:
    """ModelConfig.remat at full width: a second trainer with remat=True
    takes the first one's whole state, and both take two steps with the same
    draws (the first allocates the fresh trainer's gradients, so the
    second's walls and peaks are the ones to read). Losses within rtol 2e-3
    and every gradient leaf within the train bar, at each step; peak device
    memory over what was allocated before each step; from the forward's
    start (after zero_grad has freed the last step's gradients), what the
    forward left allocated (the activations saved for the backward) and the
    peak through the backward, read as the optimizer starts;
    K1/K2/K3 launches of each remat step, which recomputes each block's
    forward in the backward: K1 twice per transformer (8), K2 and K3 once
    (4). Returns the K1/K2/K3 launches of the four steps."""
    import copy
    import dataclasses

    import numpy as np

    from jen1_tpu_torch.ops import flash_attention as fa
    from jen1_tpu_torch.train.train import build_trainer
    from jen1_tpu_torch.train.trainer import step_generator

    rcfg = copy.deepcopy(cfg)
    rcfg.model_config = dataclasses.replace(rcfg.model_config, remat=True)
    remat = build_trainer(rcfg, device="cuda")
    runs = {"plain": [trainer, state], "remat": [remat, remat.load_state_dict(
        trainer.state_dict(state))]}
    want = {"plain": (TRAIN_LAUNCHES,) * 3,
            "remat": (2 * TRAIN_LAUNCHES, TRAIN_LAUNCHES, TRAIN_LAUNCHES)}
    marks = {}

    def around_forward(fn):
        def wrapped(*a, **kw):
            marks["pre_peak"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            marks["start"] = torch.cuda.memory_allocated()
            out = fn(*a, **kw)
            marks["forward"] = torch.cuda.memory_allocated()
            return out
        return wrapped

    def before_optimizer(fn):
        def wrapped(*a, **kw):
            marks["backward_peak"] = torch.cuda.max_memory_allocated()
            return fn(*a, **kw)
        return wrapped

    for tr, _ in runs.values():
        tr._multi_task_loss = around_forward(tr._multi_task_loss)
        tr._apply_optimizer = before_optimizer(tr._apply_optimizer)
    launched = (0, 0, 0)
    for step in (1, 2):
        draws = TRAIN_STEPS + 2 + step
        metrics = {}
        for name, run in runs.items():
            tr, st = run
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fa.LAUNCHES = fa.LAUNCHES_DQ = fa.LAUNCHES_DKV = 0
            fa.LAUNCHES_MMA = fa.LAUNCHES_DQ_MMA = fa.LAUNCHES_DKV_MMA = 0
            t0 = time.perf_counter()
            run[1], m = tr.train_step(st, batch, step_generator(tr.device, TRAIN_SEED, draws),
                                      np.random.default_rng((TRAIN_SEED, draws)))
            metrics[name] = {k: float(v) for k, v in m.items()}
            wall = time.perf_counter() - t0
            counts = launch_counts()
            mma = (fa.LAUNCHES_MMA, fa.LAUNCHES_DQ_MMA, fa.LAUNCHES_DKV_MMA)
            peak = max(marks["pre_peak"], torch.cuda.max_memory_allocated())
            start = marks["start"]
            log(f"[train-remat] step {step}, {name}: wall {wall:.4f} s; peak device memory "
                f"{peak} bytes, {peak - base} above the {base} allocated before (both "
                f"trainers resident); from the forward's start ({start}): saved for the "
                f"backward {marks['forward'] - start}, peak through the backward "
                f"{marks['backward_peak'] - start}; loss/train "
                f"{metrics[name]['loss/train']:.6f}, grad_norm {metrics[name]['grad_norm']:.6f}; "
                f"K1/K2/K3 launches {counts}, tensor-core {mma}")
            if counts != want[name] or mma != want[name]:
                raise SystemExit(f"chip_smoke: the {name} step launched K1/K2/K3 {counts} "
                                 f"({mma} tensor-core), want {want[name]}")
            launched = tuple(a + b for a, b in zip(launched, counts))
        worst, worst_name = worst_grad_leaf(remat.model,
                                            [p.grad for p in trainer.model.parameters()])
        ok = all(np.isclose(metrics["remat"][k], metrics["plain"][k], rtol=2e-3, atol=0)
                 for k in metrics["plain"] if k.startswith("loss"))
        log(f"[train-remat] step {step}, remat vs plain: losses {'ok' if ok else 'FAIL'} "
            f"(rtol 2e-3); worst gradient leaf {worst_name} at {worst:.4f} of its bar")
        if not ok or worst > 1.0:
            raise SystemExit("chip_smoke: the remat step differs from the plain one")
    del trainer._multi_task_loss, trainer._apply_optimizer
    del remat, runs
    return launched


def move_draws(torch, draws, device):
    """A StepDraws with every tensor moved to `device`."""
    import dataclasses

    from jen1_tpu_torch.train.trainer import StepDraws

    return StepDraws(*[{k: v.to(device) if torch.is_tensor(v) else v
                        for k, v in getattr(draws, f.name).items()}
                       for f in dataclasses.fields(StepDraws)])


class Coin:
    """A host generator whose text_guided coin is fixed."""

    def __init__(self, value):
        self.value = value

    def integers(self, lo, hi):
        return self.value


def phase_small_data(torch) -> None:
    """The data slice at a small size: two WAV files and one FLAC file, 48 kHz
    stereo, with sidecar prompts, written by the port's own writers; the
    native decoders built from native/*.cpp; load_audio against the written
    samples (WAV: their 16-bit quantization, FLAC: exact, whole files and
    a seek); `preprocess scan` (the durations); `preprocess encode` (1 s
    windows at 1600 Hz, chunked) on the card and on the CPU with the same
    tiny codec, every latent within the codec bar (1e-4)."""
    import json

    import numpy as np

    from jen1_tpu_torch.codec.model import EncodecConfig, EncodecModel
    from jen1_tpu_torch.data import native_io, preprocess
    from jen1_tpu_torch.data.audio_io import load_audio, write_wav
    from jen1_tpu_torch.data.flac_write import write_flac

    with scratch_dir() as d:
        root = Path(d) / "corpus"
        (root / "audios").mkdir(parents=True)
        (root / "metadata").mkdir()
        files = []
        for i, (fmt, seconds) in enumerate((("wav", 2.5), ("flac", 2.0), ("wav", 1.5))):
            clip = synthetic_clip(np, 40 + i, seconds, 48_000)
            path = root / "audios" / f"take{i}.{fmt}"
            (write_wav if fmt == "wav" else write_flac)(str(path), clip, 48_000)
            (root / "metadata" / f"take{i}.json").write_text(json.dumps({"prompt": f"take {i}"}))
            files.append((path, fmt, seconds, np.clip(clip, -1.0, 1.0)))
        t0 = time.perf_counter()
        libs = [native_io.get_lib(fmt) for fmt in ("wav", "flac")]
        log(f"[small-data] decoders built and loaded in {time.perf_counter() - t0:.3f} s: "
            f"{[lib._name for lib in libs]}")
        for path, fmt, seconds, clip in files:
            if fmt == "wav":
                want = (clip * 32767.0).astype(np.int16) / np.float32(32768.0)
            else:
                want = np.round(np.minimum(clip, 1 - 2.0**-15) * 32768.0) / np.float32(32768.0)
            got, sr = load_audio(str(path))
            part, _ = load_audio(str(path), 1000, 700)
            ok = (sr == 48_000 and got.shape == want.shape and np.array_equal(got, want)
                  and np.array_equal(part, want[1000:1700]))
            log(f"[small-data] load_audio {path.name}: {got.shape} at {sr} Hz, max|diff| "
                f"{np.abs(got - want).max():.3e} against the written samples, seek "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"chip_smoke: load_audio({path.name}) differs from what was "
                                 "written")
        preprocess.scan(str(root))
        durations = np.load(root / "durations.npy")
        if not np.allclose(durations, [f[2] for f in files]):
            raise SystemExit(f"chip_smoke: preprocess scan durations {durations}")
        cpu = EncodecModel(EncodecConfig(**TINY_CODEC), device="cpu").eval()
        card = EncodecModel(EncodecConfig(**TINY_CODEC), device="cuda").eval()
        card.load_state_dict(cpu.state_dict())
        kw = dict(sample_duration=1.0, sr=1600, channels=2, batch_size=4)
        n_cpu = preprocess.encode(str(root), str(root / "cpu"), codec=cpu, device="cpu", **kw)
        t0 = time.perf_counter()
        n_card = preprocess.encode(str(root), str(root / "card"), codec=card, device="cuda", **kw)
        wall = time.perf_counter() - t0
        names = sorted(p.name for p in (root / "cpu").glob("*.npy"))
        errs = [np.abs(np.load(root / "card" / n) - np.load(root / "cpu" / n)).max()
                for n in names]
        ok = (n_cpu == n_card == 5 and names == sorted(p.name for p in
                                                       (root / "card").glob("*.npy"))
              and max(errs) <= 1e-4)
        log(f"[small-data] preprocess scan {durations.tolist()} s; encode {n_card} windows on "
            f"the card in {wall:.3f} s, card vs CPU max|diff| {max(errs):.3e} (bar 1e-4) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("chip_smoke: preprocess encode on the card disagrees with the CPU")


def lora_tiny_trainers(torch, cfg):
    """A tiny LoRATrainer on the CPU and one on the card with the same base
    and the same adapter, its b drawn nonzero so that every factor gets a
    gradient."""
    from jen1_tpu_torch.train.train import build_trainer

    cpu, card = build_trainer(cfg, device="cpu"), build_trainer(cfg, device="cuda")
    card.model.load_state_dict(cpu.model.state_dict())
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for path, ab in cpu.adapter.items():
            ab["b"].copy_(0.05 * torch.randn(ab["b"].shape, generator=g))
            for k in ("a", "b"):
                card.adapter[path][k].copy_(ab[k])
    return cpu, card


def adapter_grad_worst(card, cpu):
    """(largest share of its bar, leaf name) over the adapter's gradient
    leaves, each within 5e-3 * max|g_cpu| of the leaf (floored as in
    worst_grad_leaf)."""
    refs = [p.grad for p in cpu.params]
    floor = GRAD_LEAF_FLOOR * max(r.abs().max().item() for r in refs)
    worst, worst_name = 0.0, ""
    for name, p, ref in zip(card._names(), card.params, refs):
        ratio = (p.grad.cpu() - ref).abs().max().item() / (5e-3 * max(ref.abs().max().item(),
                                                                      floor))
        if ratio >= worst:
            worst, worst_name = ratio, name
    return worst, worst_name


def phase_small_lora(torch) -> None:
    """LoRA at tiny widths (tiny_train_config: L = 520, so the level-1
    transformer's 130 frames take K1/K2/K3 with head dim 8 padded to 16),
    rank 4, alpha 8, the default targets: two steps of a LoRATrainer on the
    card and on the CPU with the same base, adapter and draws, then the same
    with remat=True. Losses within rtol 2e-3 and every adapter gradient leaf
    within the train bar, card against CPU and remat against plain; the
    card's base bit-unchanged. Then Jen1(ckpt_path=base, lora_path=run) on
    both devices generates (VDM, 4 steps, 13 s, one x_T) at the sampler bar."""
    import copy
    import dataclasses

    import numpy as np

    from jen1_tpu_torch.ckpt.checkpoint import CheckpointManager
    from jen1_tpu_torch.diffusion import vdm
    from jen1_tpu_torch.train.trainer import step_generator

    base_cfg = tiny_train_config()
    base_cfg.lora_config.rank, base_cfg.lora_config.alpha = 4, 8.0
    host = tiny_batch(base_cfg.model_config)
    card_grads = {}
    with scratch_dir() as d:
        for remat in (False, True):
            cfg = copy.deepcopy(base_cfg)
            cfg.model_config = dataclasses.replace(cfg.model_config, remat=remat)
            cpu, card = lora_tiny_trainers(torch, cfg)
            base = [p.detach().clone() for p in card.model.parameters()]
            states = {"cpu": cpu.init_state(), "card": card.init_state()}
            for step in range(2):
                flags = cpu._causal_flags(Coin(step))
                draws = type(cpu).draw_randoms(cpu, step_generator("cpu", 1, step), flags,
                                               host["latents"].shape)
                cpu.draw_randoms = lambda *a: draws
                moved = move_draws(torch, draws, "cuda")
                card.draw_randoms = lambda *a: moved
                metrics = {}
                before = launch_counts()
                for name, tr in (("cpu", cpu), ("card", card)):
                    batch = {k: torch.as_tensor(v, device=tr.device) for k, v in host.items()}
                    states[name], m = tr.train_step(states[name], batch, None, Coin(step))
                    metrics[name] = {k: float(v) for k, v in m.items()}
                launched = [a - b for a, b in zip(launch_counts(), before)]
                worst, worst_name = adapter_grad_worst(card, cpu)
                grads = [p.grad.cpu() for p in card.params]
                if remat:
                    plain = card_grads[step]
                    floor = GRAD_LEAF_FLOOR * max(g.abs().max().item() for g in plain)
                    remat_worst = max((g - r).abs().max().item()
                                      / (5e-3 * max(r.abs().max().item(), floor))
                                      for g, r in zip(grads, plain))
                else:
                    card_grads[step], remat_worst = grads, 0.0
                ok = (all(np.isclose(metrics["card"][k], metrics["cpu"][k], rtol=2e-3, atol=0)
                          for k in metrics["cpu"] if k.startswith("loss"))
                      and worst <= 1.0 and remat_worst <= 1.0 and min(launched) > 0)
                log(f"[small-lora] remat={remat} step {step}: loss/train card "
                    f"{metrics['card']['loss/train']:.6f} cpu {metrics['cpu']['loss/train']:.6f};"
                    f" worst adapter gradient leaf {worst_name} at {worst:.4f} of its bar; "
                    f"remat against plain {remat_worst:.4f} of the bar; K1/K2/K3 launches "
                    f"{launched} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit("chip_smoke: the tiny LoRA step on the card disagrees")
            unchanged = all(torch.equal(a, p) for a, p in zip(base, card.model.parameters()))
            if not unchanged or any(p.grad is not None for p in card.model.parameters()):
                raise SystemExit("chip_smoke: the LoRA step changed the frozen base")
        CheckpointManager(f"{d}/base").save(
            0, {f"params/{n}": p for n, p in cpu.model.named_parameters()}, loss=0.0)
        CheckpointManager(f"{d}/run").save(2, card.state_dict(states["card"]), loss=0.0)
        cfg = tiny_train_config()
        cfg.lora_config.alpha = 8.0
        draw = vdm.initial_noise
        vdm.initial_noise = lambda shape, generator, device: torch.randn(
            tuple(shape), generator=torch.Generator().manual_seed(7)).to(device)
        try:
            jcpu, jcard = tiny_pair(torch, cfg=cfg, ckpt_path=f"{d}/base", lora_path=f"{d}/run")
            kw = dict(seed=5, steps=4, seconds=13)
            ref = jcpu.generate("a merged song", **kw)
            out = jcard.generate("a merged song", **kw)
        finally:
            vdm.initial_noise = draw
    err = float(np.abs(out - ref).max())
    ok = out.shape == ref.shape and np.allclose(out, ref, rtol=2e-2, atol=2e-3)
    log(f"[small-lora] Jen1(ckpt_path=base, lora_path=run) generate card vs CPU: scale "
        f"{jcard.lora_scale}, max|diff|={err:.3e} (rtol 2e-2, atol 2e-3) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: the LoRA-merged generate() on the card disagrees")


def phase_small_composer(torch) -> None:
    """Composer at tiny widths (tiny_composer_test_config(2) with the flash
    path, 4 latent dims per track): one train step of the four tasks,
    track_gen among them (a draw that keeps one of the two tracks), on the
    card against the CPU with the same draws (the small-train bars); then
    generate_tracks (GDM DDIM, 4 steps, 13 s, track 0 given as a clip) on
    both with the same x_T and step noise, at the sampler bar."""
    import dataclasses

    import numpy as np

    from jen1_tpu_torch.config import tiny_composer_test_config
    from jen1_tpu_torch.diffusion import gdm
    from jen1_tpu_torch.train.train import build_trainer
    from jen1_tpu_torch.train.trainer import step_generator

    cfg = tiny_composer_test_config(2)
    cfg.model_config = dataclasses.replace(cfg.model_config, use_flash_attention=True,
                                           flash_min_seq_len=128)
    cfg.conditioner_config.t5_config.t5_model_name = "tiny-test"
    cfg.conditioner_config.t5_config.max_length = cfg.model_config.context_embedding_max_length
    cpu, card = build_trainer(cfg, device="cpu"), build_trainer(cfg, device="cuda")
    card.model.load_state_dict(cpu.model.state_dict())
    g = np.random.default_rng(1)
    mc = cfg.model_config
    m = mc.context_embedding_max_length
    host = {"latents": g.standard_normal((4, 520, mc.in_channels)).astype(np.float32),
            "text_emb": g.standard_normal((4, m, mc.context_embedding_features))
            .astype(np.float32),
            "text_mask": np.ones((4, m), bool)}
    flags = cpu._causal_flags(Coin(1))
    draws = type(cpu).draw_randoms(cpu, step_generator("cpu", 9, 0), flags,
                                   host["latents"].shape)
    cpu.draw_randoms = lambda *a: draws
    moved = move_draws(torch, draws, "cuda")
    card.draw_randoms = lambda *a: moved
    metrics = {}
    for name, tr in (("cpu", cpu), ("card", card)):
        batch = {k: torch.as_tensor(v, device=tr.device) for k, v in host.items()}
        _, mt = tr.train_step(tr.init_state(), batch, None, Coin(1))
        metrics[name] = {k: float(v) for k, v in mt.items()}
    worst, worst_name = worst_grad_leaf(card.model, [p.grad for p in cpu.model.parameters()])
    ok = ("loss_track_gen/train" in metrics["card"] and worst <= 1.0
          and all(np.isclose(metrics["card"][k], metrics["cpu"][k], rtol=2e-3, atol=0)
                  for k in metrics["cpu"] if k.startswith("loss")))
    log(f"[small-composer] track_gen train step card vs CPU: keep-bits "
        f"{draws.track_bits['track_gen'].int().tolist()}; losses card "
        + " ".join(f"{k}={v:.6f}" for k, v in metrics["card"].items())
        + f"; worst gradient leaf {worst_name} at {worst:.4f} of its bar "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: the tiny track_gen step on the card disagrees")
    del cpu, card

    jcpu, jcard = tiny_pair(torch, cfg=cfg, codec=dict(TINY_CODEC, dimension=4))
    shape = (1, 520, mc.in_channels)
    stream = torch.Generator().manual_seed(9)
    x_t = torch.randn(shape, generator=stream)
    noises = [torch.randn(shape, generator=stream) for _ in range(4)]
    saved = (gdm.initial_noise, gdm.step_noise)
    gdm.initial_noise = lambda shape, generator, device: x_t.to(device)
    gdm.step_noise = lambda x, generator, index, uniform=False: noises[index].to(x.device)
    try:
        clip = synthetic_clip(np, 8, 13, 1600)
        kw = dict(seed=3, steps=4, seconds=13, context_tracks={0: clip})
        ref = jcpu.generate_tracks("two stems", **kw)
        before = launch_counts()[0]
        out = jcard.generate_tracks("two stems", **kw)
        launched = launch_counts()[0] - before
    finally:
        gdm.initial_noise, gdm.step_noise = saved
    err = float(np.abs(out - ref).max())
    ok = (out.shape == ref.shape == (1, 2, 2, 13 * 1600) and launched > 0
          and np.allclose(out, ref, rtol=2e-2, atol=2e-3))
    log(f"[small-composer] generate_tracks card vs CPU: shape {out.shape}, max|diff|={err:.3e} "
        f"(rtol 2e-2, atol 2e-3), K1 launches {launched} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: the tiny generate_tracks on the card disagrees")


def full_train_config(**lora):
    """longform_config() at 30 s windows, B = 3, one optimizer step per
    call, the run's seed; LoRA fields from `lora`."""
    from jen1_tpu_torch.config import longform_config

    cfg = longform_config()
    cfg.dataset_config.sample_duration = TRAIN_SECONDS
    cfg.dataset_config.batch_size = TRAIN_BATCH
    cfg.grad_accum_every = 1
    cfg.seed = TRAIN_SEED
    for k, v in lora.items():
        setattr(cfg.lora_config, k, v)
    return cfg


def reset_launches():
    from jen1_tpu_torch.ops import flash_attention as fa

    fa.LAUNCHES = fa.LAUNCHES_DQ = fa.LAUNCHES_DKV = 0
    fa.LAUNCHES_MMA = fa.LAUNCHES_DQ_MMA = fa.LAUNCHES_DKV_MMA = 0


def mma_counts():
    from jen1_tpu_torch.ops import flash_attention as fa

    return fa.LAUNCHES_MMA, fa.LAUNCHES_DQ_MMA, fa.LAUNCHES_DKV_MMA


def phase_lora(torch) -> tuple:
    """LoRA fine-tuning at full width: longform_config(), rank 16, alpha 16,
    the default targets, the base random from the seed, B = 3, 30 s. Three
    steps, each launching K1/K2/K3 4/4/4, all on the tensor-core route;
    every b gradient of the level-1 attention targets (where K1-K3 run)
    nonzero and finite in the first step; the base bit-unchanged. Step
    walls, peak device memory above the start, the adapter's size and the
    checkpoint's bytes. Then Jen1(lora_path=run): its wall, the load and
    merge wall, and on the card the merged weights of three target leaves
    against W + scale * delta(a, b). Returns the K1/K2/K3 launches."""
    import numpy as np

    from jen1_tpu_torch.api.generation import Jen1
    from jen1_tpu_torch.ckpt.checkpoint import CheckpointManager
    from jen1_tpu_torch.train import lora
    from jen1_tpu_torch.train.train import build_trainer
    from jen1_tpu_torch.train.trainer import step_generator

    cfg = full_train_config(rank=LORA_RANK, alpha=LORA_ALPHA)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    trainer = build_trainer(cfg, device="cuda")
    state = trainer.init_state()
    torch.cuda.synchronize()
    n_adapter = lora.lora_param_count(trainer.adapter)
    n_base = sum(p.numel() for p in trainer.model.parameters())
    log(f"[lora] LoRATrainer built in {time.perf_counter() - t0:.2f} s: {len(trainer.adapter)} "
        f"target kernels, adapter {n_adapter} parameters ({4 * n_adapter} bytes fp32) over a "
        f"frozen base of {n_base}; scale {trainer.scale}")
    frames = int(TRAIN_SECONDS * 150)
    latents = np.random.default_rng(TRAIN_SEED).standard_normal(
        (TRAIN_BATCH, frames, cfg.model_config.in_channels)).astype(np.float32)
    batch = trainer.prepare_batch(latents, [{"prompt": p} for p in TRAIN_PROMPTS])
    base = [p.detach().clone() for p in trainer.model.parameters()]
    # the level-1 self-attention (1125 frames, through K1-K3): downsample1's
    # transformer and its mirror, upsample7's
    level1 = [i for i, n in enumerate(trainer._names())
              if ("downsample1.transformer" in n or "upsample7.transformer" in n)
              and ".attention." in n]
    reset_launches()
    walls, per_step = [], []
    for step in range(LORA_STEPS):
        before = launch_counts()
        mma_before = mma_counts()
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, batch, step_generator("cuda", TRAIN_SEED, step),
                                      np.random.default_rng((TRAIN_SEED, step)))
        loss = m["loss/train"].item()
        walls.append(time.perf_counter() - t0)
        counts = tuple(a - b for a, b in zip(launch_counts(), before))
        mma = tuple(a - b for a, b in zip(mma_counts(), mma_before))
        per_step.append(counts)
        if step == 0:
            b_grads = [trainer.params[i].grad for i in level1 if i % 2 == 1]
            nonzero = sum(bool((g != 0).any()) and bool(torch.isfinite(g).all())
                          for g in b_grads)
            log(f"[lora] step 0: level-1 attention b gradients nonzero and finite {nonzero} of "
                f"{len(b_grads)}")
            if not b_grads or nonzero != len(b_grads):
                raise SystemExit("chip_smoke: a level-1 LoRA target got no gradient")
        log(f"[lora] step {step}: wall {walls[-1]:.4f} s, loss/train {loss:.6f}, grad_norm "
            f"{float(m['grad_norm']):.6f}; K1/K2/K3 launches {counts}, tensor-core {mma}")
        if counts != (TRAIN_LAUNCHES,) * 3 or mma != counts or not np.isfinite(loss):
            raise SystemExit(f"chip_smoke: the LoRA step launched K1/K2/K3 {counts} ({mma} on "
                             f"the tensor-core route), want {TRAIN_LAUNCHES} each")
    peak = torch.cuda.max_memory_allocated() - start_mem
    unchanged = all(torch.equal(a, p) for a, p in zip(base, trainer.model.parameters()))
    del base
    log(f"[lora] {LORA_STEPS} steps: walls {[round(w, 4) for w in walls]} s; peak device "
        f"memory above the start {peak} bytes; base bit-unchanged {unchanged}")
    if not unchanged:
        raise SystemExit("chip_smoke: the LoRA steps changed the frozen base")

    class TimedJen1(Jen1):
        def _merge_lora(self, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scale = super()._merge_lora(*args)
            torch.cuda.synchronize()
            self.merge_wall = time.perf_counter() - t0
            return scale

    with scratch_dir() as d:
        flat = trainer.state_dict(state)
        t0 = time.perf_counter()
        CheckpointManager(d).save(state.step, flat, loss=0.0)
        save_wall = time.perf_counter() - t0
        on_disk = sum(f.stat().st_size for f in Path(d).rglob("*") if f.is_file())
        t0 = time.perf_counter()
        jen1 = TimedJen1(config=cfg, lora_path=d, device="cuda")
        torch.cuda.synchronize()
        build_wall = time.perf_counter() - t0
    log(f"[lora] checkpoint: {len(flat)} tensors, {on_disk} bytes on disk, saved in "
        f"{save_wall:.3f} s; Jen1(lora_path=...) built in {build_wall:.3f} s, of which the "
        f"adapter's load and merge {jen1.merge_wall:.4f} s (scale {jen1.lora_scale})")
    paths = list(trainer.adapter)
    picks = [next(p for p in paths if "downsample1.transformer" in p and ".attention.to_q" in p),
             next(p for p in paths if "to_kv" in p),
             next(p for p in paths if "feed_forward" in p)]
    errs = []
    with torch.no_grad():
        for path in picks:
            module, leaf, w_base = lora.lora_targets(trainer.model, [path])[path]
            want = w_base.float() + lora.lora_delta(module, leaf, w_base, trainer.adapter[path],
                                                    jen1.lora_scale)
            got = jen1.model.get_parameter(lora.flax_paths(jen1.model)[path])
            errs.append(float((got.float() - want).abs().max()))
    log(f"[lora] merged weights on the card against W + scale * a @ b: max|diff| {errs} for "
        f"{picks}")
    if max(errs) > 1e-6:
        raise SystemExit("chip_smoke: Jen1(lora_path=...) merged other weights")
    del trainer, state, jen1, flat
    gc.collect()
    torch.cuda.empty_cache()
    return tuple(sum(s[i] for s in per_step) for i in range(3))


def phase_wav_train(torch) -> tuple:
    """Training from audio files at full width: four 30 s 48 kHz stereo WAV
    files (three train windows, one validation), longform_config(), B = 3,
    `train.run(dataset_dir=...)` for 5 steps with profile=True. Each step
    encodes its batch on the card (whole-clip EnCodec, random weights) and
    launches K1/K2/K3 4/4/4, all on the tensor-core route; the encode and
    step walls from the run's metrics; the trace of steps 2-4 must exist
    and name K1's, K2's and K3's kernels. Returns the K1/K2/K3 launches."""
    import json
    import warnings

    import numpy as np

    from jen1_tpu_torch.data.audio_io import write_wav
    from jen1_tpu_torch.train import train as train_mod

    cfg = full_train_config()
    with scratch_dir() as d:
        root = Path(d)
        (root / "audios").mkdir()
        (root / "metadata").mkdir()
        t0 = time.perf_counter()
        for i in range(WAV_FILES):
            write_wav(str(root / "audios" / f"song{i}.wav"),
                      synthetic_clip(np, 60 + i, TRAIN_SECONDS, 48_000), 48_000)
            (root / "metadata" / f"song{i}.json").write_text(
                json.dumps({"prompt": TRAIN_PROMPTS[i % len(TRAIN_PROMPTS)]}))
        log(f"[wav-train] {WAV_FILES} x {TRAIN_SECONDS} s WAV files written in "
            f"{time.perf_counter() - t0:.2f} s")
        dc = cfg.dataset_config
        dc.dataset_dir = str(root)
        dc.train_test_split = 0.75
        cfg.eval_interval = 0
        cfg.log_dir = str(root / "logs")
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="jen1_tpu_torch: no codec weights")
            trainer, state = train_mod.run(cfg, max_steps=WAV_STEPS, device="cuda",
                                           profile=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, mma = launch_counts(), mma_counts()
        records = [json.loads(line) for line in
                   (root / "logs" / "metrics.jsonl").read_text().splitlines()]
        steps = [r for r in records if "loss/train" in r]
        traces = sorted((root / "logs").glob("trace_*.json"))
        text = traces[0].read_text() if traces else ""
        named = {k: text.count(k) for k in ("flash_fwd_mma", "flash_bwd_dq_mma",
                                             "flash_bwd_dkv_mma", "train_step", "encode")}
        log(f"[wav-train] train.run over {WAV_STEPS} steps in {wall:.2f} s (codec and trainer "
            f"built, probe encode, profiler export included): encode walls "
            f"{[round(r['encode_time'], 4) for r in steps]} s, step walls "
            f"{[round(r['step_time'], 4) for r in steps]} s, losses "
            f"{[round(r['loss/train'], 4) for r in steps]}; K1/K2/K3 launches {counts}, "
            f"tensor-core {mma}; trace {[t.name for t in traces]} "
            f"({len(text)} bytes) names {named}")
    want = (TRAIN_LAUNCHES * WAV_STEPS,) * 3
    if len(steps) != WAV_STEPS or not all(np.isfinite(r["loss/train"]) for r in steps):
        raise SystemExit("chip_smoke: the wav training run did not take its steps")
    if counts != want or mma != counts:
        raise SystemExit(f"chip_smoke: wav training launched K1/K2/K3 {counts} ({mma} on the "
                         f"tensor-core route), want {want}")
    if len(traces) != 1 or min(named.values()) == 0:
        raise SystemExit("chip_smoke: the --profile trace is missing or names no port kernel")
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_composer(torch) -> int:
    """Composer at full width: Jen1(composer_config(4)) (in/out 512
    channels, four 128-dim tracks), generate_tracks at 30 s, GDM DDIM,
    track 0 given as a 30 s clip; steps cut to 20. A 2-step warm-up, then
    the timed request: wall, peak device memory, K1 launches, the output's
    shape and finiteness. Returns the K1 launches of the timed request."""
    import warnings

    import numpy as np

    from jen1_tpu_torch.api.generation import Jen1
    from jen1_tpu_torch.config import composer_config

    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="jen1_tpu_torch: ")
        jen1 = Jen1(config=composer_config(COMPOSER_TRACKS), device="cuda")
    torch.cuda.synchronize()
    log(f"[composer] Jen1(composer_config({COMPOSER_TRACKS})) built in "
        f"{time.perf_counter() - t0:.2f} s; UNet params "
        f"{sum(p.numel() for p in jen1.model.parameters())}")
    clip = synthetic_clip(np, 70, COMPOSER_SECONDS, 48_000)
    kw = dict(seed=12, seconds=COMPOSER_SECONDS, context_tracks={0: clip})
    jen1.generate_tracks("a four-piece band", steps=2, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_mem = torch.cuda.memory_allocated()
    before = launch_counts()[0]
    t0 = time.perf_counter()
    out = jen1.generate_tracks("a four-piece band", steps=COMPOSER_STEPS, **kw)
    wall = time.perf_counter() - t0
    launched = launch_counts()[0] - before
    peak = torch.cuda.max_memory_allocated() - start_mem
    want = (1, COMPOSER_TRACKS, 2, COMPOSER_SECONDS * 48_000)
    ok = out.shape == want and bool(np.isfinite(out).all())
    log(f"[composer] generate_tracks {COMPOSER_SECONDS} s, {COMPOSER_STEPS} DDIM steps, one "
        f"context track: wall {wall:.4f} s, peak device memory above the start {peak} bytes, "
        f"K1 launches {launched}; out {out.shape}, finite {bool(np.isfinite(out).all())}, "
        f"rms {float(np.sqrt((out ** 2).mean())):.4f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: generate_tracks at full width failed")
    del jen1
    gc.collect()
    torch.cuda.empty_cache()
    return launched


def snake_alphas(torch, model) -> int:
    """Draw every Snake alpha of a CPU model from U(0.5, 1.5); returns how
    many tensors were drawn."""
    g = torch.Generator().manual_seed(SMALL_ALPHA_SEED)
    drawn = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("snake.alpha"):
                p.copy_(torch.rand(p.shape, generator=g) + 0.5)
                drawn += 1
    return drawn


def close_report(torch, out, ref, rtol: float, atol: float):
    """(allclose, max|diff|) of a card tensor against a CPU one."""
    out, ref = out.detach().float().cpu(), ref.detach().float().cpu()
    ok = out.shape == ref.shape and bool(torch.allclose(out, ref, rtol=rtol, atol=atol))
    return ok, (out - ref).abs().max().item()


def phase_small_features(torch) -> None:
    """The model features of this slice at tiny widths, card against CPU:
    Snake generate() (VDM and DDIM) and a Snake train step (alpha gradients
    included), STFT UNet forwards with and without use_stft_context and the
    DC bin's phase sign, the three-type MultiConditioner and a UNet with
    global features, the reference .pth export -> import round trip, and
    the eval metrics with a random VGGish."""
    import dataclasses
    import warnings

    import numpy as np

    from jen1_tpu_torch.ckpt.torch_export import export_reference_unet, save_reference_checkpoint
    from jen1_tpu_torch.ckpt.torch_import import load_reference_checkpoint
    from jen1_tpu_torch.conditioning.conditioners import (
        assemble_conditioning, create_multi_conditioner,
    )
    from jen1_tpu_torch.config import (
        ConditionerConfig, IntConfig, NumberConfig, T5Config, tiny_test_config,
    )
    from jen1_tpu_torch.diffusion import gdm, vdm
    from jen1_tpu_torch.eval import metrics as em
    from jen1_tpu_torch.eval.vggish import VGGishEmbedder
    from jen1_tpu_torch.models.unet import unet_from_model_config
    from jen1_tpu_torch.ops import flash_attention as fa
    from jen1_tpu_torch.ops.conv import fp32_precision
    from jen1_tpu_torch.ops.initializers import init_module
    from jen1_tpu_torch.ops.stft import STFT

    def fail(what):
        raise SystemExit(f"chip_smoke: small-features: {what} on the card disagrees with the CPU")

    # Snake generate(): VDM and DDIM with x_T and the step noise from one CPU stream
    cfg = tiny_test_config()
    cfg.model_config = dataclasses.replace(
        cfg.model_config, use_flash_attention=True, flash_min_seq_len=128, attention_heads=1,
        use_snake=True, tie_transformer_projections=True)
    cpu, card = tiny_pair(torch, cfg=cfg)
    alphas = snake_alphas(torch, cpu.model)
    card.model.load_state_dict(cpu.model.state_dict())
    stream = torch.Generator().manual_seed(7)
    steps, shape = 4, (1, 520, 8)
    x_t = torch.randn(shape, generator=stream)
    noises = [torch.randn(shape, generator=stream) for _ in range(steps)]
    saved = (vdm.initial_noise, gdm.initial_noise, gdm.step_noise)
    vdm.initial_noise = gdm.initial_noise = lambda shape, generator, device: x_t.to(device)
    gdm.step_noise = lambda x, generator, index, uniform=False: noises[index].to(x.device)
    try:
        for use_gdm in (False, True):
            kw = dict(seed=5, steps=steps, seconds=13, use_gdm=use_gdm)
            ref = cpu.generate("a snake charmer's flute", **kw)
            before = fa.LAUNCHES
            out = card.generate("a snake charmer's flute", **kw)
            launched = fa.LAUNCHES - before
            ok = out.shape == ref.shape and np.allclose(out, ref, rtol=2e-2, atol=2e-3)
            log(f"[small-features] Snake generate() ({'DDIM' if use_gdm else 'VDM'}, {alphas} "
                f"alphas from U(0.5, 1.5)) card vs CPU: max|diff|={np.abs(out - ref).max():.3e} "
                f"(rtol 2e-2, atol 2e-3); K1 launches {launched}")
            if not ok or launched == 0:
                fail("the Snake generate()")
    finally:
        vdm.initial_noise, gdm.initial_noise, gdm.step_noise = saved

    # the reference .pth round trip of the card's Snake UNet
    mc = cfg.model_config
    sd_card, sd_cpu = export_reference_unet(card.model, mc), export_reference_unet(cpu.model, mc)
    same = set(sd_card) == set(sd_cpu) and all(torch.equal(sd_card[k], sd_cpu[k]) for k in sd_cpu)
    with scratch_dir() as d:
        path = str(Path(d) / "tiny_snake.pth")
        save_reference_checkpoint(path, card.model, mc, epoch=1)
        fresh = unet_from_model_config(mc).to("cuda")
        load_reference_checkpoint(path, fresh, mc)
    exact = all(torch.equal(a, b) for a, b in zip(card.model.parameters(), fresh.parameters()))
    n_alpha = sum(k.endswith("activation.alpha") for k in sd_card)
    log(f"[small-features] export_reference_unet: {len(sd_card)} tensors ({n_alpha} "
        f"activation.alpha), card = CPU export {same}; -> .pth -> torch_import bit-equal {exact}")
    if not (same and exact and n_alpha == alphas):
        raise SystemExit("chip_smoke: small-features: the .pth round trip changed the weights")
    del cpu, card, fresh

    # a Snake train step, the alphas' gradients included
    tcfg = tiny_train_config()
    tcfg.model_config = dataclasses.replace(tcfg.model_config, use_snake=True)
    cpu_tr, card_tr = small_train_compare(torch, tcfg, "small-features", (1,),
                                          prepare=lambda m: snake_alphas(torch, m))
    grads = [(n, p.grad) for n, p in card_tr.model.named_parameters()
             if n.endswith("snake.alpha")]
    finite = all(bool(torch.isfinite(g).all()) and g.abs().max().item() > 0 for _, g in grads)
    log(f"[small-features] Snake train step: {len(grads)} alpha gradient leaves on the card, "
        f"finite and nonzero {finite}")
    if not grads or not finite:
        raise SystemExit("chip_smoke: small-features: an alpha gradient is zero or not finite")
    del cpu_tr, card_tr

    # the STFT: the DC bin's phase sign, and the STFT UNet forwards
    g = torch.Generator().manual_seed(12)
    wave = 0.3 * torch.randn((1, 2, 48_000), generator=g) + torch.tensor([-1.0, 1.0])[None, :, None]
    stft = STFT()
    mag_c, ph_c = stft.encode(wave)
    mag_g, ph_g = stft.encode(wave.cuda())
    frames = torch.nn.functional.pad(wave.reshape(2, 1, -1), (511, 511), mode="reflect")[:, 0]
    raw = torch.fft.rfft(frames.unfold(-1, 1023, 256).cuda(), dim=-1)
    neg = int(torch.signbit(raw[..., 0].imag).sum())
    pi_dc = int((ph_c[:, :, 0] == float(np.float32(np.pi))).sum())
    dc_equal = torch.equal(ph_g[:, :, 0].cpu(), ph_c[:, :, 0])
    ok_mag, err_mag = close_report(torch, mag_g, mag_c, 1e-4, 1e-4 * mag_c.abs().max().item())
    log(f"[small-features] STFT encode card vs CPU: magnitude max|diff|={err_mag:.3e} "
        f"(rtol 1e-4, atol 1e-4 of the largest); DC phase equal {dc_equal} ({pi_dc} frames at "
        f"+pi); cuFFT's own DC imaginary parts with the sign bit set: {neg} of {raw[..., 0].numel()}")
    if not (dc_equal and ok_mag and pi_dc > 0):
        fail("the STFT encode")
    for use_ctx in (False, True):
        smc = dataclasses.replace(
            tiny_test_config().model_config, in_channels=2, out_channels=2,
            context_channels=(3,), use_stft=True, use_stft_context=use_ctx, stft_num_fft=63,
            stft_hop_length=16)
        cpu_m = init_module(unet_from_model_config(smc), torch.Generator().manual_seed(11)).eval()
        card_m = unet_from_model_config(smc).to("cuda").eval()
        card_m.load_state_dict(cpu_m.state_dict())
        m = smc.context_embedding_max_length
        inputs = [0.5 * torch.randn((2, 1008, 2), generator=g) - 1.0,
                  torch.rand((2,), generator=g)]
        kw = dict(embedding=torch.randn((2, m, 16), generator=g),
                  embedding_mask=torch.ones((2, m), dtype=torch.bool),
                  channels_list=[torch.randn((2, 1008 if use_ctx else 63, 3), generator=g)])
        with torch.no_grad(), fp32_precision():
            ref = cpu_m(*inputs, **kw)
            out = card_m(*[t.cuda() for t in inputs],
                         **{k: ([c.cuda() for c in v] if isinstance(v, list) else v.cuda())
                            for k, v in kw.items()})
        ok, err = close_report(torch, out, ref, 2e-3, 2e-4)
        log(f"[small-features] STFT UNet use_stft_context={use_ctx}: output {tuple(out.shape)} "
            f"card vs CPU max|diff|={err:.3e} (rtol 2e-3, atol 2e-4)")
        if not ok or out.shape != inputs[0].shape:
            fail("the STFT UNet forward")

    # the three conditioner types, and a UNet with global features
    ccfg = ConditionerConfig(cond_dim=16, conditioning_type=("t5", "int", "number"),
                             t5_config=T5Config(t5_model_name="tiny-test", max_length=8),
                             int_config=IntConfig(max_val=16),
                             number_config=NumberConfig(max_val=100))
    cond_cpu = create_multi_conditioner(ccfg, device="cpu")
    cond_card = create_multi_conditioner(ccfg, device="cuda")
    for key, c in cond_cpu.conditioners.items():
        cond_card.conditioners[key].load_state_dict(c.state_dict())
    metadata = [{"prompt": "a song", "seconds_start": 3, "seconds_total": 60.0},
                {"prompt": "prompt only"}]
    out_cpu, out_card = cond_cpu(metadata), cond_card(metadata)
    for key in out_cpu:
        ok, err = close_report(torch, out_card[key][0], out_cpu[key][0], 1e-4, 1e-4)
        masks = torch.equal(out_card[key][1].cpu(), out_cpu[key][1].cpu())
        log(f"[small-features] conditioner {key!r}: card vs CPU max|diff|={err:.3e} "
            f"(rtol 1e-4, atol 1e-4), masks equal {masks}")
        if not (ok and masks):
            fail(f"the {key} conditioner")
    ids = dict(cross_attn_cond_ids=(), global_cond_ids=("seconds_start", "seconds_total"),
               input_concat_ids=())
    feats = {dev: assemble_conditioning(o, **ids)["global_cond"]
             for dev, o in (("cpu", out_cpu), ("cuda", out_card))}
    gmc = dataclasses.replace(tiny_test_config().model_config, context_features=32)
    cpu_m = init_module(unet_from_model_config(gmc), torch.Generator().manual_seed(12)).eval()
    card_m = unet_from_model_config(gmc).to("cuda").eval()
    card_m.load_state_dict(cpu_m.state_dict())
    x, t = torch.randn((2, 48, 8), generator=g), torch.rand((2,), generator=g)
    emb, ch = torch.randn((2, 6, 16), generator=g), torch.randn((2, 48, 9), generator=g)
    kw = dict(embedding_scale=2.5, batch_cfg=True, scale_cfg=True)
    with torch.no_grad(), fp32_precision():
        ref = cpu_m(x, t, embedding=emb, features=feats["cpu"], channels_list=[ch], **kw)
        out = card_m(x.cuda(), t.cuda(), embedding=emb.cuda(), features=feats["cuda"],
                     channels_list=[ch.cuda()], **kw)
    ok, err = close_report(torch, out, ref, 5e-3, 5e-4)
    log(f"[small-features] UNetCFG1d with global features (32 = int + number embeddings), "
        f"batch CFG: card vs CPU max|diff|={err:.3e} (rtol 5e-3, atol 5e-4)")
    if not ok:
        fail("the global-features UNet")

    # eval: log-mel FAD, SNR, spectral convergence, a random VGGish's embeddings
    rng = np.random.default_rng(14)
    sets = [(0.3 * rng.standard_normal((2, 96_000, 2))).astype(np.float32) for _ in range(2)]
    sets[1] += 0.2 * np.sin(np.arange(96_000) * 0.05)[None, :, None].astype(np.float32)
    results = {}
    for dev in ("cpu", "cuda"):
        r, c = (torch.from_numpy(a).to(dev) for a in sets)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            embed = VGGishEmbedder(seed=VGGISH_SEED, device=dev)
        results[dev] = (em.frechet_audio_distance(r, c), em.signal_to_noise_ratio(r, c).cpu(),
                        em.spectral_convergence(r, c).cpu(), embed(r).cpu())
    (fad_c, snr_c, sc_c, v_c), (fad_g, snr_g, sc_g, v_g) = results["cpu"], results["cuda"]
    ok = (abs(fad_g - fad_c) <= 1e-3 * abs(fad_c)
          and close_report(torch, snr_g, snr_c, 1e-4, 1e-6)[0]
          and close_report(torch, sc_g, sc_c, 1e-4, 1e-6)[0])
    ok_v, err_v = close_report(torch, v_g, v_c, 1e-4, 1e-5 * v_c.abs().max().item())
    log(f"[small-features] eval card vs CPU: log-mel FAD {fad_g:.6f} vs {fad_c:.6f} (rel 1e-3); "
        f"SNR dB {snr_g.tolist()} vs {snr_c.tolist()}, spectral convergence {sc_g.tolist()} vs "
        f"{sc_c.tolist()} (rtol 1e-4); random VGGish embeddings {tuple(v_g.shape)} max|diff|="
        f"{err_v:.3e} (rtol 1e-4, atol 1e-5 of the largest)")
    if not (ok and ok_v):
        fail("an eval metric")


def phase_snake(torch, main_kernels: int) -> tuple:
    """Snake at full width: Jen1(longform_config() with use_snake) makes two
    100-step 30 s VDM requests (K1 200 each, all tensor-core), a profiled
    10-step request beside phase main's, a reference .pth export that
    Jen1(ckpt_path=...) reads back bit for bit (and with bf16 weights keeps
    alpha fp32); then two train steps at B = 3 (K1/K2/K3 4/4/4 each,
    tensor-core, every alpha gradient finite and nonzero). `main_kernels`:
    the device kernels of phase main's profiled request. Returns the K1
    launches of the requests and of the steps, the K2 and K3 ones, and the
    two requests' audio."""
    import dataclasses

    import numpy as np

    from jen1_tpu_torch.api.generation import Jen1
    from jen1_tpu_torch.ckpt.torch_export import save_reference_checkpoint
    from jen1_tpu_torch.config import longform_config
    from jen1_tpu_torch.ops import flash_attention as fa
    from jen1_tpu_torch.train.train import build_trainer
    from jen1_tpu_torch.train.trainer import step_generator

    cfg = longform_config()
    cfg.model_config = dataclasses.replace(cfg.model_config, use_snake=True,
                                           tie_transformer_projections=True)
    t0 = time.perf_counter()
    jen1 = Jen1(config=cfg, device="cuda")
    torch.cuda.synchronize()
    alphas = [p for n, p in jen1.model.named_parameters() if n.endswith("snake.alpha")]
    log(f"[snake] Jen1(longform_config(), use_snake=True) built in "
        f"{time.perf_counter() - t0:.2f} s; UNet params "
        f"{sum(p.numel() for p in jen1.model.parameters())}, {len(alphas)} Snake alphas "
        f"({sum(p.numel() for p in alphas)} values)")
    samples = SLICE_SECONDS * jen1.sample_rate
    _, wall = sync_wall(torch, lambda: jen1.generate("warm-up", seed=1, steps=5,
                                                     seconds=SLICE_SECONDS))
    log(f"[snake] 5-step warm-up request {wall:.3f} s")

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    outs, launches = [], []
    for prompt, seed in SLICE_PROMPTS:
        before = fa.LAUNCHES
        out, wall = sync_wall(torch, lambda: jen1.generate(
            prompt, seed=seed, steps=SLICE_STEPS, batch_size=1, seconds=SLICE_SECONDS))
        launches.append(fa.LAUNCHES - before)
        outs.append(out)
        phases = " ".join(f"{k}={v:.4f}" for k, v in jen1.last_timings.items())
        log(f"[snake] request seed={seed}: wall {wall:.4f} s; phases (s): {phases}; K1 "
            f"launches {launches[-1]}; shape {out.shape}; finite {bool(np.isfinite(out).all())}")
    total = fa.LAUNCHES
    log(f"[snake] peak device memory {torch.cuda.max_memory_allocated()} bytes; K1 launches "
        f"{total}, {fa.LAUNCHES_MMA} on the tensor-core route")
    if launches != [2 * SLICE_STEPS] * len(SLICE_PROMPTS) or fa.LAUNCHES_MMA != total:
        raise SystemExit(f"chip_smoke: snake: K1 launches per request {launches}, "
                         f"{fa.LAUNCHES_MMA} of {total} tensor-core; want {2 * SLICE_STEPS}, all")
    for out in outs:
        if out.shape != (1, 2, samples) or not np.isfinite(out).all():
            raise SystemExit(f"chip_smoke: snake: bad output shape {out.shape} or non-finite")
    prompt, seed = SLICE_PROMPTS[0]
    by_name = profile_window(torch, "snake-profile", f"{PROFILE_STEPS}-step request",
                             lambda: jen1.generate(prompt, seed=seed, steps=PROFILE_STEPS,
                                                   seconds=SLICE_SECONDS))
    kernels = sum(n for n, _ in by_name.values())
    log(f"[snake] device kernels in the profiled {PROFILE_STEPS}-step request: {kernels}, phase "
        f"main's {main_kernels}: {(kernels - main_kernels) / PROFILE_STEPS:.1f} more per "
        f"sampler step ({kernels / main_kernels:.4f} x)")

    with scratch_dir() as d:
        path = str(Path(d) / "jen1_snake.pth")
        _, wall = sync_wall(torch, lambda: save_reference_checkpoint(
            path, jen1.model, cfg.model_config, epoch=1))
        log(f"[snake] save_reference_checkpoint {wall:.3f} s, {Path(path).stat().st_size} bytes")
        kw = dict(config=cfg, conditioner=jen1.conditioner, codec=jen1.codec, device="cuda")
        loaded, wall = sync_wall(torch, lambda: Jen1(path, **kw))
        exact = all(torch.equal(a, b) for a, b in
                    zip(jen1.model.parameters(), loaded.model.parameters()))
        del loaded
        half = Jen1(path, weights_dtype="bfloat16", **kw)
        dtypes = {n: p.dtype for n, p in half.model.named_parameters()}
        del half
    alpha_fp32 = all(dt == torch.float32 for n, dt in dtypes.items() if n.endswith("snake.alpha"))
    n_bf16 = sum(dt == torch.bfloat16 for dt in dtypes.values())
    log(f"[snake] Jen1(ckpt_path=.pth) in {wall:.3f} s: every UNet weight bit-equal {exact}; "
        f"weights_dtype='bfloat16': {n_bf16} tensors bf16, every alpha fp32 {alpha_fp32}")
    if not (exact and alpha_fp32 and n_bf16 > 0):
        raise SystemExit("chip_smoke: snake: the .pth export did not load back as saved")
    del jen1
    gc.collect()
    torch.cuda.empty_cache()

    tcfg = full_train_config()
    tcfg.model_config = dataclasses.replace(tcfg.model_config, use_snake=True)
    t0 = time.perf_counter()
    trainer = build_trainer(tcfg, device="cuda")
    state = trainer.init_state()
    latents = np.random.default_rng(TRAIN_SEED).standard_normal(
        (TRAIN_BATCH, int(TRAIN_SECONDS * 150), tcfg.model_config.in_channels)).astype(np.float32)
    batch = trainer.prepare_batch(latents, [{"prompt": p} for p in TRAIN_PROMPTS])
    torch.cuda.synchronize()
    log(f"[snake] Snake trainer built and batch prepared in {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    per_step = []
    for i in range(SNAKE_TRAIN_STEPS):
        before = launch_counts()
        (state, m), wall = sync_wall(torch, lambda: trainer.train_step(
            state, batch, step_generator(trainer.device, TRAIN_SEED, i),
            np.random.default_rng((TRAIN_SEED, i))))
        per_step.append(tuple(a - b for a, b in zip(launch_counts(), before)))
        grads = [p.grad for n, p in trainer.model.named_parameters() if n.endswith("snake.alpha")]
        finite = all(bool(torch.isfinite(g).all()) and g.abs().max().item() > 0 for g in grads)
        loss = m["loss/train"].item()
        log(f"[snake] train step {i}: wall {wall:.4f} s; loss/train {loss:.6f}; K1/K2/K3 "
            f"{per_step[-1]}; {len(grads)} alpha gradients finite and nonzero {finite}; "
            f"largest |alpha grad| {max(g.abs().max().item() for g in grads):.3e}")
        if not (finite and np.isfinite(loss)):
            raise SystemExit("chip_smoke: snake: a train step gave a zero or non-finite alpha "
                             "gradient or loss")
    counts = launch_counts()
    log(f"[snake] train peak device memory {torch.cuda.max_memory_allocated()} bytes; "
        f"K1/K2/K3 on the tensor-core route {mma_counts()} of {counts}")
    if any(s != (TRAIN_LAUNCHES,) * 3 for s in per_step) or mma_counts() != counts:
        raise SystemExit(f"chip_smoke: snake: K1/K2/K3 per step {per_step}, want "
                         f"{TRAIN_LAUNCHES} each, all tensor-core")
    return total, counts[0], counts[1], counts[2], outs


def phase_stft(torch) -> int:
    """The STFT-domain UNet at full width: UNetCFG1d at longform_config()
    widths with use_stft and use_stft_context, 2 waveform channels in and
    out and 3 context channels, on 30 s of 48 kHz stereo, B = 1 with batch
    CFG (no scale_cfg), bf16 compute: the wall and peak memory of a forward (after a
    warm-up), the output's shape, K1's launches (2 per forward, at N =
    STFT_N, tensor-core). Returns the K1 launches of the timed forwards."""
    import dataclasses

    from jen1_tpu_torch.config import longform_config
    from jen1_tpu_torch.models.unet import unet_from_model_config
    from jen1_tpu_torch.ops import flash_attention as fa
    from jen1_tpu_torch.ops.conv import fp32_precision
    from jen1_tpu_torch.ops.initializers import init_module

    cfg = longform_config()
    mc = dataclasses.replace(cfg.model_config, in_channels=2, out_channels=2,
                             context_channels=(3,), use_stft=True, use_stft_context=True)
    with torch.device("cuda"):
        model = unet_from_model_config(mc).eval()
    init_module(model, torch.Generator(device="cuda").manual_seed(cfg.seed))
    lengths = []
    model.unet.downsample1.transformer.register_forward_pre_hook(
        lambda module, args: lengths.append(args[0].shape[1]))
    samples = STFT_SECONDS * 48_000
    g = torch.Generator(device="cuda").manual_seed(13)
    dt = torch.bfloat16
    x = (0.3 * torch.randn((1, samples, 2), generator=g, device="cuda")).to(dt)
    ctx = torch.randn((1, samples, 3), generator=g, device="cuda").to(dt)
    emb = torch.randn((1, mc.context_embedding_max_length, mc.context_embedding_features),
                      generator=g, device="cuda").to(dt)
    t = torch.rand((1,), generator=g, device="cuda")
    # batch CFG without scale_cfg: its std over the 2 waveform channels is
    # 0 wherever they round to one bf16 value, and 0 / 0 gives NaN (the JAX
    # UNet computes the same)
    v = cfg.diffusion_config.variational_diffusion
    kw = dict(embedding=emb, channels_list=[ctx], embedding_scale=v.embedding_scale,
              batch_cfg=True, scale_cfg=False)
    log(f"[stft] UNetCFG1d(longform widths, use_stft, use_stft_context): "
        f"{sum(p.numel() for p in model.parameters())} params, to_in reads "
        f"{model.unet.to_in.block.block1.project.weight.shape[1]} channels")

    def forward():
        with torch.no_grad(), fp32_precision():
            return model(x, t, **kw)

    out, wall = sync_wall(torch, forward)
    log(f"[stft] warm-up forward {wall:.4f} s")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launches()
    lengths.clear()
    walls = []
    for _ in range(2):
        out, wall = sync_wall(torch, forward)
        walls.append(wall)
    launched, mma = fa.LAUNCHES, fa.LAUNCHES_MMA
    finite = bool(torch.isfinite(out).all())
    log(f"[stft] forward walls {[round(w, 4) for w in walls]} s (30 s stereo, CFG batch 2); "
        f"peak device memory {torch.cuda.max_memory_allocated()} bytes "
        f"({torch.cuda.max_memory_allocated() - base} above the inputs and weights); output "
        f"{tuple(out.shape)} {out.dtype}, finite {finite}; level-1 transformer lengths "
        f"{lengths}; K1 launches {launched}, {mma} tensor-core")
    if tuple(out.shape) != tuple(x.shape) or not finite:
        raise SystemExit(f"chip_smoke: stft: output {tuple(out.shape)} for input "
                         f"{tuple(x.shape)}, finite {finite}")
    if lengths != [STFT_N] * 2 or launched != 4 or mma != launched:
        raise SystemExit(f"chip_smoke: stft: level-1 lengths {lengths} (want {STFT_N}), K1 "
                         f"{launched} launches ({mma} tensor-core), want 4, all")
    return launched


def phase_eval(torch, main_outs, snake_outs) -> None:
    """The eval CLI over phase main's two requests (reference set) and
    phase snake's (candidate set), written by save_audio as WAV: run_eval
    on the card and on the CPU (log-mel FAD, SNR, spectral convergence) and
    a random VGGish FAD through run_eval.evaluate on both, with walls. Bars,
    card vs CPU: log-mel FAD rel 1e-3; VGGish FAD rel 5e-3 (62 embeddings
    per set in 128 dimensions: rank-deficient covariances, whose square
    roots amplify the fp32 rounding of six convs and three GEMMs; an fp32
    square root moved such a distance by 2.6e-4 against fp64 in a CPU
    trial); SNR and spectral convergence rel 1e-4."""
    import contextlib
    import io
    import warnings

    from jen1_tpu_torch.api.generation import save_audio
    from jen1_tpu_torch.eval import run_eval
    from jen1_tpu_torch.eval.vggish import VGGishEmbedder

    with scratch_dir() as d:
        dirs = {}
        for tag, outs in (("main", main_outs), ("snake", snake_outs)):
            dirs[tag] = Path(d) / tag
            dirs[tag].mkdir()
            for i, out in enumerate(outs):
                save_audio(out, str(dirs[tag] / f"request{i}.wav"), 48_000)
        args = ["--reference-dir", str(dirs["main"]), "--candidate-dir", str(dirs["snake"])]
        reports = {}
        for dev in ("cuda", "cpu"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                _, wall = sync_wall(torch, lambda: run_eval.main(args + ["--device", dev]))
            reports[dev] = json.loads(buf.getvalue().strip().splitlines()[-1])
            log(f"[eval] run_eval --device {dev}: wall {wall:.3f} s; {json.dumps(reports[dev])}")
        ref = run_eval._load_dir(str(dirs["main"]), 48_000, 30.0)
        cand = run_eval._load_dir(str(dirs["snake"]), 48_000, 30.0)
    vgg = {}
    for dev in ("cuda", "cpu"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            embed = VGGishEmbedder(seed=VGGISH_SEED, device=dev)
        vgg[dev], wall = sync_wall(torch, lambda: run_eval.evaluate(
            ref, cand, 48_000, torch.device(dev), embed, "vggish-random"))
        log(f"[eval] random VGGish (seed {VGGISH_SEED}) on {dev}: wall {wall:.3f} s; "
            f"FAD {vgg[dev]['fad']:.6e}")

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    diffs = {k: rel(reports["cuda"][k], reports["cpu"][k])
             for k in ("fad", "snr_db_mean", "spectral_convergence_mean")}
    diffs["vggish_fad"] = rel(vgg["cuda"]["fad"], vgg["cpu"]["fad"])
    bars = {"fad": 1e-3, "vggish_fad": 5e-3, "snr_db_mean": 1e-4,
            "spectral_convergence_mean": 1e-4}
    ok = set(reports["cuda"]) == set(reports["cpu"]) and all(
        diffs[k] <= bars[k] for k in bars)
    log("[eval] card vs CPU, relative differences (bars): " + ", ".join(
        f"{k} {diffs[k]:.3e} ({bars[k]})" for k in bars))
    if not ok:
        raise SystemExit("chip_smoke: eval: the card's report disagrees with the CPU's")


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
    phase_small_ckpt(torch)
    phase_small_tasks(torch)
    phase_small_long(torch)
    phase_small_reuse(torch)
    phase_small_serve(torch)
    phase_small_data(torch)
    phase_small_lora(torch)
    phase_small_composer(torch)
    phase_small_features(torch)
    k1_generation, jen1, main_outs, main_kernels = phase_main(torch)
    k1_generation += phase_tasks(torch, jen1)
    k1_generation += phase_long(torch, jen1)
    k1_generation += phase_bf16_weights(torch, jen1)
    k1_generation += phase_reuse(torch, jen1)
    k1_generation += phase_serve(torch, jen1)
    del jen1
    gc.collect()
    torch.cuda.empty_cache()
    k4 = phase_flagship(torch)
    gc.collect()
    torch.cuda.empty_cache()
    k1_train, k2, k3 = phase_train(torch)
    gc.collect()
    torch.cuda.empty_cache()
    for phase in (phase_lora, phase_wav_train):
        k1, k2_more, k3_more = phase(torch)
        k1_train, k2, k3 = k1_train + k1, k2 + k2_more, k3 + k3_more
    k1_generation += phase_composer(torch)
    gc.collect()
    torch.cuda.empty_cache()
    k1_snake, k1_snake_train, k2_snake, k3_snake, snake_outs = phase_snake(torch, main_kernels)
    k1_generation, k1_train = k1_generation + k1_snake, k1_train + k1_snake_train
    k2, k3 = k2 + k2_snake, k3 + k3_snake
    gc.collect()
    torch.cuda.empty_cache()
    k1_generation += phase_stft(torch)
    phase_eval(torch, main_outs, snake_outs)
    for row, launches in zip(rows, (k1_generation + k1_train, k2, k3, k4)):
        row["launches"] = launches
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
