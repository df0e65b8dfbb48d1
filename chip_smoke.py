#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (`jen1_tpu_torch`) on one card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
  1. device  - require CUDA; print the card's name, count and power limit.
  2. build   - build the kernel library from jen1_tpu_torch/csrc (nvcc) and
               print its `-Xptxas -v` register and shared-memory use.
  3. kernels - every kernel against its plain PyTorch version at the main
               path's shapes and more, with the stated bars; time kernel,
               plain version and the library yardstick at the slice shape.
  4. small   - the whole slice (T5, VDM + UNetCFG1d with its flash path,
               chunked decode) at tiny widths, on the card against the CPU
               with the same weights and the same initial noise.
  5. main    - Jen1(longform_config()).generate(): one warm-up request, then
               two timed requests (100 steps, 30 s, B=1); checks shapes,
               finiteness and the kernel launch counts; then one more
               request under torch.profiler for the device's busy share.
The line before the last is the `{"kernels": [...]}` record; the last line
is `{"ok": true, "device": {...}}`. Imports nothing of JAX or `jen1_tpu`.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 without
# tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# Bars of flash_attention_fwd against its plain version. O in fp32: the
# absolute bar of tests/test_flash_attention.py. O in bf16: both sides round
# an fp32 result to bf16, so they may differ by one bf16 step (2^-7 of the
# value); the bar is elementwise |dO| <= O_ATOL + O_RTOL * |O_ref|, which a
# dropped or doubled key tile (an O shift of ~20% of |O| at N=1125) fails.
# lse is fp32 whatever the input dtype, so it gets an fp32-level bar.
O_ABS_BAR_FP32 = 2e-3
O_ATOL, O_RTOL = 1e-4, 1e-2
LSE_BAR = 1e-4

SLICE_STEPS = 100
# the profiled request is shorter: the profiler's post-processing of a
# 100-step request (~385k kernel events) takes minutes
PROFILE_STEPS = 10
SLICE_SECONDS = 30
SLICE_PROMPTS = [("a calm piano melody over soft strings", 11),
                 ("driving techno with a heavy kick", 12)]


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
    log(smi)
    return {"kind": name, "count": count, "smi": smi}


def phase_build() -> None:
    from jen1_tpu_torch.ops import kernels

    info = kernels.build()
    kernels.library()
    log(f"[build] {info.path} in {info.seconds:.1f} s")
    for line in info.log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            log(f"[build] {line.strip()}")


def phase_kernels(torch) -> dict:
    import torch.nn.functional as F

    from jen1_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}

    def qkv(bh, n, d, dtype):
        return [torch.randn((1, bh, n, d), generator=gen, device="cuda").to(dtype)
                for _ in range(3)]

    # N = 1125, D = 16 is the slice shape; the others are the head dims the
    # repo's configs produce and lengths that are, and are not, tile multiples
    cases = [(16, n, d, dt, c) for n in (128, 563, 1125, 4500) for d in (16, 32, 64, 128)
             for dt in ("bfloat16", "float32") for c in (False, True)]
    max_err = 0.0
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
            max_err = max(err_o, err_lse)

    # timing at the slice shape: B*H = 16 (CFG-doubled batch 2 x 8 heads),
    # N = 1125, D = 16, bf16, non-causal
    bh, n, d = 16, 1125, 16
    q, k, v = qkv(bh, n, d, torch.bfloat16)
    ms = time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, False), 200)
    plain_ms = time_ms(torch, lambda: fa.flash_attention_reference(q, k, v, False), 50)
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v), 200)
    flops = 4 * bh * n * n * d
    nbytes = 4 * bh * n * d * q.element_size() + bh * n * 4
    t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    log(f"[kernels] slice shape timing: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
        f"sdpa {library_ms:.5f} ms, bound {bound_ms:.6f} ms "
        f"({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB)")
    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "jen1_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "jen1_tpu/ops/flash_attention.py:45",
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }


def phase_small(torch) -> None:
    """The whole slice at tiny widths, on the card against the CPU: the
    same T5, UNet and codec weights and the same x_T, fp32, 13 s at 1600 Hz
    (520 latent frames, so the level-1 transformer attends over 260 frames
    through the flash path and the decode takes 4 chunks). Bar: rtol 2e-2 /
    atol 2e-3, the sampler-trajectory bar of the CPU parity tests."""
    import dataclasses

    import numpy as np

    from jen1_tpu_torch.api.generation import Jen1
    from jen1_tpu_torch.codec.model import EncodecConfig, EncodecModel
    from jen1_tpu_torch.conditioning.conditioners import MultiConditioner, T5Conditioner
    from jen1_tpu_torch.config import tiny_test_config
    from jen1_tpu_torch.diffusion import vdm
    from jen1_tpu_torch.ops import flash_attention as fa

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
    fa.LAUNCHES = 0
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
    total = fa.LAUNCHES
    log(f"[main] peak device memory {torch.cuda.max_memory_allocated()} bytes")
    for out in outs:
        if out.shape != (1, 2, samples) or not np.isfinite(out).all():
            raise SystemExit(f"chip_smoke: bad output shape {out.shape} or non-finite values")
    if np.array_equal(outs[0], outs[1]):
        raise SystemExit("chip_smoke: two prompts and seeds gave identical audio")
    if launches != [expected] * len(SLICE_PROMPTS):
        raise SystemExit(f"chip_smoke: flash launches per request {launches}, want {expected}")
    phase_profile(torch, jen1)
    return total


def phase_profile(torch, jen1) -> None:
    """One more request under torch.profiler: the device's busy share of the
    request wall (sum of kernel times over the wall) and the kernels that
    take the most device time. Runs after the counted requests."""
    from torch.profiler import ProfilerActivity, profile

    prompt, seed = SLICE_PROMPTS[0]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        jen1.generate(prompt, seed=seed, steps=PROFILE_STEPS, seconds=SLICE_SECONDS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in kernels) * 1e-6
    log(f"[profile] {PROFILE_STEPS}-step request wall {wall:.4f} s (profiler on); device kernels "
        f"{len(kernels)}, busy {busy_s:.4f} s = {busy_s / wall:.4f} of the wall")
    by_name: dict = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() * 1e-6)
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f"[profile]   {t:.4f} s in {n} launches: {name[:110]}")


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
    row = phase_kernels(torch)
    phase_small(torch)
    row["launches"] = phase_main(torch)
    print(json.dumps({"kernels": [row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
