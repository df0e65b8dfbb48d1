"""Open-loop Poisson arrivals into `GenerationService` at a fixed rate:
independent users, each sending one request and waiting for its clip.

Mix parameters: rate_per_s, clip_seconds (drawn in equal shares), steps,
caption_words, max_batch, max_wait_ms, check_requests, and for a traced
run trace_seconds and trace_from_s: after the window, arrivals at the same
rate for trace_seconds are traced, and the stretch from trace_from_s to
their last due time is read (the ramp and the drain left out; the
profiler starts and stops with the device idle).
The service runs with its defaults otherwise (GDM DDIM, device transport,
default seeds, so requests of one clip length co-batch). End to end:
serve_latency_p90_s over every request due in the window, each from its
due time to its audio on the host; a failed or refused request is missing.
Correctness: `check_requests` finished requests drawn from the seed, a
longest one among them, each against the plain reference on its batch's
seed and lane.
"""

from __future__ import annotations

import gc
import math
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from portbench.drivers import generate as gen
from portbench.harness import stats, traffic
from portbench.harness.core import Run
from portbench.harness.trace import Trace, window
from portbench.reference import model as ref

UNITS = {"serve_latency_p90_s": "s", "setup_s": "s"}
MISSING_S = 3600.0  # the latency written for a request that never got its clip
GRACE_S = 60.0  # how long past the window's close an answer is waited for


class SeedingJen1:
    """The program's Jen1 as the service sees it. A batch sent with the
    default seed (-1) runs on a seed of the benchmark's drawing, where
    `generate` would draw its own; each batch's prompts, seed, clip length
    and phase walls are recorded."""

    def __init__(self, jen1, r: np.random.Generator):
        self._jen1 = jen1
        self._r = r
        self.batches: List[Dict] = []

    def __getattr__(self, name):
        return getattr(self._jen1, name)

    def generate(self, prompts, seed: int = -1, **kw):
        if seed == -1:
            seed = int(self._r.integers(0, 2**31 - 1))
        out = self._jen1.generate(prompts, seed=seed, **kw)
        self.batches.append(dict(prompts=list(prompts), seed=seed, seconds=kw["seconds"],
                                 steps=kw["steps"], timings=dict(self._jen1.last_timings)))
        return out


def open_loop(service, schedule: List[Dict], steps: int, close_s: float,
              mark: Optional[Tuple[float, float]] = None):
    """Send each request at its due time (s after the start) from its own
    thread; wait for every answer until `close_s` + GRACE_S. With `mark`
    (from, to), mark that stretch of the load with the trace's window
    span. Returns (start, answered-at list with None for a failure, clips,
    send lag)."""
    done: List[Optional[float]] = [None] * len(schedule)
    clips: List[Optional[np.ndarray]] = [None] * len(schedule)
    lag = [0.0]
    start = time.perf_counter()

    def send(i: int) -> None:
        req = schedule[i]
        try:
            wait = start + close_s + GRACE_S - time.perf_counter()
            clips[i] = service.submit(req["prompt"], seconds=req["seconds"], steps=steps,
                                      timeout=max(wait, 1.0))
            done[i] = time.perf_counter() - start
        except Exception as e:  # refused, failed or late: missing
            print(f"request {i} failed: {e!r}", flush=True)

    def until(t: float) -> None:
        delay = start + t - time.perf_counter()
        if delay > 0:
            time.sleep(delay)

    marks = [] if mark is None else list(mark)
    span = window()
    with ThreadPoolExecutor(max_workers=max(8, len(schedule))) as pool:
        for i, req in enumerate(schedule + [None]):
            due = close_s if req is None else req["due"]
            while marks and marks[0] <= due:
                until(marks.pop(0))
                if marks:  # the first mark opens the span, the second closes it
                    span.__enter__()
                else:
                    span.__exit__(None, None, None)
            if req is None:
                break
            until(due)
            lag[0] = max(lag[0], time.perf_counter() - start - due)
            pool.submit(send, i)
    return start, done, clips, lag[0]


def reference_clip(models, cfg: Dict, batch: Dict, lane: int, device) -> np.ndarray:
    """(channels, samples) of the plain reference for one lane of a batch:
    the batch's noise drawn whole, the lane's row denoised and decoded."""
    import torch

    t5, unet, dec = models
    b = len(batch["prompts"])
    frames = gen.latent_frames(int(batch["seconds"] * 48_000))
    dim = cfg["model_config"]["in_channels"]
    gdm = cfg["diffusion_config"]["gaussian_diffusion"]
    with ref.fp32(), torch.no_grad():
        emb, mask = t5([batch["prompts"][lane]])
        concat = torch.zeros((1, frames, cfg["model_config"]["context_channels"][0]),
                             device=device)
        g = torch.Generator(device=device).manual_seed(batch["seed"])
        lat = ref.sample_ddim(unet, (b, frames, dim), (emb, mask, concat), g, batch["steps"],
                              gdm["steps"], gdm["ddim_sampling_eta"], slice(lane, lane + 1))
        audio = dec.decode_chunked(lat)
    return audio[0].transpose(0, 1).cpu().numpy()


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> Run:
    import torch

    from jen1_tpu_torch.serve import GenerationService

    cfg, mix = cell.config["config"], cell.traffic
    on_card = torch.device(device).type == "cuda"
    jen1 = SeedingJen1(gen.program(cfg, seed, device), traffic.rng(seed, 5))
    service = GenerationService(jen1, max_batch=mix["max_batch"],
                                max_wait_ms=mix["max_wait_ms"])
    try:
        warm = traffic.rng(seed, 6)
        for clip in mix["clip_seconds"]:  # one batch per key: every capture
            service.submit(traffic.caption(warm, tuple(mix["caption_words"])),
                           seconds=clip, steps=mix["steps"])
        captures = jen1.graphs.captures
        setup_s = time.perf_counter() - t0

        schedule = traffic.poisson_schedule(seed, mix, seconds)
        n0, stats0, phases0 = len(jen1.batches), dict(service.stats), dict(service.phase_totals)
        start, done, clips, lag = open_loop(service, schedule, mix["steps"], seconds)
        window = max(seconds, max((d for d in done if d is not None), default=0.0))
        if jen1.graphs.captures != captures:
            raise RuntimeError(f"{jen1.graphs.captures - captures} graph captures inside "
                               "the measured window: a shape was not warmed up")
        batches = jen1.batches[n0:]
        stats1, phases1 = dict(service.stats), dict(service.phase_totals)
        due = [r["due"] for r in schedule]
        p90 = stats.latency_percentile(due, done, 90)
        failed = sum(d is None for d in done)
        spans = dict(driver="serve", window_s=window, send_lag_s=lag, steps=mix["steps"],
                     max_batch=mix["max_batch"],
                     batches=[dict(seconds=b["seconds"], timings=b["timings"],
                                   flops=gen.unet_flops(cfg, len(b["prompts"]), b["seconds"],
                                                        b["steps"], "gaussian_diffusion"),
                                   lanes=sum(1 for p in b["prompts"] if p))
                              for b in batches],
                     stats=(stats0, stats1), phases=(phases0, phases1), cfg=cfg)
        print(f"serve: {len(schedule)} due, {failed} failed, {len(batches)} batches, "
              f"send lag {lag:.4f} s, p90 {p90:.4f} s", flush=True)
        tr = None
        if trace and on_card:
            extra = traffic.poisson_schedule(seed + 1, mix, mix["trace_seconds"])
            mark = (mix["trace_from_s"], extra[-1]["due"]) if extra else None
            tr = Trace.of(lambda: open_loop(service, extra, mix["steps"],
                                            mix["trace_seconds"], mark))
    finally:
        service.close()
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0

    by_prompt = {}
    for b in batches:
        for lane, p in enumerate(b["prompts"]):
            if p:
                by_prompt[p] = (b, lane)
    answered = [i for i, c in enumerate(clips) if c is not None and schedule[i]["prompt"]
                in by_prompt]
    r = traffic.rng(seed, 7)
    pick: List[int] = []
    if answered:
        longest = max(schedule[i]["seconds"] for i in answered)
        pick = [int(r.choice([i for i in answered if schedule[i]["seconds"] == longest]))]
        rest = [i for i in answered if i not in pick]
        k = min(len(rest), mix["check_requests"] - 1)
        pick += [int(i) for i in r.choice(rest, size=k, replace=False)] if k > 0 else []
    kept = [(clips[i], by_prompt[schedule[i]["prompt"]]) for i in pick]
    del jen1, service, clips
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    models = gen.reference_weights(cfg, seed, device)
    err = 0.0 if kept else math.inf
    for clip, (b, lane) in kept:
        err = max(err, gen.rel_err(clip[None], reference_clip(models, cfg, b, lane, device)[None]))
    lat_p90 = p90 if math.isfinite(p90) else MISSING_S
    return Run(setup_s=setup_s, attempted=len(schedule), failed=failed,
               end_to_end={"serve_latency_p90_s": lat_p90}, spans=spans,
               checks={"audio_rel_err": [err, cell.limits["audio_rel_err"]]},
               memory_peak_bytes=peak, trace=tr)
