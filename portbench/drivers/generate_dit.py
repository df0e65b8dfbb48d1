"""Closed loop of `Jen1.generate` batches of Stable Audio Open (the DiT
and the Oobleck decoder), one caller: the next batch is sent when the last
one's audio is on the host.

Mix parameters: batch, samples (per clip), steps, caption_words,
seconds_start, seconds_total, check_clips. The clip is `samples` at the
configuration's sample rate, each counted as samples / rate audio seconds.
End to end: gen_audio_s_per_s, every clip's audio seconds over the window
(from the first send to the last batch's audio on the host; every batch
sent before the deadline is counted and waited for). Spans: each batch's
`last_timings`, the DiT's FLOPs, and the window's deltas of the program's
counters (models/dit.py, K1's tensor-core launches). Correctness:
`check_clips` clips of the window, drawn from the seed (the i-th from the
i-th slice of its batch's rows, so every part of a batch is looked at),
each against the plain reference (portbench/reference/stable_audio_open.py)
from the same caption, initial noise and weights, one clip (two guidance
branches) at a time.

A program without the DiT cannot run this mix: `run` raises before any
set-up.
"""

from __future__ import annotations

import gc
import importlib.util
import math
import time
from typing import Dict, List, Optional

import numpy as np

from portbench import flops_dit
from portbench.drivers.generate import _Reservoir
from portbench.harness import traffic, weights
from portbench.harness.core import Run
from portbench.harness.trace import Trace
from portbench.reference import stable_audio_open as ref

UNITS = {"gen_audio_s_per_s": "audio-s/s", "setup_s": "s"}
COUNTERS = ("FORWARDS", "SELF_ATTN_FLASH", "SELF_ATTN_PLAIN")
TEXT_TOKENS_EXTRA = 2  # seconds_start and seconds_total join the text's tokens


def has_dit() -> bool:
    """Whether the program has the DiT (models/dit.py)."""
    return importlib.util.find_spec("jen1_tpu_torch.models.dit") is not None


def frames(cfg: Dict, mix: Dict) -> int:
    return mix["samples"] // _hop(cfg)


def _hop(cfg: Dict) -> int:
    return math.prod(cfg["oobleck_config"]["strides"])


def tokens(cfg: Dict) -> int:
    return cfg["conditioner_config"]["t5_config"]["max_length"] + TEXT_TOKENS_EXTRA


def rows(cfg: Dict, mix: Dict) -> int:
    """The CFG-doubled rows of a batch."""
    scale = cfg["diffusion_config"]["variational_diffusion"]["embedding_scale"]
    return mix["batch"] * (2 if scale != 1.0 else 1)


def run_weights(cfg: Dict, seed: int, device) -> Dict[str, Dict]:
    """The run's weights by module ("t5", "seconds_start", "seconds_total",
    "dit", "decoder"), made on `device` from the seed, shaped by the
    reference's modules."""
    return weights.seeded(ref.build(cfg, "meta"), weights.weight_seed(seed), device)


def reference_models(cfg: Dict, seed: int, device) -> Dict:
    sd = run_weights(cfg, seed, device)
    models = ref.build(cfg, device)
    for key, mod in models.items():
        mod.load_state_dict(sd[key], strict=True)
        mod.eval()
    return models


def program(cfg: Dict, seed: int, device):
    """The program's Jen1 at the configuration, holding the run's weights."""
    from jen1_tpu_torch.api.generation import Jen1
    from jen1_tpu_torch.config import Config

    config = Config.from_dict(cfg)
    config.seed = weights.weight_seed(seed) % (2**31)
    jen1 = Jen1(config=config, device=device)
    load_program_weights(jen1, cfg, seed, device)
    return jen1


def load_program_weights(jen1, cfg: Dict, seed: int, device) -> None:
    """Copy the run's weights into the program's conditioners, DiT and
    decoder, in place (a captured graph reads them at its next replay)."""
    sd = run_weights(cfg, seed, device)
    conds = jen1.conditioner.conditioners
    conds[cfg["conditioner_config"]["t5_config"]["id"]].load_state_dict(sd["t5"], strict=True)
    for key in ("seconds_start", "seconds_total"):
        conds[key].load_state_dict(sd[key], strict=True)
    jen1.model.load_state_dict(sd["dit"], strict=True)
    jen1.codec.decoder.load_state_dict(sd["decoder"], strict=True)


def reference_clip(models: Dict, cfg: Dict, caption: str, seed: int, row: int, mix: Dict,
                   device) -> np.ndarray:
    """(channels, samples) of the plain reference for row `row` of the
    batch whose request seed is `seed`: the batch's x_T drawn as the
    program draws it, that row taken."""
    import torch

    shape = (mix["batch"], frames(cfg, mix), cfg["dit_config"]["io_channels"])
    with ref.fp32(), torch.no_grad():
        gen = torch.Generator(device=device).manual_seed(seed)
        noise = torch.randn(shape, generator=gen, device=device)[row:row + 1]
        audio = ref.generate(models, cfg, [caption], noise.transpose(1, 2), mix["steps"],
                             mix["seconds_start"], mix["seconds_total"])
    return audio[0].cpu().numpy()


def rel_err(a: np.ndarray, r: np.ndarray) -> float:
    """Relative L2 distance of a clip to the reference's."""
    if a.shape != r.shape:
        return math.inf
    a64, r64 = a.astype(np.float64), r.astype(np.float64)
    err = float(np.linalg.norm(a64 - r64) / max(np.linalg.norm(r64), 1e-30))
    return err if math.isfinite(err) else math.inf


def counters() -> Dict[str, int]:
    """The program's DiT counters and K1's tensor-core launches."""
    from jen1_tpu_torch.models import dit
    from jen1_tpu_torch.ops import flash_attention

    out = {name: getattr(dit, name) for name in COUNTERS}
    out["K1_MMA"] = flash_attention.LAUNCHES_MMA
    return out


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> Run:
    if not has_dit():
        raise RuntimeError("this program has no DiT (jen1_tpu_torch.models.dit): "
                           f"cell {cell.name} cannot run")
    import torch

    cfg, mix = cell.config["config"], cell.traffic
    on_card = torch.device(device).type == "cuda"
    rate = cfg["oobleck_config"]["sample_rate"]
    gen_kw = dict(batch_size=mix["batch"], seconds=mix["samples"] / rate, steps=mix["steps"],
                  seconds_start=mix["seconds_start"], seconds_total=mix["seconds_total"])
    jen1 = program(cfg, seed, device)
    caps, s = traffic.closed_batch(seed, mix, -1)
    jen1.generate(caps, seed=s, **gen_kw)  # warm-up: the cell's one shape
    captures = jen1.graphs.captures
    setup_s = time.perf_counter() - t0

    pick = traffic.rng(seed, 3)
    keep = _Reservoir(mix["check_clips"], pick)  # check_clips batches of the window's
    timings: List[Dict[str, float]] = []
    failed = sent = 0
    c0 = counters()
    start = time.perf_counter()
    deadline = start + seconds
    while time.perf_counter() < deadline:
        caps, s = traffic.closed_batch(seed, mix, sent)
        sent += 1
        try:
            audio = jen1.generate(caps, seed=s, **gen_kw)
        except Exception as e:  # a failed batch counts against the rate
            print(f"batch {sent - 1} failed: {e!r}", flush=True)
            failed += mix["batch"]
            continue
        timings.append(dict(jen1.last_timings))
        keep.offer((caps, s, audio))
    window = time.perf_counter() - start
    c1 = counters()
    if jen1.graphs.captures != captures:
        raise RuntimeError(f"{jen1.graphs.captures - captures} graph captures inside the "
                           "measured window: a shape was not warmed up")
    done = sent * mix["batch"] - failed
    dc, n, r, m = cfg["dit_config"], frames(cfg, mix), rows(cfg, mix), tokens(cfg)
    spans = dict(driver="generate_dit", window_s=window, batches=timings, steps=mix["steps"],
                 dit_flops_per_batch=mix["steps"] * flops_dit.dit_forward_flops(dc, r, n, m),
                 dit_gemm_flops_per_step=flops_dit.dit_gemm_flops(dc, r, n, m),
                 k1_shape=flops_dit.k1_shape(dc, r, n),
                 counters={k: c1[k] - c0[k] for k in c0})
    tr: Optional[Trace] = None
    if trace and on_card:
        caps, s = traffic.closed_batch(seed, mix, sent)
        tr = Trace.of(lambda: jen1.generate(caps, seed=s, **gen_kw))
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0

    del jen1
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    models = reference_models(cfg, seed, device)
    kept = keep.items
    err = 0.0 if kept else math.inf  # no answer to judge is no correct run
    per = mix["batch"] / mix["check_clips"]
    for i in range(mix["check_clips"] if kept else 0):
        caps, s, audio = kept[i % len(kept)]
        row = int(i * per + pick.integers(0, max(1, int(per))))
        want = reference_clip(models, cfg, caps[row], s, row, mix, device)
        err = max(err, rel_err(audio[row], want))
    limit = cell.limits["audio_rel_err"]
    return Run(setup_s=setup_s, attempted=sent * mix["batch"], failed=failed,
               end_to_end={"gen_audio_s_per_s": done * mix["samples"] / rate / window},
               spans=spans, checks={"audio_rel_err": [err, limit]}, memory_peak_bytes=peak,
               trace=tr)
