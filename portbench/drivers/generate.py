"""Closed loop of `Jen1.generate` batches, one caller, as
`api/batch_generate.py` makes them: the next batch is sent when the last
one's audio is on the host.

Mix parameters: batch, seconds, steps, caption_words, check_batches.
End to end: gen_audio_s_per_s, every clip's audio seconds over the window
(from the first send to the last batch's audio on the host; every batch
sent before the deadline is counted and waited for). Correctness:
`check_batches` batches of the window, drawn from the seed, against the
plain reference from the same captions, seed and weights.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np

from portbench import flops
from portbench.harness import traffic, weights
from portbench.harness.core import Run
from portbench.harness.trace import Trace
from portbench.reference import model as ref

UNITS = {"gen_audio_s_per_s": "audio-s/s", "setup_s": "s"}


def latent_frames(samples: int, hop: int = 320, chunk: int = 150) -> int:
    """Latent frames of a clip as the chunked encoder's grid gives them."""
    frames = samples // hop
    return frames if frames > chunk else math.ceil(samples / hop)


def unet_flops(cfg: Dict, batch: int, seconds: float, steps: int, diffusion: str) -> int:
    """UNet FLOPs of one sampling request of `batch` clips: every step's
    forward over the CFG-doubled rows, the text and time tokens attended
    to; `diffusion` names the config's sampler ("variational_diffusion",
    "gaussian_diffusion")."""
    scale = cfg["diffusion_config"][diffusion]["embedding_scale"]
    rows = batch * (2 if scale != 1.0 else 1)
    tokens = cfg["conditioner_config"]["t5_config"]["max_length"] + 1
    frames = latent_frames(int(seconds * 48_000))
    return steps * flops.unet_forward_flops(cfg["model_config"], rows, frames, tokens)


def run_weights(cfg: Dict, seed: int, device) -> Dict[str, Dict]:
    """The run's weights by module ("t5", "unet", "decoder"), made on
    `device` from the seed, shaped by the reference's modules."""
    t5, unet, dec = ref.build(cfg, "meta")
    return weights.seeded({"t5": t5, "unet": unet, "decoder": dec}, weights.weight_seed(seed),
                          device)


def reference_weights(cfg: Dict, seed: int, device):
    """(t5, unet, decoder) of the reference with the run's weights."""
    sd = run_weights(cfg, seed, device)
    t5, unet, dec = ref.build(cfg, device)
    for mod, key in ((t5, "t5"), (unet, "unet"), (dec, "decoder")):
        mod.load_state_dict(sd[key], strict=True)
        mod.eval()
    return t5, unet, dec


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
    """Copy the run's weights into the program's T5, UNet and decoder, in
    place (a captured graph reads them at its next replay)."""
    sd = run_weights(cfg, seed, device)
    t5_id = cfg["conditioner_config"]["t5_config"]["id"]
    jen1.conditioner.conditioners[t5_id].load_state_dict(sd["t5"], strict=True)
    jen1.model.load_state_dict(sd["unet"], strict=True)
    jen1.codec.decoder.load_state_dict(sd["decoder"], strict=True)


def reference_audio(models, cfg: Dict, captions: List[str], seed: int, mix: Dict,
                    device) -> np.ndarray:
    """(B, channels, samples) of the plain reference for one batch."""
    import torch

    t5, unet, dec = models
    b = len(captions)
    frames = latent_frames(int(mix["seconds"] * 48_000))
    dim = cfg["model_config"]["in_channels"]
    with ref.fp32(), torch.no_grad():
        emb, mask = t5(captions)
        concat = torch.zeros((b, frames, cfg["model_config"]["context_channels"][0]),
                             device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        noise = torch.randn((b, frames, dim), generator=gen, device=device)
        lat = ref.sample_vdm(unet, (b, frames, dim), (emb, mask, concat), noise, mix["steps"])
        audio = dec.decode_chunked(lat)
    return audio.transpose(1, 2).cpu().numpy()


def rel_err(a: np.ndarray, r: np.ndarray) -> float:
    """The largest relative L2 distance of a clip to the reference's."""
    if a.shape != r.shape:
        return math.inf
    a64, r64 = a.astype(np.float64), r.astype(np.float64)
    errs = [np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-30) for x, y in zip(a64, r64)]
    return float(max(errs)) if all(np.isfinite(errs)) else math.inf


class _Reservoir:
    """k items drawn uniformly from a stream, by the seed."""

    def __init__(self, k: int, r: np.random.Generator):
        self.k, self.r, self.items, self.seen = k, r, [], 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.r.integers(0, self.seen))
        if j < self.k:
            self.items[j] = item


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> Run:
    import torch

    cfg, mix = cell.config["config"], cell.traffic
    on_card = torch.device(device).type == "cuda"
    gen_kw = dict(batch_size=mix["batch"], seconds=mix["seconds"], steps=mix["steps"])
    jen1 = program(cfg, seed, device)
    caps, s = traffic.closed_batch(seed, mix, -1)
    jen1.generate(caps, seed=s, **gen_kw)  # warm-up: the cell's one shape
    captures = jen1.graphs.captures
    setup_s = time.perf_counter() - t0

    keep = _Reservoir(mix["check_batches"], traffic.rng(seed, 3))
    timings: List[Dict[str, float]] = []
    failed = sent = 0
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
    if jen1.graphs.captures != captures:
        raise RuntimeError(f"{jen1.graphs.captures - captures} graph captures inside the "
                           "measured window: a shape was not warmed up")
    done = sent * mix["batch"] - failed
    spans = dict(driver="generate", window_s=window, batches=timings, steps=mix["steps"],
                 unet_flops_per_batch=unet_flops(cfg, mix["batch"], mix["seconds"],
                                                 mix["steps"], "variational_diffusion"))
    tr: Optional[Trace] = None
    if trace and on_card:
        caps, s = traffic.closed_batch(seed, mix, sent)
        tr = Trace.of(lambda: jen1.generate(caps, seed=s, **gen_kw))
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0

    del jen1
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    models = reference_weights(cfg, seed, device)
    err = 0.0 if keep.items else math.inf  # no answer to judge is no correct run
    for caps, s, audio in keep.items:
        err = max(err, rel_err(audio, reference_audio(models, cfg, caps, s, mix, device)))
    limit = cell.limits["audio_rel_err"]
    return Run(setup_s=setup_s, attempted=sent * mix["batch"], failed=failed,
               end_to_end={"gen_audio_s_per_s": done * mix["seconds"] / window},
               spans=spans, checks={"audio_rel_err": [err, limit]}, memory_peak_bytes=peak,
               trace=tr)
