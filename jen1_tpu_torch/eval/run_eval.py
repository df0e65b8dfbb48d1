"""Evaluation CLI: FAD, SNR and spectral convergence between two audio sets
(port of jen1_tpu/eval/run_eval.py).

  python -m jen1_tpu_torch.eval.run_eval --reference-dir ref_wavs/ \
      --candidate-dir gen_wavs/ [--vggish-weights vggish.pt] [--sr 48000] \
      [--max-seconds 30] [--device cuda]

Prints one JSON line with the JAX CLI's keys. FAD uses the VGGish embedder
when --vggish-weights is given (the canonical metric), else the
deterministic log-mel map (relative comparisons only); SNR and spectral
convergence are reported when the two sets have the same shape. The work
runs on --device, the card by default.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

AGAINST_REFERENCE = ("FAD against the PyTorch reference (eval/fad_reference.py) needs the "
                     "reference checkout, which is not in this repository (ROADMAP Queue 1, "
                     "'Remaining model, conditioning and eval features': fad_reference)")


def _load_dir(path: str, sr: int, max_seconds: float) -> np.ndarray:
    """The WAV, MP3 and FLAC files of `path`, sorted by name, at `sr` with
    their own channel count, cut to `max_seconds` and then to the shortest:
    (N, T, ch)."""
    from jen1_tpu_torch.data.audio_io import convert_audio, load_audio

    files = sorted(os.path.join(path, f) for f in os.listdir(path)
                   if f.lower().endswith((".wav", ".mp3", ".flac")))
    if not files:
        raise ValueError(f"no audio files in {path}")
    t_max = int(max_seconds * sr)
    clips = []
    for f in files:
        audio, file_sr = load_audio(f)
        dst_ch = audio.shape[-1] if audio.ndim > 1 else 1
        clips.append(convert_audio(audio, file_sr, sr, dst_ch)[:t_max])
    t_min = min(c.shape[0] for c in clips)
    return np.stack([c[:t_min] for c in clips])


def evaluate(ref: np.ndarray, cand: np.ndarray, sr: int, device, embed_fn=None,
             embedder: str = "log-mel-standin") -> dict:
    """The CLI's report for two loaded sets."""
    import torch

    from jen1_tpu_torch.eval.metrics import (
        frechet_audio_distance,
        signal_to_noise_ratio,
        spectral_convergence,
    )

    r = torch.from_numpy(ref).to(device)
    c = torch.from_numpy(cand).to(device)
    out = {
        "fad": frechet_audio_distance(r, c, sample_rate=sr, embed_fn=embed_fn),
        "fad_embedder": embedder,
        "n_reference": int(ref.shape[0]),
        "n_candidate": int(cand.shape[0]),
    }
    # paired metrics only make sense for matching sets
    if ref.shape == cand.shape:
        out["snr_db_mean"] = float(signal_to_noise_ratio(r, c).mean())
        out["spectral_convergence_mean"] = float(spectral_convergence(r, c).mean())
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--reference-dir", default=None)
    p.add_argument("--candidate-dir", default=None)
    p.add_argument("--sr", type=int, default=48_000)
    p.add_argument("--max-seconds", type=float, default=30.0)
    p.add_argument("--vggish-weights", default=None,
                   help="local torchvggish checkpoint for canonical FAD")
    p.add_argument("--against-reference", action="store_true",
                   help="FAD against the PyTorch reference: not ported (needs its checkout)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    if args.against_reference:
        raise NotImplementedError(AGAINST_REFERENCE)
    if not (args.reference_dir and args.candidate_dir):
        p.error("--reference-dir/--candidate-dir are required")

    from jen1_tpu_torch.api.generation import resolve_device

    device = resolve_device(args.device)
    ref = _load_dir(args.reference_dir, args.sr, args.max_seconds)
    cand = _load_dir(args.candidate_dir, args.sr, args.max_seconds)
    embed_fn, embedder = None, "log-mel-standin"
    if args.vggish_weights:
        from jen1_tpu_torch.eval.vggish import VGGishEmbedder

        embed_fn = VGGishEmbedder(args.vggish_weights, sample_rate=args.sr, device=device)
        embedder = "vggish"
    print(json.dumps(evaluate(ref, cand, args.sr, device, embed_fn, embedder)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
