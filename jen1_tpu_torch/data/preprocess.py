"""Offline preprocessing (port of jen1_tpu/data/preprocess.py).

    python -m jen1_tpu_torch.data.preprocess scan --dataset-dir d [--out o]
    python -m jen1_tpu_torch.data.preprocess encode --dataset-dir d [--out o] \
        [--sample-duration 10] [--batch-size 8] [--codec-weights w.pt] \
        [--segmented | --whole-clip] [--device cuda]

  scan:   probe the durations of <dataset_dir>/audios -> durations.npy,
          cumsum.npy and files.txt, which MusicDataset reads instead of
          probing again (`durations_path`, `cumsum_path`,
          `audio_file_txt_path`).
  encode: cut every file into sample_duration windows (the tail window
          zero-padded) and encode them in batches through the EnCodec codec
          on `device` ("cuda" unless asked otherwise) -> <out>/<name>_<wi:04d>
          .npy latents (frames, 128) and a copy of the file's sidecar
          metadata as <name>_<wi:04d>.json, the layout LatentDataset reads.
          The encoder is the chunked one by default (batched 1 s chunks,
          latent overlap-add), the reference's segmented pipeline with
          --segmented, the whole-clip encoder with --whole-clip.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from jen1_tpu_torch.data.audio_io import convert_audio, get_duration_sec, load_audio
from jen1_tpu_torch.data.dataset import audio_files

ENCODE_MODES = ("chunked", "segmented", "whole")


def scan(dataset_dir: str, out_dir: Optional[str] = None) -> None:
    """Write durations.npy, cumsum.npy and files.txt (jen1_tpu/data/
    preprocess.py:28-42)."""
    out_dir = out_dir or dataset_dir
    files = audio_files(os.path.join(dataset_dir, "audios"))
    durations = np.asarray([get_duration_sec(f) for f in files], np.float64)
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "durations.npy"), durations)
    np.save(os.path.join(out_dir, "cumsum.npy"), np.cumsum(durations))
    with open(os.path.join(out_dir, "files.txt"), "w") as f:
        f.write("\n".join(files) + "\n")
    print(f"scanned {len(files)} files, total {durations.sum():.1f}s")


def encoder_of(codec, mode: str):
    """The codec's encoder for `mode` (chunked, segmented or whole)."""
    if mode not in ENCODE_MODES:
        raise ValueError(f"encode mode must be one of {ENCODE_MODES}, got {mode!r}")
    return {"chunked": codec.encode_latent_chunked,
            "segmented": codec.encode_latent_segmented,
            "whole": codec.encode_latent}[mode]


def encode(
    dataset_dir: str,
    out_dir: str,
    sample_duration: float = 10.0,
    sr: int = 48_000,
    channels: int = 2,
    batch_size: int = 8,
    codec=None,
    mode: str = "chunked",
    codec_weights: Optional[str] = None,
    *,
    device="cuda",
) -> int:
    """Encode every window of every file to <out_dir>/<name>_<wi:04d>.npy in
    batches of `batch_size` through `codec` (or the EnCodec-48k codec with
    `codec_weights`, random with a warning without) on `device`
    (jen1_tpu/data/preprocess.py:45-119). Returns the windows written."""
    from jen1_tpu_torch.api.generation import resolve_device
    from jen1_tpu_torch.codec.model import make_codec

    dev = resolve_device(device)
    if codec is None:
        codec = make_codec(codec_weights, device=dev,
                           warn_context="offline latent preprocessing")
    encoder = encoder_of(codec, mode)
    meta_dir = os.path.join(dataset_dir, "metadata")
    os.makedirs(out_dir, exist_ok=True)
    files = audio_files(os.path.join(dataset_dir, "audios"))
    window = int(sample_duration * sr)
    pending, names = [], []
    written = 0

    def flush() -> None:
        nonlocal written
        if not pending:
            return
        latents = encoder(torch.from_numpy(np.stack(pending)).to(dev)).cpu().numpy()
        for name, latent in zip(names, latents):
            np.save(os.path.join(out_dir, f"{name}.npy"), latent)
        written += len(names)
        pending.clear()
        names.clear()

    for path in files:
        audio, file_sr = load_audio(path)
        audio = convert_audio(audio, file_sr, sr, channels)
        base = os.path.splitext(os.path.basename(path))[0]
        meta = {"prompt": ""}
        src_meta = os.path.join(meta_dir, f"{base}.json")
        if os.path.exists(src_meta):
            with open(src_meta) as f:
                meta = json.load(f)
        for wi in range(max(1, audio.shape[0] // window)):
            chunk = audio[wi * window:(wi + 1) * window]
            if chunk.shape[0] < window:
                chunk = np.pad(chunk, ((0, window - chunk.shape[0]), (0, 0)))
            name = f"{base}_{wi:04d}"
            pending.append(chunk)
            names.append(name)
            with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
                json.dump(meta, f)
            if len(pending) >= batch_size:
                flush()
    flush()
    print(f"encoded {written} windows from {len(files)} files -> {out_dir}")
    return written


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("command", choices=["scan", "encode"])
    p.add_argument("--dataset-dir", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--sample-duration", type=float, default=10.0)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--segmented", action="store_true",
                   help="the reference's latent pipeline (per-1 s segment normalisation)")
    p.add_argument("--whole-clip", action="store_true",
                   help="one whole-clip encoder pass instead of batched 1 s chunks")
    p.add_argument("--codec-weights", default=None,
                   help="EnCodec-48k torch state dict; without it the codec is random "
                        "and the latents are noise")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    if args.command == "scan":
        scan(args.dataset_dir, args.out)
        return
    if args.segmented and args.whole_clip:
        p.error("--segmented and --whole-clip exclude each other")
    mode = "segmented" if args.segmented else "whole" if args.whole_clip else "chunked"
    encode(args.dataset_dir, args.out or os.path.join(args.dataset_dir, "latents"),
           sample_duration=args.sample_duration, batch_size=args.batch_size, mode=mode,
           codec_weights=args.codec_weights, device=args.device)


if __name__ == "__main__":
    main()
