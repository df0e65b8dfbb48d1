"""Datasets, split and batching loader (port of jen1_tpu/data/dataset.py).
numpy and the port's audio I/O.

  MusicDataset    - audio files under <dataset_dir>/audios (WAV, FLAC, MP3,
                    OGG, AAC/M4A) cut into sample_duration windows of the
                    concatenated corpus, with the aug_shift jitter, and the
                    sidecar <dataset_dir>/metadata/<name>.json; yields raw
                    audio (the trainer or preprocess encodes it in batches).
  LatentDataset   - <dir>/<name>.npy latents (frames, C) + optional
                    <name>.json metadata ({"prompt": ""} when absent).
  train_test_split- index-level random split.
  make_dataloader - shuffling, batching iterator with drop_last, optional
                    epochs, skip_batches for a deterministic resume and a
                    background thread that prefetches batches.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from jen1_tpu_torch.data.audio_io import convert_audio, get_duration_sec, load_audio

AUDIO_EXTS = (".wav", ".mp3", ".flac", ".ogg", ".oga", ".aac", ".m4a", ".mp4")


def audio_files(audio_dir: str) -> List[str]:
    """The audio files directly under `audio_dir`, sorted by path."""
    return sorted(os.path.join(audio_dir, f) for f in os.listdir(audio_dir)
                  if f.lower().endswith(AUDIO_EXTS))


class MusicDataset:
    """Windows of an audio corpus (jen1_tpu/data/dataset.py:36-133).

    The corpus is the files of <dataset_dir>/audios (or the list in
    `audio_file_txt_path`) whose duration lies in [min_duration,
    max_duration), laid end to end; item i is the sample_duration window
    that starts at i * sample_duration, moved by a uniform jitter of up to
    half a window when `aug_shift` (drawn from np.random.default_rng(seed),
    as the JAX package draws it), and kept inside one file. `durations_path`
    and `cumsum_path` (from `preprocess scan`) skip the duration probe.
    Items are (audio (sample_duration * sr, channels) float32 at `sr`, the
    file's sidecar metadata or {"prompt": ""})."""

    def __init__(
        self,
        dataset_dir: str,
        sr: int = 48_000,
        channels: int = 2,
        min_duration: float = 0.0,
        max_duration: float = 300.0,
        sample_duration: float = 10.0,
        aug_shift: bool = True,
        durations_path: Optional[str] = None,
        cumsum_path: Optional[str] = None,
        audio_file_txt_path: Optional[str] = None,
        seed: int = 0,
    ):
        self.dataset_dir = dataset_dir
        self.sr = sr
        self.channels = channels
        self.min_duration = min_duration
        self.max_duration = max_duration
        self.sample_duration = sample_duration
        self.aug_shift = aug_shift
        self.audio_files_dir = os.path.join(dataset_dir, "audios")
        self.metadatas_dir = os.path.join(dataset_dir, "metadata")
        self._rng = np.random.default_rng(seed)
        if audio_file_txt_path is not None:
            with open(audio_file_txt_path) as f:
                files = [line.strip() for line in f if line.strip()]
        else:
            files = audio_files(self.audio_files_dir)
        if durations_path is not None and cumsum_path is not None:
            self.audio_files = files
            self.durations = list(np.asarray(np.load(durations_path), np.float64))
            self.cumsum = np.load(cumsum_path).astype(np.float64)
        else:
            durations = [get_duration_sec(f) for f in files]
            keep = [i for i, d in enumerate(durations)
                    if self.min_duration <= d < self.max_duration]
            self.audio_files = [files[i] for i in keep]
            self.durations = [durations[i] for i in keep]
            self.cumsum = np.cumsum(np.asarray(self.durations, np.float64))

    def __len__(self) -> int:
        # one window per sample_duration of corpus time
        return int(self.cumsum[-1] // self.sample_duration)

    def get_index_offset(self, item: int) -> Tuple[int, float]:
        """(file index, offset in seconds) of window `item`, with the
        +-half-window jitter (jen1_tpu/data/dataset.py:87-103)."""
        half = self.sample_duration / 2
        shift = float(self._rng.uniform(-half, half)) if self.aug_shift else 0.0
        offset = item * self.sample_duration + shift
        midpoint = min(max(offset + half, 0.0), float(self.cumsum[-1]) - 1e-6)
        index = int(np.searchsorted(self.cumsum, midpoint))
        start = float(self.cumsum[index - 1]) if index > 0 else 0.0
        end = float(self.cumsum[index])
        if offset > end - self.sample_duration:
            offset = max(start, offset - half)
        elif offset < start:
            offset = min(end - self.sample_duration, offset + half)
        offset = min(max(offset, start), max(end - self.sample_duration, start))
        return index, offset - start

    def get_song_chunk(self, index: int, offset_sec: float) -> Tuple[np.ndarray, int]:
        audio, sr = load_audio(self.audio_files[index])
        start = int(offset_sec * sr)
        return audio[start:start + int(self.sample_duration * sr)], sr

    def get_metadata(self, index: int) -> Dict[str, Any]:
        song = os.path.splitext(os.path.basename(self.audio_files[index]))[0]
        path = os.path.join(self.metadatas_dir, f"{song}.json")
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        return {"prompt": ""}

    def __getitem__(self, item: int) -> Tuple[np.ndarray, Dict[str, Any]]:
        index, offset = self.get_index_offset(item)
        chunk, sr = self.get_song_chunk(index, offset)  # the mapped file index
        chunk = convert_audio(chunk, sr, self.sr, self.channels)
        want = int(self.sample_duration * self.sr)
        if chunk.shape[0] < want:  # a tail window is padded
            chunk = np.pad(chunk, ((0, want - chunk.shape[0]), (0, 0)))
        return chunk[:want], self.get_metadata(index)


class LatentDataset:
    """Precomputed latents: <dir>/<name>.npy (frames, C) [+ <name>.json]."""

    def __init__(self, latents_dir: str, metadatas_dir: Optional[str] = None):
        self.latents_dir = latents_dir
        self.metadatas_dir = metadatas_dir or latents_dir
        self.names = sorted(
            os.path.splitext(f)[0] for f in os.listdir(latents_dir) if f.endswith(".npy")
        )
        if not self.names:
            raise ValueError(f"no .npy latents in {latents_dir}")

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, item: int) -> Tuple[np.ndarray, Dict[str, Any]]:
        name = self.names[item]
        latent = np.load(os.path.join(self.latents_dir, f"{name}.npy"))
        meta_path = os.path.join(self.metadatas_dir, f"{name}.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        else:
            meta = {"prompt": ""}
        return latent.astype(np.float32), meta


def train_test_split(dataset, split_ratio: float, seed: int = 0):
    """Index-level random split (the same permutation as the JAX package)."""
    n = len(dataset)
    idx = np.random.default_rng(seed).permutation(n)
    n_train = int(split_ratio * n)
    return _Subset(dataset, idx[:n_train]), _Subset(dataset, idx[n_train:])


class _Subset:
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = [int(i) for i in indices]

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


def make_dataloader(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    drop_last: bool = True,
    seed: int = 0,
    prefetch: int = 2,
    epochs: Optional[int] = 1,
    skip_batches: int = 0,
) -> Iterator[Tuple[np.ndarray, List[Dict[str, Any]]]]:
    """Yields (stacked array (B, ...), metadata list). skip_batches passes
    over the first N batches without loading their items; the shuffle order
    comes from `seed`, so a resumed run sees the same batches."""
    rng = np.random.default_rng(seed)

    def batches():
        epoch = 0
        n_skip = skip_batches
        while epochs is None or epoch < epochs:
            order = rng.permutation(len(dataset)) if shuffle else np.arange(len(dataset))
            for s in range(0, len(order), batch_size):
                idx = order[s : s + batch_size]
                if len(idx) < batch_size and drop_last:
                    continue
                if n_skip > 0:
                    n_skip -= 1
                    continue
                items = [dataset[int(i)] for i in idx]
                yield np.stack([a for a, _ in items]), [m for _, m in items]
            epoch += 1

    if prefetch <= 0:
        yield from batches()
        return

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    sentinel = object()
    stop = threading.Event()

    def worker():
        try:
            for b in batches():
                while not stop.is_set():
                    try:
                        q.put(b, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        finally:
            q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            b = q.get()
            if b is sentinel:
                break
            yield b
    finally:
        # a consumer that stops early must not leave the worker blocked
        stop.set()
        while t.is_alive():
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
        t.join()
