"""Precomputed-latent dataset, split and batching loader (port of
jen1_tpu/data/dataset.py:136-240). numpy only; `MusicDataset` and audio I/O
wait for ROADMAP Queue 1, 'Rest of training'.

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
