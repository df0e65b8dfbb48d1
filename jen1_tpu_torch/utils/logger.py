"""Logging and metrics (port of jen1_tpu/utils/logger.py).

A stdlib file logger, and a MetricLogger that always writes
<log_dir>/metrics.jsonl and also TensorBoard scalars when
`torch.utils.tensorboard` imports; audio, histograms, images and per-index
vectors go to TensorBoard only (nothing without it).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict

import numpy as np


def get_logger(log_dir: str, filename: str = "train.log") -> logging.Logger:
    logger = logging.getLogger("jen1_tpu_torch")
    logger.setLevel(logging.INFO)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.abspath(os.path.join(log_dir, filename))
        if not any(
            isinstance(h, logging.FileHandler) and h.baseFilename == path
            for h in logger.handlers
        ):
            h = logging.FileHandler(path)
            h.setFormatter(
                logging.Formatter("%(asctime)s\t%(name)s\t%(levelname)s\t%(message)s")
            )
            logger.addHandler(h)
    return logger


class MetricLogger:
    """Scalars -> metrics.jsonl (+ TensorBoard when available)."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self._jsonl = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            if use_tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:
                    SummaryWriter = None
                if SummaryWriter is not None:
                    self._tb = SummaryWriter(log_dir=log_dir)

    def log(self, step: int, scalars: Dict[str, Any]) -> None:
        if self._jsonl is not None:
            rec = {"step": int(step), "time": time.time()}
            rec.update({k: float(v) for k, v in scalars.items()})
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def log_audio(self, step: int, tag: str, audio, sample_rate: int) -> None:
        if self._tb is not None:
            self._tb.add_audio(tag, audio, int(step), sample_rate=sample_rate)

    def log_histograms(self, step: int, tensors: Dict[str, Any]) -> None:
        """Parameter or gradient histograms; tensors or numpy arrays."""
        if self._tb is not None:
            for tag, t in tensors.items():
                self._tb.add_histogram(tag, _numpy(t), int(step))

    def log_images(self, step: int, images: Dict[str, Any]) -> None:
        """(C, H, W) images, e.g. latent spectrograms."""
        if self._tb is not None:
            for tag, img in images.items():
                self._tb.add_image(tag, _numpy(img), int(step))

    def log_vectors(self, vectors: Dict[str, Any]) -> None:
        """Per-index scalar curves: element i is logged at step i (e.g. a
        per-timestep loss profile)."""
        if self._tb is not None:
            for tag, vec in vectors.items():
                for i, v in enumerate(vec):
                    self._tb.add_scalar(tag, float(v), i)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)
