"""Latent normalizer (port of jen1_tpu/models/normalizer.py:17-67):
per-channel z = (x - mean) / (std + eps), fitted by one streaming pass over
(B, L, C) batches. `save` writes the JAX package's .npz layout (`mean`,
`std`), so a file either package writes loads in the other.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch


class Normalizer:
    def __init__(self, mean: Optional[np.ndarray] = None, std: Optional[np.ndarray] = None,
                 eps: float = 1e-6):
        self.mean = None if mean is None else torch.as_tensor(np.asarray(mean, np.float32))
        self.std = None if std is None else torch.as_tensor(np.asarray(std, np.float32))
        self.eps = eps

    @classmethod
    def fit(cls, batches: Iterable, eps: float = 1e-6) -> "Normalizer":
        """Moments in float64 over every (B, L, C) batch (numpy arrays or
        tensors)."""
        count, total, total_sq = 0, None, None
        for b in batches:
            if isinstance(b, torch.Tensor):
                b = b.detach().cpu().numpy()
            flat = np.asarray(b, np.float64).reshape(-1, np.shape(b)[-1])
            total = flat.sum(0) if total is None else total + flat.sum(0)
            total_sq = (flat**2).sum(0) if total_sq is None else total_sq + (flat**2).sum(0)
            count += flat.shape[0]
        if count == 0:
            raise ValueError("Normalizer.fit needs data")
        mean = total / count
        var = np.maximum(total_sq / count - mean**2, 0.0)
        return cls(mean=mean.astype(np.float32), std=np.sqrt(var).astype(np.float32), eps=eps)

    def _check(self) -> None:
        if self.mean is None:
            raise ValueError("Normalizer not fitted")

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self._check()
        return (x - self.mean.to(x)) / (self.std.to(x) + self.eps)

    def inverse(self, z: torch.Tensor) -> torch.Tensor:
        self._check()
        return z * (self.std.to(z) + self.eps) + self.mean.to(z)

    def save(self, path: str) -> None:
        self._check()
        np.savez(path, mean=self.mean.numpy(), std=self.std.numpy())

    @classmethod
    def load(cls, path: str) -> "Normalizer":
        data = np.load(path)
        return cls(mean=data["mean"], std=data["std"])
