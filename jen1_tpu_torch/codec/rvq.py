"""Residual vector quantization, EnCodec's RVQ (port of jen1_tpu/codec/rvq.py).

`n_q` codebooks of `bins` entries of `dim` values (16 x 1024 x 128 for the
48 kHz model). Each stage takes the nearest entry to the residual of the
stages before it; `decode` sums the chosen entries. The nearest-entry search
is one (B*T, bins) product per stage, argmin(||e||^2 - 2 r.e^T), the JAX
package's formula (not `torch.cdist`, which orders near-ties differently),
in fp32 with TF32 off. The JAX package computes it as an `einsum` outside
any Pallas kernel; here it is a `torch.matmul`. Codes are int32, as there.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from jen1_tpu_torch.ops.conv import fp32_precision


class ResidualVectorQuantizer:
    """Inference-mode RVQ over channels-last latents (B, T, D)."""

    def __init__(self, codebooks: torch.Tensor, frame_rate: float = 150.0,
                 bits_per_codebook: Optional[int] = None):
        self.codebooks = codebooks.float()  # (n_q, bins, dim)
        self.n_q, self.bins, self.dim = self.codebooks.shape
        self.frame_rate = frame_rate
        self.bits_per_codebook = bits_per_codebook or int(math.log2(self.bins))

    def num_quantizers_for_bandwidth(self, bandwidth: Optional[float]) -> int:
        """kbps -> number of codebooks (EnCodec semantics; None -> all)."""
        if bandwidth is None or bandwidth <= 0:
            return self.n_q
        bw_per_q = self.frame_rate * self.bits_per_codebook / 1000.0
        return max(1, int(bandwidth // bw_per_q))

    def distances(self, residual: torch.Tensor, stage: int) -> torch.Tensor:
        """||e||^2 - 2 r.e^T over the entries of codebook `stage`: (B, T, bins),
        fp32. The argmin over the last axis is the stage's code."""
        cb = self.codebooks[stage]
        with fp32_precision():
            dots = torch.matmul(residual, cb.t())
        return cb.square().sum(-1) - 2.0 * dots

    def encode(self, x: torch.Tensor, n_q: Optional[int] = None) -> torch.Tensor:
        """latent (B, T, D) -> codes (B, n_q, T) int32."""
        residual = x.float()
        codes = []
        for i in range(n_q or self.n_q):
            idx = self.distances(residual, i).argmin(-1)
            residual = residual - self.codebooks[i][idx]
            codes.append(idx)
        return torch.stack(codes, dim=1).to(torch.int32)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (B, n_q, T) -> continuous latent (B, T, D), fp32."""
        codes = codes.long()
        out = self.codebooks[0][codes[:, 0]]
        for i in range(1, codes.shape[1]):
            out = out + self.codebooks[i][codes[:, i]]
        return out

    def quantize_latent(self, x: torch.Tensor, n_q: Optional[int] = None) -> torch.Tensor:
        """The quantize-dequantize bottleneck of the reference's get_emb."""
        return self.decode(self.encode(x, n_q))
