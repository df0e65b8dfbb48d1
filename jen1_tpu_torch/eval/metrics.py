"""Audio evaluation metrics (port of jen1_tpu/eval/metrics.py).

Fréchet Audio Distance (the Fréchet distance between Gaussian fits of two
embedding sets) with a pluggable embedder: the default is a deterministic
log-mel map (relative comparisons only), `eval/vggish.py` gives the
canonical VGGish one. SNR and spectral convergence compare paired clips.
Inputs are tensors on any device; the work runs there, fp32 products
under `fp32_precision` (no TF32).

Windows as in the JAX package: the log-mel map and spectral convergence use
the symmetric `np.hanning(frame)`; VGGish its periodic one.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from jen1_tpu_torch.ops.conv import fp32_precision


def _mel_filterbank(num_mels: int, num_fft_bins: int, sample_rate: int) -> np.ndarray:
    """Triangular mel filterbank (num_mels, num_fft_bins) over FFT bins."""

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mels = np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2), num_mels + 2)
    bins = np.floor((num_fft_bins * 2 - 1) * mel_to_hz(mels) / sample_rate).astype(int)
    fb = np.zeros((num_mels, num_fft_bins), np.float32)
    for i in range(num_mels):
        lo, ctr, hi = bins[i], bins[i + 1], bins[i + 2]
        for b in range(lo, ctr):
            fb[i, b] = (b - lo) / (ctr - lo)
        for b in range(ctr, hi):
            fb[i, b] = (hi - b) / (hi - ctr)
    return fb


def _frames(audio: torch.Tensor, frame: int, hop: int) -> torch.Tensor:
    """(B, T) -> (B, F, frame) windowed by the symmetric Hann window; at
    least one frame, no padding."""
    n_frames = max(1, (audio.shape[1] - frame) // hop + 1)
    window = torch.from_numpy(np.hanning(frame).astype(np.float32)).to(audio.device)
    return audio[:, : frame + (n_frames - 1) * hop].unfold(-1, frame, hop) * window


def _mono(audio: torch.Tensor) -> torch.Tensor:
    audio = audio.float()
    return audio.mean(dim=-1) if audio.dim() == 3 else audio


@fp32_precision()
def log_mel_embedding(audio: torch.Tensor, sample_rate: int = 48_000, num_mels: int = 64,
                      frame: int = 1024, hop: int = 512) -> torch.Tensor:
    """audio (B, T) or (B, T, ch) -> per-frame log-mel features
    (B * F, num_mels)."""
    frames = _frames(_mono(audio), frame, hop)
    spec = torch.fft.rfft(frames, dim=-1).abs() ** 2  # (B, F, bins)
    fb = torch.from_numpy(_mel_filterbank(num_mels, spec.shape[-1], sample_rate))
    mel = torch.einsum("bfk,mk->bfm", spec, fb.to(spec.device))
    return torch.log(mel + 1e-8).reshape(-1, num_mels)


def _sqrtm_psd(mat: torch.Tensor) -> torch.Tensor:
    """Square root of a PSD matrix by eigendecomposition, negative
    eigenvalues clamped to 0. The eigendecomposition runs in fp64: the
    fp32 one of torch's CPU LAPACK fails to converge, or returns NaN, on
    the rank-deficient covariances of a few clips (15-24 VGGish
    embeddings in 128 dimensions), where JAX's fp32 eigh converges."""
    vals, vecs = torch.linalg.eigh(mat.double())
    return ((vecs * vals.clamp_min(0.0).sqrt()[None, :]) @ vecs.T).to(mat.dtype)


@fp32_precision()
def frechet_distance(mu1: torch.Tensor, sigma1: torch.Tensor, mu2: torch.Tensor,
                     sigma2: torch.Tensor) -> torch.Tensor:
    """||mu1 - mu2||^2 + Tr(S1 + S2 - 2 (S1^1/2 S2 S1^1/2)^1/2), clamped at
    0 (eigh noise can make near-equal Gaussians slightly negative)."""
    diff = mu1 - mu2
    s1h = _sqrtm_psd(sigma1)
    covmean = _sqrtm_psd(s1h @ sigma2 @ s1h)
    dist = diff @ diff + torch.trace(sigma1 + sigma2 - 2.0 * covmean)
    return dist.clamp_min(0.0)


@fp32_precision()
def _fit_gaussian(emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    mu = emb.mean(dim=0)
    centered = emb - mu
    return mu, (centered.T @ centered) / max(emb.shape[0] - 1, 1)


def frechet_audio_distance(reference_audio: torch.Tensor, candidate_audio: torch.Tensor,
                           sample_rate: int = 48_000,
                           embed_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                           ) -> float:
    """FAD between two audio sets (B, T[, ch]) under `embed_fn` (default:
    the log-mel map)."""
    if embed_fn is None:
        embed_fn = lambda a: log_mel_embedding(a, sample_rate)  # noqa: E731
    mu_r, sig_r = _fit_gaussian(embed_fn(reference_audio))
    mu_c, sig_c = _fit_gaussian(embed_fn(candidate_audio))
    return float(frechet_distance(mu_r, sig_r, mu_c, sig_c))


def signal_to_noise_ratio(reference: torch.Tensor, estimate: torch.Tensor) -> torch.Tensor:
    """Per-example SNR in dB of matching-shape signals (B,)."""
    dims = tuple(range(1, reference.dim()))
    num = reference.float().square().sum(dim=dims)
    den = (reference.float() - estimate.float()).square().sum(dim=dims)
    return 10.0 * torch.log10(num / den.clamp_min(1e-12))


def spectral_convergence(reference: torch.Tensor, estimate: torch.Tensor, frame: int = 1024,
                         hop: int = 256) -> torch.Tensor:
    """||S_ref - S_est||_F / ||S_ref||_F of magnitude spectrograms (B,)."""
    s_ref = torch.fft.rfft(_frames(_mono(reference), frame, hop), dim=-1).abs()
    s_est = torch.fft.rfft(_frames(_mono(estimate), frame, hop), dim=-1).abs()
    num = (s_ref - s_est).square().sum(dim=(1, 2)).sqrt()
    den = s_ref.square().sum(dim=(1, 2)).sqrt()
    return num / den.clamp_min(1e-12)
