"""STFT and inverse STFT of the UNet's waveform mode (port of
jen1_tpu/ops/stft.py).

torch.stft semantics, as in the JAX package: centre reflect padding, the
periodic Hann window `np.hanning(N + 1)[:-1]`, `normalized` scaling by
window_length^-1/2, a onesided rfft (odd `num_fft` = 1023 has no Nyquist
bin), magnitude and phase (or real and imaginary with `use_complex`), and an
overlap-add inverse normalised by the summed squared window, floored at
1e-11. The overlap-add is one `F.fold`, not a loop over frames.

The DC bin of a real frame has imaginary part 0 whose sign the FFT library
chooses; the phase of a negative DC is then pi or -pi. The encoder sets that
part to +0.0, as the JAX package's CPU rfft gives it, so the phase is +pi on
every device. The decoder zeroes the DC (and, for even `num_fft`, the
Nyquist) imaginary part before the inverse rfft, which the JAX package's
irfft ignores and cuFFT's C2R transform need not.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _zero_imag_edges(im: torch.Tensor, num_fft: int) -> torch.Tensor:
    """im (..., F) with the DC (and even-length Nyquist) entries +0.0."""
    zero = torch.zeros_like(im[..., :1])
    if num_fft % 2:
        return torch.cat([zero, im[..., 1:]], dim=-1)
    return torch.cat([zero, im[..., 1:-1], zero], dim=-1)


class STFT:
    def __init__(
        self,
        num_fft: int = 1023,
        hop_length: int = 256,
        window_length: Optional[int] = None,
        length: Optional[int] = None,
        use_complex: bool = False,
    ):
        self.num_fft = num_fft
        self.hop_length = hop_length or num_fft // 4
        self.window_length = window_length or num_fft
        self.length = length
        self.use_complex = use_complex
        self.window = torch.from_numpy(
            np.hanning(self.window_length + 1)[:-1].astype(np.float32))
        self._windows: Dict[torch.device, torch.Tensor] = {}

    def _window(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._windows:
            self._windows[device] = self.window.to(device)
        return self._windows[device]

    def encode(self, wave: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """wave (B, C, T) -> two (B, C, F, L) fp32 tensors: magnitude and
        phase, or real and imaginary parts."""
        b, c, t = wave.shape
        pad = self.num_fft // 2
        x = F.pad(wave.reshape(b * c, 1, t).float(), (pad, pad), mode="reflect")[:, 0]
        frames = x.unfold(-1, self.num_fft, self.hop_length) * self._window(x.device)
        spec = torch.fft.rfft(frames, n=self.num_fft, dim=-1)  # (BC, L, F)
        scale = self.window_length**-0.5
        re = spec.real * scale
        im = _zero_imag_edges(spec.imag, self.num_fft) * scale
        if self.use_complex:
            first, second = re, im
        else:
            first, second = torch.hypot(re, im), torch.atan2(im, re)
        f, length = first.shape[2], first.shape[1]
        return (first.transpose(1, 2).reshape(b, c, f, length),
                second.transpose(1, 2).reshape(b, c, f, length))

    def decode(self, stft_a: torch.Tensor, stft_b: torch.Tensor,
               length: Optional[int] = None) -> torch.Tensor:
        """Two (B, C, F, L) tensors -> wave (B, C, T) in fp32."""
        b, c, f, frames = stft_a.shape
        a = stft_a.reshape(b * c, f, frames).float().transpose(1, 2)
        p = stft_b.reshape(b * c, f, frames).float().transpose(1, 2)
        if self.use_complex:
            re, im = a, p
        else:
            re, im = a * torch.cos(p), a * torch.sin(p)
        scale = self.window_length**-0.5
        im = _zero_imag_edges(im, self.num_fft)
        spec = torch.complex(re / scale, im / scale)
        window = self._window(a.device)
        chunks = torch.fft.irfft(spec, n=self.num_fft, dim=-1) * window  # (BC, L, N)

        total = self.num_fft + (frames - 1) * self.hop_length
        fold = dict(output_size=(1, total), kernel_size=(1, self.num_fft),
                    stride=(1, self.hop_length))
        out = F.fold(chunks.transpose(1, 2), **fold).reshape(b * c, total)
        win_sq = (window**2)[None, :, None].expand(1, self.num_fft, frames)
        norm = F.fold(win_sq, **fold).reshape(1, total)
        out = out / norm.clamp_min(1e-11)
        pad = self.num_fft // 2
        out = out[:, pad:]
        length = length or self.length
        out = out[:, :length] if length is not None else out[:, : total - 2 * pad]
        return out.reshape(b, c, -1)

    def encode1d(self, wave: torch.Tensor, stacked: bool = True):
        """wave (B, C, T) -> (B, 2 C F, L) with the C*F first parts before
        the C*F second parts, or the two (B, C F, L) halves."""
        a, p = self.encode(wave)
        b, c, f, length = a.shape
        a, p = a.reshape(b, c * f, length), p.reshape(b, c * f, length)
        return torch.cat([a, p], dim=1) if stacked else (a, p)

    def decode1d(self, stft_pair: torch.Tensor, length: Optional[int] = None) -> torch.Tensor:
        f = self.num_fft // 2 + 1
        a, p = stft_pair.chunk(2, dim=1)
        b, cf, frames = a.shape
        return self.decode(a.reshape(b, cf // f, f, frames), p.reshape(b, cf // f, f, frames),
                           length=length)
