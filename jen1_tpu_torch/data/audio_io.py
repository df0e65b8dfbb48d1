"""Audio helpers (port of part of jen1_tpu/data/audio_io.py). numpy only.

Only `convert_audio`, which `Jen1.generate` applies to `init_audio`, is
ported; reading and writing files waits for ROADMAP Queue 1, 'Long-form
output' (`save_audio`) and 'Rest of training' (`MusicDataset`).
"""

from __future__ import annotations

import numpy as np


def convert_audio(audio: np.ndarray, src_sr: int, dst_sr: int,
                  dst_channels: int) -> np.ndarray:
    """(T, ch) or (T,) -> (T', dst_channels) float32: channel up/down-mix and
    a linear resample (jen1_tpu/data/audio_io.py:199-222, encodec.utils'
    convert_audio)."""
    if audio.ndim == 1:
        audio = audio[:, None]
    t, c = audio.shape
    if c != dst_channels:
        if dst_channels == 1:
            audio = audio.mean(axis=1, keepdims=True)
        elif c == 1:
            audio = np.repeat(audio, dst_channels, axis=1)
        else:
            audio = audio[:, :dst_channels]
    if src_sr != dst_sr:
        new_t = int(round(t * dst_sr / src_sr))
        x_old = np.linspace(0.0, 1.0, t, endpoint=False)
        x_new = np.linspace(0.0, 1.0, new_t, endpoint=False)
        audio = np.stack(
            [np.interp(x_new, x_old, audio[:, ch]) for ch in range(audio.shape[1])], axis=1)
    return audio.astype(np.float32)
