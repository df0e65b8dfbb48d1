"""Audio helpers (port of part of jen1_tpu/data/audio_io.py). numpy and
the stdlib `wave` module only.

`read_wav` / `write_wav` (PCM WAV; `save_audio` writes through the latter)
and `convert_audio`, which `Jen1.generate` applies to `init_audio`. Reading
other formats (`load_audio` and the native decoders) waits for ROADMAP
Queue 1, 'Rest of training' (`MusicDataset`).
"""

from __future__ import annotations

import wave
from typing import Optional, Tuple

import numpy as np


def read_wav(path: str, start_frame: int = 0,
             num_frames: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """(audio (T, channels) float32 in [-1, 1], sample_rate) of an 8/16/24/
    32-bit integer PCM WAV (jen1_tpu/data/audio_io.py:17-50); 32-bit
    samples are read as int32."""
    with wave.open(path, "rb") as w:
        sr, n_ch, width, total = (w.getframerate(), w.getnchannels(), w.getsampwidth(),
                                  w.getnframes())
        start_frame = min(start_frame, total)
        if num_frames is None:
            num_frames = total - start_frame
        w.setpos(start_frame)
        raw = w.readframes(min(num_frames, total - start_frame))
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3).astype(np.int32)
        ints = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        ints = np.where(ints >= 2**23, ints - 2**24, ints)
        data = ints.astype(np.float32) / 8388608.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width: {width}")
    return data.reshape(-1, n_ch), sr


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """audio (T, channels) or (T,) float in [-1, 1] -> 16-bit PCM WAV:
    clipped to [-1, 1], times 32767, truncated toward zero
    (jen1_tpu/data/audio_io.py:53-63)."""
    audio = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    if audio.ndim == 1:
        audio = audio[:, None]
    ints = (audio * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(audio.shape[1])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(ints.tobytes())


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
