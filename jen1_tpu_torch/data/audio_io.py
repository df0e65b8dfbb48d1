"""Audio I/O (port of jen1_tpu/data/audio_io.py). numpy, the stdlib `wave`
module and the native decoders (`data/native_io.py`).

`load_audio` / `get_duration_sec` read WAV, FLAC, MP3, OGG and AAC/M4A
through the native decoders, chosen by the file's extension; a WAV file the
native reader rejects is read by the stdlib `read_wav`, as in the JAX
package. Unlike JAX, nothing falls through to soundfile or torchaudio: any
other extension raises ValueError, and a decoder that cannot be built or
loaded raises. `write_wav` writes 16-bit PCM (`save_audio` writes through
it) and `convert_audio` mixes channels and resamples.
"""

from __future__ import annotations

import os
import wave
from typing import Optional, Tuple

import numpy as np

from jen1_tpu_torch.data import native_io

# file extension -> native decoder (jen1_tpu/data/audio_io.py:66-139)
EXT_FORMAT = {".wav": "wav", ".flac": "flac", ".mp3": "mp3", ".ogg": "ogg", ".oga": "ogg",
              ".aac": "aac", ".m4a": "aac", ".mp4": "aac"}


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


def _format(path: str) -> str:
    ext = os.path.splitext(str(path))[1].lower()
    if ext not in EXT_FORMAT:
        raise ValueError(f"cannot read {path}: supported audio formats are "
                         f"{', '.join(sorted(EXT_FORMAT))}")
    return EXT_FORMAT[ext]


def load_audio(path: str, start_frame: int = 0,
               num_frames: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """(audio (frames, channels) float32, sample_rate) of `num_frames` frames
    from `start_frame` (to the end of the file by default), zero-padded
    past the end (jen1_tpu/data/audio_io.py:66-139)."""
    fmt = _format(path)
    if fmt != "wav":
        return native_io.read(fmt, path, start_frame, num_frames)
    try:
        return native_io.read("wav", path, start_frame, num_frames)
    except IOError:
        return read_wav(path, start_frame, num_frames)


def get_duration_sec(path: str) -> float:
    """Duration from the file's header (MP3: one index scan; AAC: one
    decode count) (jen1_tpu/data/audio_io.py:142-196)."""
    fmt = _format(path)
    try:
        sr, _, frames = native_io.info(fmt, path)
    except IOError:
        if fmt != "wav":
            raise
        with wave.open(path, "rb") as w:
            return w.getnframes() / w.getframerate()
    return frames / sr


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
