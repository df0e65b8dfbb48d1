"""ctypes bindings for the native audio decoders (port of
jen1_tpu/data/native_io.py:31-552).

The decoders are the C++ sources at the repository root,
`native/{wavio,flacio,mp3io,oggio,aacio}.cpp`, with a plain C interface:

  jen1_<fmt>_info(path, *sr, *channels, *frames) -> 0 on success
  jen1_<fmt>_read(path, start_frame, num_frames, float *out) -> frames or < 0
  jen1_wav_read_batch(paths, starts, frames, channels, batch, float *out)
  jen1_<fmt>_available() -> 1 when the system library is present
      (mp3: libmpg123, ogg: libvorbisfile, both dlopen'ed at run time;
      aac: FFmpeg's libavformat/libavcodec/libavutil, linked)

Each library is built on first use with `g++ -O3 -shared -fPIC` into
`build/jen1_tpu_torch/native/<hash of the source and flags>/` (listed in
.gitignore). The build is atomic: g++ writes a temporary file in that
directory and `os.replace` renames it, so a process that finds the library
finds a whole one, however many processes build at once; a lock serialises
the threads of one process. Nothing falls back: a failed compile raises
with g++'s stderr, a missing system library raises naming it, and a file
the decoder rejects raises IOError.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "jen1_tpu_torch" / "native"

# format -> (source, link flags, system library its *_available checks)
FORMATS: Dict[str, Tuple[str, Tuple[str, ...], Optional[str]]] = {
    "wav": ("wavio.cpp", (), None),
    "flac": ("flacio.cpp", (), None),
    "mp3": ("mp3io.cpp", ("-ldl",), "libmpg123"),
    "ogg": ("oggio.cpp", ("-ldl",), "libvorbisfile"),
    "aac": ("aacio.cpp", ("-lavformat", "-lavcodec", "-lavutil"), "FFmpeg's libavformat"),
}
COMPILE_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def library_path(fmt: str) -> Path:
    """Where the library of `fmt` is built: a directory named by the hash
    of its source and flags, so an edited source builds anew."""
    src, link, _ = FORMATS[fmt]
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + link).encode())
    h.update((NATIVE_DIR / src).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"libjen1{fmt}io.so"


def build(fmt: str) -> Path:
    """Compile the library of `fmt` unless it exists; returns its path."""
    src, link, _ = FORMATS[fmt]
    lib = library_path(fmt)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=lib.parent, prefix=f".{lib.name}.", suffix=".tmp")
    os.close(fd)
    try:
        run = subprocess.run(["g++", *COMPILE_FLAGS, "-o", tmp, str(NATIVE_DIR / src), *link],
                             capture_output=True, text=True)
        if run.returncode != 0:
            raise RuntimeError(f"g++ could not build the {fmt} decoder "
                               f"({NATIVE_DIR / src}):\n{run.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def _bind(fmt: str, lib: ctypes.CDLL) -> None:
    i32p, i64 = ctypes.POINTER(ctypes.c_int32), ctypes.c_int64
    info = getattr(lib, f"jen1_{fmt}_info")
    info.argtypes = [ctypes.c_char_p, i32p, i32p, ctypes.POINTER(i64)]
    info.restype = ctypes.c_int
    read = getattr(lib, f"jen1_{fmt}_read")
    read.argtypes = [ctypes.c_char_p, i64, i64, ctypes.POINTER(ctypes.c_float)]
    read.restype = i64
    if fmt == "wav":
        lib.jen1_wav_read_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(i64), i64, ctypes.c_int32, i64,
            ctypes.POINTER(ctypes.c_float)]
        lib.jen1_wav_read_batch.restype = i64
    if FORMATS[fmt][2] is not None:
        available = getattr(lib, f"jen1_{fmt}_available")
        available.argtypes = []
        available.restype = ctypes.c_int


def get_lib(fmt: str) -> ctypes.CDLL:
    """The loaded library of `fmt`, built on first use."""
    with _lock:
        if fmt not in _libs:
            if fmt not in FORMATS:
                raise ValueError(f"no native decoder for {fmt!r}; have {sorted(FORMATS)}")
            lib = ctypes.CDLL(str(build(fmt)))
            _bind(fmt, lib)
            system = FORMATS[fmt][2]
            if system is not None and getattr(lib, f"jen1_{fmt}_available")() != 1:
                raise RuntimeError(f"the {fmt} decoder needs {system}, which this system "
                                   "does not have")
            _libs[fmt] = lib
        return _libs[fmt]


def info(fmt: str, path: str) -> Tuple[int, int, int]:
    """(sample_rate, channels, num_frames); raises IOError on failure."""
    sr, ch, frames = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int64()
    rc = getattr(get_lib(fmt), f"jen1_{fmt}_info")(
        str(path).encode(), ctypes.byref(sr), ctypes.byref(ch), ctypes.byref(frames))
    if rc != 0:
        raise IOError(f"jen1_{fmt}_info({path}) failed: {rc}")
    return sr.value, ch.value, frames.value


def read(fmt: str, path: str, start_frame: int = 0,
         num_frames: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """(audio (frames, channels) float32, sample_rate); zero-padded past the
    end of the file."""
    sr, ch, total = info(fmt, path)
    if num_frames is None:
        num_frames = max(total - start_frame, 0)
    out = np.empty((num_frames, ch), np.float32)
    rc = getattr(get_lib(fmt), f"jen1_{fmt}_read")(
        str(path).encode(), ctypes.c_int64(start_frame), ctypes.c_int64(num_frames),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc < 0:
        raise IOError(f"jen1_{fmt}_read({path}) failed: {rc}")
    return out, sr


def wav_read_batch(paths: Sequence[str], starts: Sequence[int], frames: int,
                   channels: int) -> np.ndarray:
    """One call decodes a whole (B, frames, channels) batch of WAV windows."""
    b = len(paths)
    out = np.empty((b, frames, channels), np.float32)
    rc = get_lib("wav").jen1_wav_read_batch(
        (ctypes.c_char_p * b)(*[str(p).encode() for p in paths]),
        (ctypes.c_int64 * b)(*[int(s) for s in starts]),
        ctypes.c_int64(frames), ctypes.c_int32(channels), ctypes.c_int64(b),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise IOError(f"jen1_wav_read_batch failed: {rc}")
    return out
