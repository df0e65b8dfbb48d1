"""Builds and loads the port's CUDA kernel library.

Each `jen1_tpu_torch/csrc/*.cu` source is compiled for sm_90a by its own
`nvcc` process, all started together, and one more `nvcc` links the
objects into one shared library with a plain C interface, which is loaded
with ctypes. The library goes
into `build/jen1_tpu_torch/<hash of sources and flags>/` at the repository
root (listed in .gitignore), so a changed source rebuilds and an unchanged
one loads the cached build. Nothing is built at import: the first call to
`library()` builds. A missing `nvcc` is an error.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Optional

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "jen1_tpu_torch"
LIB_NAME = "libjen1_tpu_torch_kernels.so"
COMPILE_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


@dataclasses.dataclass
class BuildInfo:
    path: Path
    seconds: float  # wall of this call's build; 0.0 when the cache was hit
    log: str  # nvcc output, including `-Xptxas -v` register/smem use


_LIB: Optional[ctypes.CDLL] = None
_BUILD: Optional[BuildInfo] = None


def sources() -> List[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in srcs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile the library unless a build of the same sources exists."""
    global _BUILD
    if _BUILD is not None:
        return _BUILD
    srcs = sources()
    out_dir = BUILD_ROOT / _digest(srcs)
    lib = out_dir / LIB_NAME
    if lib.exists():
        _BUILD = BuildInfo(lib, 0.0, "")
        return _BUILD
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in srcs]
        procs = [
            subprocess.Popen([nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(srcs, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        failed = [log for p, log in zip(procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
    _BUILD = BuildInfo(lib, time.perf_counter() - t0, "".join(logs) + link.stdout)
    return _BUILD


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build().path))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # (name, pointer arguments): each then takes bh, n, d, dtype,
        # causal (ints), sm_scale (float) and the stream
        for name, n_ptrs in (("jen1_flash_attention_fwd", 5),
                             ("jen1_flash_attention_bwd_dq", 7),
                             ("jen1_flash_attention_bwd_dkv", 8)):
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * n_ptrs + [i32] * 5 + [f32, ptr]
            fn.restype = i32
        # K4: x, w8, scale, work, out; m, k, n, dtype, splits, chunk; stream
        lib.jen1_int8w_matmul.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
        lib.jen1_int8w_matmul.restype = i32
        _LIB = lib
    return _LIB
