"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o libtimeviper_kernels.so csrc/*.cu

into ``timeviper_tpu_torch/_build/<hash>/``, where the hash covers every
source, header and flag, so an edit rebuilds and an unchanged tree reuses the
library. The library has a plain C interface and is bound with ``ctypes``:
every pointer and the stream are ``c_void_p``. Nothing is built or imported
when this module is imported: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
LIB_NAME = "libtimeviper_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "tv_ssd_fwd": [_P] * 16 + [_I] * 8 + [_F, _F, _P],
    "tv_flash_fwd": [_P] * 5 + [_I] * 6 + [_F, _P],
    "tv_vit_attn_qkv": [_P, _P] + [_I] * 4 + [_F, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: float = 0.0  # time the last build in this process took (0 if reused)
build_log: str = ""         # nvcc's output of that build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the sources unless a library for them exists; return its path."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    sources = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    t0 = time.perf_counter()
    # build into a private name, then rename: concurrent builders never load
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, *sources]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def ptr(t) -> Optional[int]:
    """Device pointer of a tensor, or None (NULL) for a missing operand."""
    return None if t is None else t.data_ptr()


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
