"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled on first use, one nvcc per source, all started
together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
         -Xptxas -v -c csrc/<name>.cu -o <name>.o

and the objects linked with ``nvcc -shared`` into
``timeviper_tpu_torch/_build/<hash>/libtimeviper_kernels.so``, where the hash
covers every source, header and flag, so an edit rebuilds and an unchanged
tree reuses the library. The library has a plain C interface and is bound
with ``ctypes``: every pointer and the stream are ``c_void_p``. Nothing is
built or imported when this module is imported: the CPU tests import every
module.
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
              "-Xcompiler", "-fPIC")
LIB_NAME = "libtimeviper_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "tv_ssd_fwd": [_P] * 25 + [_I] * 14 + [_F, _F, _P],
    "tv_ssd_bwd": [_P] * 30 + [_I] * 9 + [_F, _F, _P],
    "tv_flash_fwd": [_P] * 7 + [_I] * 9 + [_F, _P],
    "tv_flash_bwd": [_P] * 14 + [_I] * 12 + [_F, _P],
    "tv_block_attn": [_P] * 11 + [_I] * 6 + [_L] + [_I] * 6 + [_F, _P],
    "tv_vit_attn_qkv": [_P] * 3 + [_I] * 5 + [_F, _P],
    "tv_headgrid_attn": [_P, _P] + [_I] * 7 + [_F, _P],
    "tv_vit_attn": [_P] * 5 + [_I] * 4 + [_L, _I] * 3 + [_I, _F, _P],
    "tv_vit_attn_bwd": [_P] * 11 + [_I] * 4 + [_L, _I] * 4 + [_I, _I, _F, _P],
    "tv_vit_attn_bwd_smem": [_I, _I],
    "tv_layernorm": [_P] * 7 + [_I] * 2 + [_F, _P],
    "tv_decode_fused": [_P] * 15 + [_I] * 6 + [_L, _L, _F, _P],
    "tv_flash_bwd_smem": [_I],
    "tv_headgrid_smem": [_I],
    "tv_ssd_bwd_smem": [],
    "tv_ssd_fwd_block": [_I, _P],
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
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # build into a private directory, then rename the library: concurrent
    # builders never load a half-written one
    tmp = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o", str(obj)]
            jobs.append((src.name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for name, _, proc in jobs:
            text, _ = proc.communicate()
            logs.append(f"== {name}\n{text}")
            if proc.returncode != 0:
                failed.append(name)
        build_log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        lib_tmp = tmp / LIB_NAME
        link = subprocess.run([nvcc, "-shared", "-o", str(lib_tmp),
                               *(str(obj) for _, obj, _ in jobs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(lib_tmp, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
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
