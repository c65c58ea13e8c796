"""ctypes bindings for the native preprocessing library.

Builds the package's `native/preprocess.cpp` on demand with g++ into
`timeviper_tpu_torch/_build/native-<hash>/libpreprocess.so`
(data/native_build.py) (no pybind11
needed — plain C ABI + ctypes). Falls back to the PIL-based path in
data/image_processing.py when the compiler is missing.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from timeviper_tpu_torch.data.native_build import build_library, library_path

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "native", "preprocess.cpp")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _lib_path() -> str:
    return library_path(_SRC, _FLAGS, "libpreprocess.so")


def _build() -> bool:
    return build_library(_SRC, [*_FLAGS], _lib_path(), timeout=120)


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_lib_path()) and not _build():
            return None
        try:
            lib = ctypes.CDLL(_lib_path())
        except OSError:  # built where a library it links (libav) was present
            return None
        lib.preprocess_frames.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
        ]
        lib.resize_bicubic.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def preprocess_frames_native(
    frames: np.ndarray,
    size: int,
    mean: Tuple[float, float, float],
    std: Tuple[float, float, float],
    n_threads: int = 0,
) -> np.ndarray:
    """(N, H, W, 3) uint8 -> (N, S, S, 3) float32 (resize+normalize)."""
    lib = get_lib()
    assert lib is not None, "native preprocess library unavailable"
    frames = np.ascontiguousarray(frames, np.uint8)
    n, h, w, c = frames.shape
    assert c == 3, frames.shape
    out = np.empty((n, size, size, 3), np.float32)
    mean_a = np.asarray(mean, np.float32)
    std_a = np.asarray(std, np.float32)
    lib.preprocess_frames(
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        size,
        mean_a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std_a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_threads,
    )
    return out
