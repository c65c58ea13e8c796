"""ctypes bindings for the native libav video decoder.

The decord replacement (SURVEY.md §2.2 N8): demux/decode/scale in C++
(the package's native/videodec.cpp), built on demand with g++ against the
system ffmpeg libraries into `timeviper_tpu_torch/_build/native-<hash>/`
(data/native_build.py). Registered as the preferred backend by
data/video.py when the build succeeds.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from timeviper_tpu_torch.data.native_build import build_library, library_path

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "native", "videodec.cpp")
_FLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _lib_path() -> str:
    return library_path(_SRC, _FLAGS, "libvideodec.so")


def _build() -> bool:
    try:
        libs = subprocess.run(
            ["pkg-config", "--cflags", "--libs", "libavformat", "libavcodec",
             "libswscale", "libavutil"],
            check=True, capture_output=True, text=True, timeout=30,
        ).stdout.split()
    except Exception:
        return False
    return build_library(_SRC, [*_FLAGS], _lib_path(), timeout=180, libs=libs)


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
        lib.vd_open.restype = ctypes.c_void_p
        lib.vd_open.argtypes = [ctypes.c_char_p]
        lib.vd_info.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_double),
        ]
        lib.vd_read_frames.restype = ctypes.c_int
        lib.vd_read_frames.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
        ]
        lib.vd_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_video_available() -> bool:
    return get_lib() is not None


def probe(path: str) -> Tuple[int, int, float, int, float]:
    """(width, height, fps, total_frames, duration)."""
    lib = get_lib()
    assert lib is not None
    h = lib.vd_open(path.encode())
    if not h:
        raise OSError(f"cannot open video: {path}")
    try:
        w = ctypes.c_int()
        ht = ctypes.c_int()
        fps = ctypes.c_double()
        nf = ctypes.c_longlong()
        dur = ctypes.c_double()
        lib.vd_info(h, ctypes.byref(w), ctypes.byref(ht), ctypes.byref(fps),
                    ctypes.byref(nf), ctypes.byref(dur))
        return w.value, ht.value, fps.value, int(nf.value), dur.value
    finally:
        lib.vd_close(h)


def read_frames(path: str, indices: np.ndarray) -> np.ndarray:
    """Decode the given (sorted) frame indices -> (n, H, W, 3) uint8."""
    lib = get_lib()
    assert lib is not None
    h = lib.vd_open(path.encode())
    if not h:
        raise OSError(f"cannot open video: {path}")
    try:
        w = ctypes.c_int()
        ht = ctypes.c_int()
        fps = ctypes.c_double()
        nf = ctypes.c_longlong()
        dur = ctypes.c_double()
        lib.vd_info(h, ctypes.byref(w), ctypes.byref(ht), ctypes.byref(fps),
                    ctypes.byref(nf), ctypes.byref(dur))
        idx = np.ascontiguousarray(np.sort(np.asarray(indices, np.int64)))
        out = np.empty((len(idx), ht.value, w.value, 3), np.uint8)
        n = lib.vd_read_frames(
            h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            len(idx), out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            ht.value, w.value,
        )
        if n < len(idx):
            # short video or decode tail loss: repeat the last good frame
            if n == 0:
                raise OSError(f"decoded 0 frames from {path}")
            out[n:] = out[n - 1]
        return out
    finally:
        lib.vd_close(h)
