"""Build the host-side C++ libraries (`timeviper_tpu_torch/native/*.cpp`)
with g++ into `timeviper_tpu_torch/_build/<hash>/`, where the hash covers
the source and the flags: an edit rebuilds, an unchanged tree reuses the
library. The compiler writes to a temporary name in that folder and the
result is renamed into place, so processes that build at once never load a
half-written library. Nothing is built when a module is imported."""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from typing import Sequence

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "_build")


def library_path(src: str, flags: Sequence[str], name: str) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"native-{h.hexdigest()[:16]}", name)


def build_library(src: str, flags: Sequence[str], out: str, timeout: int,
                  libs: Sequence[str] = ()) -> bool:
    """g++ `flags` src -> out; False when the compiler or a library is
    missing or the build fails."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    try:
        subprocess.run(["g++", *flags, "-o", tmp, src, *libs, "-lpthread"],
                       check=True, capture_output=True, timeout=timeout)
        os.replace(tmp, out)
        return True
    except Exception:
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
