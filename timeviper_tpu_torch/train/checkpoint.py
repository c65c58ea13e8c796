"""Checkpoints with auto-resume discovery (counterpart of
timeviper_tpu/train/checkpoint.py, which writes with orbax).

Layout: <run_dir>/checkpoint-<step>/state.pt, one `torch.save` of {"params":
the optimizer's parameters, "optimizer": its moments and count, "step"}. In a
LoRA run those are the factors and the unfrozen modules, not the frozen
base. `latest_checkpoint` takes the highest step; `save_checkpoint` keeps the
newest `keep`.
"""

from __future__ import annotations

import os
import re
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

STATE_FILE = "state.pt"


def _ckpt_dirs(run_dir: str) -> List[Tuple[int, Path]]:
    out = []
    root = Path(run_dir)
    if root.is_dir():
        for d in root.iterdir():
            m = re.fullmatch(r"checkpoint-(\d+)", d.name)
            if m and d.is_dir():
                out.append((int(m.group(1)), d))
    return sorted(out)


def latest_checkpoint(run_dir: str) -> Optional[str]:
    dirs = _ckpt_dirs(run_dir)
    return str(dirs[-1][1]) if dirs else None


def save_checkpoint(run_dir: str, step: int, state: Dict[str, Any], keep: int = 3) -> str:
    """Write `state` to <run_dir>/checkpoint-<step>/ and drop the oldest
    beyond `keep`. The file is written under another name and renamed, so a
    crash never leaves a half-written checkpoint."""
    path = Path(run_dir).resolve() / f"checkpoint-{step}"
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / (STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, path / STATE_FILE)
    for _, old in _ckpt_dirs(run_dir)[:-keep]:
        shutil.rmtree(old, ignore_errors=True)
    return str(path)


def restore_checkpoint(path: str, map_location=None) -> Dict[str, Any]:
    return torch.load(Path(path) / STATE_FILE, map_location=map_location, weights_only=True)
