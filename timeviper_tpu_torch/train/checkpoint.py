"""Checkpoints with auto-resume discovery (counterpart of
timeviper_tpu/train/checkpoint.py, which writes with orbax).

Layout: <run_dir>/checkpoint-<step>/state.pt, one `torch.save` of {"params":
the optimizer's parameters, "optimizer": its moments and count, "step"}. In a
LoRA run those are the factors and the unfrozen modules, not the frozen
base. `latest_checkpoint` takes the highest step; `save_checkpoint` keeps the
newest `keep`.

`save_params` / `restore_params` are the final-artifact export
(timeviper_tpu/train/checkpoint.py:86-109): <path>/params.pt, one
`torch.save` of a state dict, and the run's `meta` as meta.json beside the
directory, where the JAX package writes it.
"""

from __future__ import annotations

import json
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


PARAMS_FILE = "params.pt"


def save_params(path: str, params: Dict[str, torch.Tensor],
                meta: Optional[Dict[str, Any]] = None) -> str:
    """Write a state dict to <path>/params.pt (through a temporary name) and
    `meta` to meta.json in path's parent directory; returns the path."""
    root = Path(path).resolve()
    root.mkdir(parents=True, exist_ok=True)
    tmp = root / (PARAMS_FILE + ".tmp")
    torch.save({k: v.detach() for k, v in params.items()}, tmp)
    os.replace(tmp, root / PARAMS_FILE)
    if meta is not None:
        with open(root.parent / "meta.json", "w") as f:
            json.dump(meta, f, indent=2)
    return str(root)


def restore_params(path: str, map_location=None) -> Dict[str, torch.Tensor]:
    return torch.load(Path(path) / PARAMS_FILE, map_location=map_location, weights_only=True)
