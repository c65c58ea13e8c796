"""Microbenchmarks on the card (counterparts of scripts/microbench_*.py):
`python -m timeviper_tpu_torch.bench.microbench_vit_attn` and
`python -m timeviper_tpu_torch.bench.microbench_flash`. Each prints one JSON
object whose keys line up with the TPU script's, plus the card, its power
limit and the torch and CUDA versions; nothing runs at import.
`python -m timeviper_tpu_torch.bench.attention_ab` times K6 and K9 for
comparing two trees of the package on one card."""

from __future__ import annotations

import subprocess
from typing import Callable, Dict

import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s


def device_info(device: torch.device) -> Dict[str, str]:
    """The card's name and power limit as nvidia-smi gives them, and the
    torch and CUDA versions. Raises unless `device` is a CUDA card."""
    if device.type != "cuda":
        raise RuntimeError(f"the microbenchmarks time a CUDA card, not {device}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return {"device": torch.cuda.get_device_name(device), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}


def timed_ms(fn: Callable[[], object], steps: int) -> float:
    """Mean ms of one call over `steps` calls after one warm-up, by CUDA
    events around the loop."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def bound_ms(flops: float, moved: float) -> float:
    """The least time (ms) the card could take: the larger of the bf16
    operations over the tensor cores' peak and the bytes over the memory
    rate."""
    return max(flops / PEAK_BF16_FLOPS, moved / PEAK_BYTES) * 1e3
