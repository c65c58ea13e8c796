"""Microbenchmarks on the card (counterparts of scripts/microbench_*.py):
`python -m timeviper_tpu_torch.bench.microbench_vit_attn` and
`python -m timeviper_tpu_torch.bench.microbench_flash`. Each prints one JSON
object whose keys line up with the TPU script's, plus the card, its power
limit and the torch and CUDA versions; nothing runs at import.
`python -m timeviper_tpu_torch.bench.attention_ab` times the attention
kernels (K2, K2-bwd, K3, K6, K9, K10a) for comparing two trees of the package
on one card."""

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


def device_ms(fn: Callable[[], object], iters: int = 20) -> float:
    """Device time (ms) of one call, summed over the kernels it launches
    (torch.profiler), with the 50 MB L2 flushed before each call as the main
    path leaves it: for calls of a few microseconds, where CUDA events around
    a loop would time the host's launches instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")

    def total_us(body) -> float:
        body()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_()
                body()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)

    return (total_us(fn) - total_us(lambda: None)) / iters / 1e3


def bound_ms(flops: float, moved: float) -> float:
    """The least time (ms) the card could take: the larger of the bf16
    operations over the tensor cores' peak and the bytes over the memory
    rate."""
    return max(flops / PEAK_BF16_FLOPS, moved / PEAK_BYTES) * 1e3
