"""Where the port's entry points put their tensors: the CUDA card unless the
caller names a device. There is no fallback to the CPU: with no card and no
device argument, `resolve_device` raises, so a run on the CPU is always one
that asked for it (as the tests do with device="cpu").

Under a multi-process launcher each rank takes its own card, cuda:{local
rank}, and raises when that card does not exist: ranks never share a card
unless the caller names it. Which launcher set the local rank (SLURM, OMPI,
torchrun) is read by `utils/dist.py:detect_process_env` alone."""

from __future__ import annotations

from typing import Union

import torch

from timeviper_tpu_torch.utils.dist import detect_process_env

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is visible; pass device='cpu' to run on the CPU")
    env = detect_process_env()
    if env["num_processes"] <= 1:
        return torch.device("cuda")
    local = env["local_rank"]
    if local >= torch.cuda.device_count():
        raise RuntimeError(f"rank with local rank {local} ({env['launcher']}) has no card of "
                           f"its own ({torch.cuda.device_count()} visible); name a device to "
                           f"share one")
    return torch.device("cuda", local)
