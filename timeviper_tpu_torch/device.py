"""Where the port's entry points put their tensors: the CUDA card unless the
caller names a device. There is no fallback to the CPU: with no card and no
device argument, `resolve_device` raises, so a run on the CPU is always one
that asked for it (as the tests do with device="cpu")."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is visible; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
