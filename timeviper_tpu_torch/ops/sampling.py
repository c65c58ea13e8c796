"""Token sampling for the decode loop (counterpart of
timeviper_tpu/ops/sampling.py): greedy, or temperature sampling drawn from an
explicit `torch.Generator`."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SamplingParams(NamedTuple):
    temperature: float = 0.0  # 0 => greedy


def sample_token(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    params: SamplingParams = SamplingParams(),
) -> torch.Tensor:
    """logits (B, V) -> token ids (B,) int64."""
    if params.temperature == 0.0 or generator is None:
        return logits.argmax(dim=-1)
    probs = torch.softmax(logits.float() / params.temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
