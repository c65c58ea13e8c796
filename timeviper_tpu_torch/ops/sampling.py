"""Token sampling for the decode loop (counterpart of
timeviper_tpu/ops/sampling.py): greedy, or temperature sampling with top-k
and top-p (nucleus) filtering, drawn from an explicit `torch.Generator`.

`filter_logits` applies the JAX package's masks as it writes them: top-k
keeps the logits at or above the k-th largest, top-p those at or above the
first sorted logit where the cumulative probability reaches p, so ties at a
threshold stay in. The draw itself is `torch.multinomial`; it cannot give
`jax.random.categorical`'s numbers, only the same distribution.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SamplingParams(NamedTuple):
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => disabled
    top_p: float = 1.0  # 1 => disabled


def filter_logits(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """(B, V) logits -> f32 logits over the temperature, -inf outside the
    top-k and top-p sets."""
    logits = logits.float() / params.temperature
    if params.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -params.top_k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if params.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # all of the mass below p (rounding) leaves every logit in, as the
        # JAX gather's out-of-range fill does
        cutoff_idx = (cum < params.top_p).sum(-1).clamp(max=logits.shape[-1] - 1)
        cutoff = sorted_logits.gather(-1, cutoff_idx[:, None])
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def sample_token(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    params: SamplingParams = SamplingParams(),
) -> torch.Tensor:
    """logits (B, V) -> token ids (B,) int64."""
    if params.temperature == 0.0 or generator is None:
        return logits.argmax(dim=-1)
    probs = torch.softmax(filter_logits(logits, params), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
