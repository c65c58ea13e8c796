"""Depthwise causal conv1d of the Mamba-2 mixer (counterpart of
timeviper_tpu/ops/conv.py).

The kernel is short (K = 4), so the conv is a sum of K shifted copies, which
lets each tap be masked where it would cross a packed-segment boundary
(`seq_idx`). The sum runs in float32 and is rounded once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _activate(y: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    if activation in ("silu", "swish"):
        return F.silu(y)
    if activation is not None:
        raise ValueError(f"Unsupported conv activation: {activation}")
    return y


def causal_conv1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    activation: Optional[str] = "silu",
    seq_idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x: (B, L, C); weight: (C, K), tap k multiplies x[t - (K-1) + k];
    bias: (C,); seq_idx: (B, L) int segment ids. Returns (B, L, C) in x.dtype."""
    L = x.shape[1]
    K = weight.shape[-1]
    xf = x.float()
    wf = weight.float()
    y = xf * wf[:, K - 1]
    for k in range(1, min(K, L)):
        shifted = F.pad(xf[:, : L - k], (0, 0, k, 0))
        if seq_idx is not None:
            same = F.pad(seq_idx[:, : L - k] == seq_idx[:, k:], (k, 0), value=False)
            shifted = shifted * same[..., None]
        y = y + shifted * wf[:, K - 1 - k]
    if bias is not None:
        y = y + bias.float()
    return _activate(y, activation).to(x.dtype)


def causal_conv1d_update(
    x: torch.Tensor,
    conv_state: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    activation: Optional[str] = "silu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. x: (B, C); conv_state: (B, C, K), oldest first.
    Returns (y (B, C), new_state (B, C, K))."""
    new_state = torch.cat([conv_state[..., 1:], x[..., None].to(conv_state.dtype)], dim=-1)
    y = (new_state.float() * weight.float()).sum(-1)
    if bias is not None:
        y = y + bias.float()
    return _activate(y, activation).to(x.dtype), new_state


def init_conv_state(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Decode conv state from prefill conv inputs x: (B, L, C) -> (B, C, K):
    the last K inputs, left-padded with zeros."""
    L = x.shape[1]
    K = kernel_size
    tail = x[:, L - K:] if L >= K else F.pad(x, (0, 0, K - L, 0))
    return tail.transpose(1, 2).contiguous()
