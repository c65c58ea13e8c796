"""Rotary position embeddings of the Qwen2 backbone (counterpart of
timeviper_tpu/ops/rope.py). The Nemotron-H backbone has none.

`rope_frequencies` gives inv_freq = 1 / theta ** (arange(0, hd, 2) / hd) as
the JAX package's jitted forward and decode get it: the expression reads no
input, so XLA folds it into a constant: the exponents are float32 quotients,
and theta (as float32) to their power and its reciprocal are evaluated in
float64 and rounded to float32 once. (Op by op, outside jit, XLA's float32 `pow` gives another
value for about one frequency in 64.) The angles are `position * inv_freq`
in float32, never clipped at max_position_embeddings (the JAX package does
not clip): at position 81,920 one float32 ulp of an inv_freq moves the angle
by about 4e-3 rad, so the frequencies are held bitwise equal to the jitted
JAX ones (tests/test_torch_qwen2.py).
"""

from __future__ import annotations

import functools

import torch


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """inv_freq: (head_dim / 2,) float32, on `device`. Made on the host once
    per (head_dim, theta, device) and kept: a copy from pageable host memory
    per layer would wait for the card every time."""
    return _frequencies(head_dim, float(theta), torch.device(device or "cpu"))


@functools.lru_cache(maxsize=None)
def _frequencies(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    base = float(torch.tensor(theta, dtype=torch.float32))
    return (1.0 / base ** exps.double()).to(torch.float32).to(device)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (B, L) integers -> cos, sin each (B, L, head_dim / 2) f32."""
    inv_freq = rope_frequencies(head_dim, theta, positions.device)
    angles = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Neox rotate-half RoPE. x (B, L, H, D); cos, sin (B, L, D / 2). The
    halves rotate in float32 and the result is cast back to x's dtype once."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c, s = cos[:, :, None], sin[:, :, None]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
