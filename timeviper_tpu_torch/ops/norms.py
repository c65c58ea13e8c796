"""RMSNorm and gated group RMSNorm (counterpart of timeviper_tpu/ops/norms.py).

Statistics and the elementwise chain run in float32 and the result is rounded
once to the input dtype, as the reference NemotronHRMSNorm and
MambaRMSNormGated do. The JAX package's bf16 path rounds twice (scale, then
weight), so bf16 results agree with it to about one bf16 ulp, not bitwise; in
float32 the two are the same computation.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """y = weight * x / sqrt(mean(x^2) + eps) over the last axis."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def gated_rms_norm(
    x: torch.Tensor,
    gate: Optional[torch.Tensor],
    weight: torch.Tensor,
    eps: float = 1e-5,
    group_size: Optional[int] = None,
) -> torch.Tensor:
    """rmsnorm(x * silu(gate)) with the statistic taken per group of
    `group_size` channels (mamba_ssm's norm_before_gate=False)."""
    d = x.shape[-1]
    group_size = d if group_size is None else group_size
    if d % group_size:
        raise ValueError(f"width {d} is not a multiple of group_size {group_size}")
    xf = x.float()
    if gate is not None:
        xf = xf * F.silu(gate.float())
    xg = xf.reshape(*x.shape[:-1], d // group_size, group_size)
    var = xg.square().mean(-1, keepdim=True)
    y = (xg * torch.rsqrt(var + eps)).reshape(x.shape)
    return (y * weight.float()).to(x.dtype)
