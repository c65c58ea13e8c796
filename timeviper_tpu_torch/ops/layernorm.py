"""K8: residual add + LayerNorm (+ int8 activation quantize) in one pass, as
a hand-written CUDA kernel.

Counterpart of timeviper_tpu/ops/layernorm.py:fused_ln (:137), whose Pallas
kernels are _ln_kernel (:37) and _ln_res_kernel (:43):

    x_new = residual + x                (optional; f32 sum, emitted in x's dtype)
    y     = (x_new - mean) * rsqrt(var + eps) * w + b,
            mean = E[x_new], var = E[x_new^2] - mean^2, in f32
    emit  y in x's dtype, or int8 clip(round(y * act_inv), -127, 127)

The kernel (csrc/layernorm.cu) gives each row to one warp and keeps the row
in registers; `fused_ln_plain` is its plain version. `fused_ln` takes the
plain version for a CPU tensor and the kernel for a CUDA tensor (bf16 only),
which launches or raises. The JAX package's backward (a custom VJP) is not
ported: the port runs the fused norm only in inference.
"""

from __future__ import annotations

from typing import Optional

import torch

from timeviper_tpu_torch.ops import _cuda

__all__ = ["fused_ln", "fused_ln_plain", "fused_ln_supported"]

MAX_D = 2048  # the widest row the kernel keeps in registers


def fused_ln_supported(D: int) -> bool:
    """timeviper_tpu/ops/layernorm.py:69."""
    return D % 128 == 0


def fused_ln_plain(x, weight, bias, *, eps: float = 1e-6, residual=None, act_inv=None):
    """K8's plain version, the same arithmetic in PyTorch."""
    xf = x.float() if residual is None else residual.float() + x.float()
    D = xf.shape[-1]
    mean = xf.sum(-1, keepdim=True) * (1.0 / D)
    var = (xf * xf).sum(-1, keepdim=True) * (1.0 / D) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    if act_inv is not None:
        y = torch.clamp(torch.round(y * act_inv.float()), -127, 127).to(torch.int8)
    else:
        y = y.to(x.dtype)
    return y if residual is None else (xf.to(x.dtype), y)


def fused_ln(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *, eps: float = 1e-6,
             residual: Optional[torch.Tensor] = None, act_inv: Optional[torch.Tensor] = None):
    """LayerNorm of x (..., D), or of residual + x, with w and b (D,) f32.
    Returns y (x's dtype, or int8 when `act_inv`, an f32 scalar, is given);
    with `residual`, (x_new, y)."""
    if x.device.type == "cpu":
        return fused_ln_plain(x, weight, bias, eps=eps, residual=residual, act_inv=act_inv)
    D = x.shape[-1]
    rows = x.numel() // D

    def need(cond, msg):
        if not cond:
            raise ValueError(f"fused_ln kernel: {msg}")

    need(fused_ln_supported(D) and D <= MAX_D, f"takes D % 128 == 0 up to {MAX_D}, got {D}")
    for name, t in (("x", x), ("residual", residual)):
        if t is not None:
            need(t.is_cuda and t.dtype == torch.bfloat16 and t.is_contiguous()
                 and t.shape == x.shape, f"{name} must be a contiguous bf16 CUDA tensor")
    for name, t, shape in (("weight", weight, (D,)), ("bias", bias, (D,)),
                           ("act_inv", act_inv, ())):
        if t is not None:
            need(t.device == x.device and t.dtype == torch.float32 and t.shape == shape
                 and t.is_contiguous(), f"{name} must be contiguous f32 {shape}")
    y = torch.empty(x.shape, dtype=torch.int8 if act_inv is not None else x.dtype,
                    device=x.device)
    x_new = torch.empty_like(x) if residual is not None else None
    p = _cuda.ptr
    err = _cuda.lib().tv_layernorm(p(x), p(residual), p(weight), p(bias), p(act_inv),
                                   p(x_new), p(y), rows, D, eps, _cuda.stream_of(x))
    _cuda.check(err, "tv_layernorm")
    fused_ln.launches += 1
    return y if residual is None else (x_new, y)


fused_ln.launches = 0
