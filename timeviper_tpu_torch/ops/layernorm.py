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
which launches or raises.

Under autograd (grad enabled and an input requiring it) the bf16 and f32
variants go through `FusedLNFn` / `FusedLNResFn`, the JAX package's custom
VJPs (:97-134): the forward as above (K8 on the card, the plain version on
the CPU), the backward the standard LayerNorm gradient `ln_bwd_math` in
PyTorch, as JAX writes it in jnp (it has no Pallas backward). The int8
variant stays inference-only, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch

from timeviper_tpu_torch.ops import _cuda

__all__ = ["fused_ln", "fused_ln_plain", "fused_ln_supported", "ln_bwd_math"]

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


def ln_bwd_math(x, w, dy, eps: float):
    """The LayerNorm gradient of timeviper_tpu/ops/layernorm.py:_ln_bwd_math
    in f32: (dx in x's dtype, dw in w's dtype, db f32)."""
    xf, wf, dyf = x.float(), w.float(), dy.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mean) * rstd
    g = dyf * wf
    dx = rstd * (g - g.mean(-1, keepdim=True) - xhat * (g * xhat).mean(-1, keepdim=True))
    red = tuple(range(x.dim() - 1))
    return dx.to(x.dtype), (dyf * xhat).sum(red).to(w.dtype), dyf.sum(red)


class FusedLNFn(torch.autograd.Function):
    """fused_ln without a residual under autograd (JAX `_fused_ln_diff`)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _fused_ln(x, weight, bias, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw, db = ln_bwd_math(x, w, dy, ctx.eps)
        return dx, dw, db.to(w.dtype), None


class FusedLNResFn(torch.autograd.Function):
    """fused_ln with a residual under autograd (JAX `_fused_ln_res_diff`):
    the gradient of x_new = residual + x joins the norm's, in x's dtype."""

    @staticmethod
    def forward(ctx, residual, x, weight, bias, eps):
        ctx.save_for_backward(residual, x, weight)
        ctx.eps = eps
        return _fused_ln(x, weight, bias, eps=eps, residual=residual)

    @staticmethod
    def backward(ctx, d_xnew, dy):
        res, out, w = ctx.saved_tensors
        dx, dw, db = ln_bwd_math(res + out, w, dy, ctx.eps)
        dtot = dx + d_xnew.to(dx.dtype)
        return dtot, dtot, dw, db.to(w.dtype), None


def fused_ln(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *, eps: float = 1e-6,
             residual: Optional[torch.Tensor] = None, act_inv: Optional[torch.Tensor] = None):
    """LayerNorm of x (..., D), or of residual + x, with w and b (D,) f32.
    Returns y (x's dtype, or int8 when `act_inv`, an f32 scalar, is given);
    with `residual`, (x_new, y). Differentiable without `act_inv`."""
    if act_inv is None and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, residual, weight, bias)):
        if residual is None:
            return FusedLNFn.apply(x, weight, bias, eps)
        return FusedLNResFn.apply(residual, x, weight, bias, eps)
    return _fused_ln(x, weight, bias, eps=eps, residual=residual, act_inv=act_inv)


def _fused_ln(x, weight, bias, *, eps, residual=None, act_inv=None):
    """The forward: the plain version for a CPU tensor, K8 for a CUDA one."""
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
