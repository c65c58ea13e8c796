"""W8A8 linear with static activation scales (counterpart of
timeviper_tpu/ops/int8_linear.py).

A quantized linear holds (train/quantize.py):
  kernel_q     int8 (out, in)   per-output-channel symmetric (the JAX leaf is
                                its transpose, (in, out))
  kernel_scale f32 (out,)
  act_inv      f32 scalar       127 / calibrated amax (optional)
  bias         optional, in the model's dtype

`apply_linear_w8a8` runs the int8 product only when `act_inv` is present and
the caller asks for it; otherwise it dequantizes the weight (exact per
channel, no activation error). The int8 product is a plain matrix product
outside any TPU kernel in the JAX package (XLA's int8 matmul), so here it is
the library call `torch._int_mm` with an int32 result. The arithmetic is the
JAX package's: the quantize multiplies in x's dtype, the epilogue scales the
int32 sum in f32 and rounds once to x's dtype, then adds the bias.

`Int8Linear` takes an `nn.Linear`'s place. Which environment switch decides
its int8 path is set when it is made: TIMEVIPER_LLM_INT8_MXU for the
backbone and the projector, TIMEVIPER_VIT_INT8_MXU for the vision tower
(timeviper_tpu/models/nano.py:180, models/vit.py:41). "auto", the default,
takes the int8 path for a tensor on the card, as the JAX package's "auto"
takes it on the TPU; "1" and "0" force it on or off.

`ACT_AMAX_SINK`: while calibration (train/quantize.py:calibrate_act_scales)
installs a dict here, every call records max|x| against the module itself
and takes the weight-only path.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Int8Linear", "apply_linear_w8a8", "w8a8_matmul_prequant", "ACT_AMAX_SINK",
           "LLM_SWITCH", "VIT_SWITCH"]

LLM_SWITCH = "TIMEVIPER_LLM_INT8_MXU"
VIT_SWITCH = "TIMEVIPER_VIT_INT8_MXU"

# {module: running max|x| (f32 scalar tensor)} while calibration captures
ACT_AMAX_SINK: Optional[Dict[nn.Module, torch.Tensor]] = None


def use_int8_mxu(switch: str, x: torch.Tensor) -> bool:
    mode = os.environ.get(switch, "auto")
    return x.is_cuda if mode == "auto" else mode == "1"


def int_mm(xq: torch.Tensor, kernel_q: torch.Tensor) -> torch.Tensor:
    """(..., in) int8 x (out, in) int8 -> (..., out) int32, exact.

    On the card torch._int_mm takes more than 16 rows and an inner dim that
    is a multiple of 8: fewer rows (a decode step) are padded with zero rows,
    and an inner dim such as InternVideo2's 588-wide tubelet (14 x 14 x 3)
    with zero columns of both operands; neither changes the real sums."""
    lead = xq.shape[:-1]
    x2 = xq.reshape(-1, xq.shape[-1])
    M, K = x2.shape
    if x2.is_cuda and M <= 16:
        x2 = F.pad(x2, (0, 0, 0, 17 - M))
    if x2.is_cuda and K % 8:
        x2, kernel_q = F.pad(x2, (0, -K % 8)), F.pad(kernel_q, (0, -K % 8))
    acc = torch._int_mm(x2, kernel_q.t())
    return acc[:M].reshape(*lead, kernel_q.shape[0])


def _dequant(acc: torch.Tensor, p: "Int8Linear", dtype) -> torch.Tensor:
    """(acc.float() * (kernel_scale / act_inv)).to(dtype) as one pass: the
    product is taken in f32 and rounded once on the store."""
    y = torch.empty(acc.shape, dtype=dtype, device=acc.device)
    return torch.mul(acc, p.kernel_scale / p.act_inv, out=y)


def apply_linear_w8a8(p: "Int8Linear", x: torch.Tensor, use_int8_mxu: bool = True
                      ) -> torch.Tensor:
    """Linear apply of a quantized layer (timeviper_tpu/ops/int8_linear.py:49)."""
    sink = ACT_AMAX_SINK
    if sink is not None:
        amax = x.detach().float().abs().amax()
        prev = sink.get(p)
        sink[p] = amax if prev is None else torch.maximum(prev, amax)
        use_int8_mxu = False
    if use_int8_mxu and p.act_inv is not None:
        inv = p.act_inv.to(x.dtype)
        xq = torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)
        y = _dequant(int_mm(xq, p.kernel_q), p, x.dtype)
    else:
        w = p.kernel_q.to(x.dtype) * p.kernel_scale.to(x.dtype)[:, None]
        y = F.linear(x, w)
    if p.bias is not None:
        y = y + p.bias.to(y.dtype)
    return y


def w8a8_matmul_prequant(p: "Int8Linear", xq: torch.Tensor,
                         out_dtype=torch.bfloat16) -> torch.Tensor:
    """The int8 product for an activation its producer already quantized (the
    fused LayerNorm, ops/layernorm.py) (timeviper_tpu/ops/int8_linear.py:74)."""
    y = _dequant(int_mm(xq, p.kernel_q), p, out_dtype)
    if p.bias is not None:
        y = y + p.bias.to(y.dtype)
    return y


def quantize_weight(weight: torch.Tensor):
    """(out, in) float weight -> (int8 (out, in), f32 scale (out,)): symmetric
    per output channel, the JAX package's _quantize_kernel
    (timeviper_tpu/train/quantize.py:22) on the transposed layout."""
    wf = weight.detach().float()
    amax = wf.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


class Int8Linear(nn.Module):
    """A quantized linear in an nn.Linear's place. Buffers: kernel_q int8
    (out, in), kernel_scale f32 (out,), act_inv f32 scalar or None, bias or
    None."""

    def __init__(self, kernel_q: torch.Tensor, kernel_scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, act_inv: Optional[torch.Tensor] = None,
                 switch: str = LLM_SWITCH):
        super().__init__()
        self.switch = switch
        self.register_buffer("kernel_q", kernel_q)
        self.register_buffer("kernel_scale", kernel_scale)
        self.register_buffer("act_inv", act_inv)
        self.register_buffer("bias", bias)
        self._f32 = None

    @classmethod
    def from_linear(cls, lin: nn.Linear, switch: str = LLM_SWITCH) -> "Int8Linear":
        q, s = quantize_weight(lin.weight)
        bias = None if lin.bias is None else lin.bias.detach().clone()
        return cls(q, s, bias, None, switch)

    @property
    def in_features(self) -> int:
        return self.kernel_q.shape[1]

    @property
    def out_features(self) -> int:
        return self.kernel_q.shape[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_linear_w8a8(self, x, use_int8_mxu=use_int8_mxu(self.switch, x))

    def f32_weight(self) -> torch.Tensor:
        """kernel_q * kernel_scale in f32, (out, in), formed once and kept
        (the lm_head's logits are f32, timeviper_tpu/models/nano.py:684)."""
        if self._f32 is None:
            self._f32 = self.kernel_q.float() * self.kernel_scale[:, None]
        return self._f32

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # act_inv is optional: the loaded state says whether the layer has one
        key = prefix + "act_inv"
        if key in state_dict and self.act_inv is None:
            self.act_inv = torch.empty((), dtype=torch.float32, device=self.kernel_q.device)
        elif key not in state_dict:
            self.act_inv = None
        self._f32 = None
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"calibrated={self.act_inv is not None}, switch={self.switch}")
