"""int8 serving weights (counterpart of timeviper_tpu/train/quantize.py).

`quantize_params_int8` swaps every linear the JAX package would quantize
(a 2-D kernel of at least `min_size` elements) for an `Int8Linear`, in place.
The ViT's patch embedding is an `nn.Linear` here, but in the JAX package it
is a 4-D (p, p, 3, D) leaf that is never quantized, so it stays as it is;
InternVideo2's flattened 2-D tubelet kernel is quantized in both. The TransV
merge modules (`TimeViperVLM.merge_modules`, models/pdrop.py) quantize as
the JAX package's tree walk quantizes `params["merge_modules"]`, under the
backbone's switch; their linears see input only inside a pdrop stage or a
decode step on a pdrop cache, so calibrate them with a forward that runs
pdrop.

`calibrate_act_scales` runs a forward with the amax sink of
ops/int8_linear.py installed and gives each int8 layer that saw input
act_inv = 127 / (amax * margin). The JAX version pairs the captured maxima
with the leaves by walking the pytree in dict order while they arrive in
call order, so it is right only when the two agree; here each maximum is
recorded against the module that saw it, whatever the order.

`fuse_decode_in_proj` joins each Mamba layer's five in_proj linears into one
`in_proj["fused"]`; `apply_linear_maybe_quantized` is the weight-only apply
of either layout.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch
import torch.nn.functional as F
from torch import nn

from timeviper_tpu_torch.ops import int8_linear
from timeviper_tpu_torch.ops.int8_linear import LLM_SWITCH, Int8Linear
from timeviper_tpu_torch.train.lora import LoRALinear

IN_PROJ_ORDER = ("gate", "x", "B", "C", "dt")


@torch.no_grad()
def quantize_params_int8(model: nn.Module, min_size: int = 1 << 16) -> nn.Module:
    """Quantize, in place, every nn.Linear whose weight has >= min_size
    elements (timeviper_tpu/train/quantize.py:30); returns the model. A
    module's `KEEP_FULL_PRECISION` names children the JAX package never
    quantizes; its `INT8_SWITCH` names the environment switch of the int8
    path below it (ops/int8_linear.py)."""
    def walk(parent: nn.Module, switch: str) -> None:
        switch = getattr(parent, "INT8_SWITCH", switch)
        keep = getattr(parent, "KEEP_FULL_PRECISION", ())
        for name, child in list(parent.named_children()):
            if name in keep:
                continue
            if isinstance(child, LoRALinear):
                raise NotImplementedError("quantizing a LoRA'd linear (QLoRA) is not ported")
            if isinstance(child, nn.Linear):
                if child.weight.numel() >= min_size:
                    setattr(parent, name, Int8Linear.from_linear(child, switch))
            else:
                walk(child, switch)

    walk(model, LLM_SWITCH)
    lm = getattr(model, "lm_head", None)
    if isinstance(lm, Int8Linear):
        lm.f32_weight()  # the f32 logits' weight, formed once here
    return model


@torch.no_grad()
def calibrate_act_scales(forward_fn: Callable, model: nn.Module, batches: Iterable,
                         margin: float = 1.05) -> nn.Module:
    """Static activation scales for the W8A8 path
    (timeviper_tpu/train/quantize.py:55). Runs `forward_fn(model, batch)` for
    each batch with the amax sink installed; each Int8Linear that saw input
    gets act_inv = 127 / (amax * margin), the maximum over all batches. Layers
    the forward never reaches keep the weight-only path. In place; returns the
    model."""
    sink: dict = {}
    int8_linear.ACT_AMAX_SINK = sink
    try:
        for batch in batches:
            forward_fn(model, batch)
    finally:
        int8_linear.ACT_AMAX_SINK = None
    for mod in model.modules():
        if isinstance(mod, Int8Linear) and mod in sink:
            a = float(sink[mod])
            if a > 0:
                mod.act_inv = torch.tensor(127.0 / (a * margin), dtype=torch.float32,
                                           device=mod.kernel_q.device)
    return model


def apply_linear_maybe_quantized(p: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Weight-only apply of an nn.Linear or an Int8Linear
    (timeviper_tpu/train/quantize.py:119)."""
    if isinstance(p, Int8Linear):
        w = p.kernel_q.to(x.dtype) * p.kernel_scale.to(x.dtype)[:, None]
    else:
        w = p.weight.to(x.dtype)
    y = F.linear(x, w)
    if p.bias is not None:
        y = y + p.bias.to(y.dtype)
    return y


def _fuse(ip: nn.ModuleDict):
    leaves = [ip[k] for k in IN_PROJ_ORDER]
    if any(isinstance(lf, LoRALinear) for lf in leaves):
        return None
    biases = None
    if any(lf.bias is not None for lf in leaves):
        ref = next(lf.bias for lf in leaves if lf.bias is not None)
        biases = torch.cat([lf.bias if lf.bias is not None
                            else ref.new_zeros(lf.out_features) for lf in leaves])
    if all(isinstance(lf, Int8Linear) for lf in leaves):
        act_inv = None
        if all(lf.act_inv is not None for lf in leaves):
            # one input activation: the smallest act_inv is the largest amax
            act_inv = torch.stack([lf.act_inv for lf in leaves]).min()
        return Int8Linear(torch.cat([lf.kernel_q for lf in leaves]),
                          torch.cat([lf.kernel_scale for lf in leaves]),
                          biases, act_inv, leaves[0].switch)
    if all(type(lf) is nn.Linear for lf in leaves):
        w = torch.cat([lf.weight for lf in leaves])
        fused = nn.Linear(w.shape[1], w.shape[0], bias=biases is not None,
                          dtype=w.dtype, device=w.device)
        fused.weight.copy_(w)
        if biases is not None:
            fused.bias.copy_(biases)
        return fused
    return None  # mixed layouts stay split


@torch.no_grad()
def fuse_decode_in_proj(model: nn.Module) -> nn.Module:
    """Replace each Mamba layer's split in_proj (gate/x/B/C/dt) by one
    `in_proj["fused"]` linear whose output is their concatenation, in that
    order (timeviper_tpu/train/quantize.py:131). Layers carrying LoRA factors
    and mixed layouts keep their split leaves. In place; returns the model."""
    for mod in model.modules():
        ip = getattr(mod, "in_proj", None)
        if isinstance(ip, nn.ModuleDict) and all(k in ip for k in IN_PROJ_ORDER):
            fused = _fuse(ip)
            if fused is not None:
                mod.in_proj = nn.ModuleDict({"fused": fused})
    return model
