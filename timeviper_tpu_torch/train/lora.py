"""LoRA adapters for the port's linear layers (counterpart of
timeviper_tpu/train/lora.py).

`add_lora` swaps every targeted `nn.Linear` for a `LoRALinear` that keeps the
same weight and bias and adds factors in the JAX package's layout: `lora_a`
(d_in, r) drawn N(0, 1/r) from an explicit generator, `lora_b` (r, d_out) at
zero, so the model starts equal to the base, and `lora_scale` = alpha / r.
Targets are the JAX package's regexes, matched against the port's parameter
paths written the JAX way (`llm_backbone/layers/0/mixer/in_proj/x/kernel`).
The forward is y = x W^T + b + (x a b) * scale. Plant the factors before
parallel/tensor_parallel.py:shard_model cuts the model: on a sharded base
the factors stay whole and the forward takes its shard of them.

QLoRA: a targeted int8 linear (ops/int8_linear.py:Int8Linear, from
train/quantize.py) becomes a `LoRAInt8Linear`, whose base is the weight-only
dequantized product (no `act_inv` is set in training) and whose factors are
bf16 unless `dtype` says otherwise, as the JAX package plants them. Its int8
buffers take no gradient: the factors are what trains. `merge_lora` folds
the factors in f32 into a full-precision linear, or with `requantize` back
into int8 (timeviper_tpu/train/lora.py:114-132).
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from timeviper_tpu_torch.ops.int8_linear import Int8Linear, quantize_weight
from timeviper_tpu_torch.parallel.tensor_parallel import tp_linear

DEFAULT_TARGETS = (
    r".*(q_proj|k_proj|v_proj|o_proj|up_proj|down_proj|gate_proj)/kernel",
    r".*in_proj/(gate|x|B|C|dt)/kernel",
    r".*out_proj/kernel",
)


def jax_path(name: str) -> str:
    """A port parameter or module name as a JAX pytree path."""
    return name.replace(".", "/")


class LoRALinear(nn.Module):
    """An nn.Linear's weight and bias plus LoRA factors."""

    def __init__(self, base: nn.Linear, rank: int, alpha: float,
                 generator: torch.Generator, dtype=None):
        super().__init__()
        self.weight, self.bias = base.weight, base.bias
        d_out, d_in = base.weight.shape
        dev, fdtype = base.weight.device, dtype or base.weight.dtype
        a = torch.randn(d_in, rank, generator=generator, device=dev) / math.sqrt(rank)
        self.lora_a = nn.Parameter(a.to(fdtype))
        self.lora_b = nn.Parameter(torch.zeros(rank, d_out, dtype=fdtype, device=dev))
        self.register_buffer("lora_scale",
                             torch.tensor(alpha / rank, dtype=torch.float32, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if getattr(self, "tp", None) is not None:  # a shard (parallel/tensor_parallel.py)
            return tp_linear(self, x)
        y = F.linear(x, self.weight, self.bias)
        delta = (x @ self.lora_a.to(x.dtype)) @ self.lora_b.to(x.dtype)
        return y + delta * self.lora_scale.to(y.dtype)


class LoRAInt8Linear(Int8Linear):
    """An Int8Linear's buffers plus LoRA factors (QLoRA): the int8 base's
    product, then + (x a b) * scale."""

    def __init__(self, base: Int8Linear, rank: int, alpha: float,
                 generator: torch.Generator, dtype=None):
        super().__init__(base.kernel_q, base.kernel_scale, base.bias, base.act_inv, base.switch)
        d_out, d_in = base.kernel_q.shape
        dev, fdtype = base.kernel_q.device, dtype or torch.bfloat16
        a = torch.randn(d_in, rank, generator=generator, device=dev) / math.sqrt(rank)
        self.lora_a = nn.Parameter(a.to(fdtype))
        self.lora_b = nn.Parameter(torch.zeros(rank, d_out, dtype=fdtype, device=dev))
        self.register_buffer("lora_scale",
                             torch.tensor(alpha / rank, dtype=torch.float32, device=dev))

    @classmethod
    def from_lora(cls, mod: LoRALinear, switch: str) -> "LoRAInt8Linear":
        """A LoRALinear with its weight quantized and its factors kept."""
        out = cls.__new__(cls)
        Int8Linear.__init__(out, *quantize_weight(mod.weight),
                            None if mod.bias is None else mod.bias.detach().clone(), None, switch)
        out.lora_a, out.lora_b = mod.lora_a, mod.lora_b
        out.register_buffer("lora_scale", mod.lora_scale)
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        delta = (x @ self.lora_a.to(x.dtype)) @ self.lora_b.to(x.dtype)
        return y + delta * self.lora_scale.to(y.dtype)


LORA_MODULES = (LoRALinear, LoRAInt8Linear)


def _set_module(root: nn.Module, name: str, module: nn.Module) -> None:
    parent, _, leaf = name.rpartition(".")
    setattr(root.get_submodule(parent) if parent else root, leaf, module)


def add_lora(
    model: nn.Module,
    rank: int = 8,
    alpha: float = 16.0,
    targets: Tuple[str, ...] = DEFAULT_TARGETS,
    generator: Optional[torch.Generator] = None,
    scope: str = "llm_backbone",
    dtype=None,
) -> nn.Module:
    """Plant LoRA factors on every targeted linear of `model`, an nn.Linear
    or an int8 one (in place; returns it). `generator` (on the model's
    device) draws `lora_a`; `dtype` is the factors' dtype, by default the
    weight's, bf16 on an int8 base."""
    hits = []
    for name, mod in model.named_modules():
        kp = jax_path(name) + "/kernel"
        if (isinstance(mod, (nn.Linear, Int8Linear)) and not isinstance(mod, LORA_MODULES)
                and (not scope or kp.startswith(scope) or scope in kp)
                and any(re.fullmatch(t, kp) for t in targets)):
            hits.append((name, mod))
    if generator is None and hits:
        dev = next(hits[0][1].buffers() if isinstance(hits[0][1], Int8Linear)
                   else hits[0][1].parameters()).device
        generator = torch.Generator(device=dev).manual_seed(0)
    for name, mod in hits:
        wrap = LoRAInt8Linear if isinstance(mod, Int8Linear) else LoRALinear
        _set_module(model, name, wrap(mod, rank, alpha, generator, dtype))
    return model


def _plain_linear(weight: torch.Tensor, bias: Optional[torch.Tensor]) -> nn.Linear:
    lin = nn.Linear(weight.shape[1], weight.shape[0], bias=bias is not None,
                    dtype=weight.dtype, device=weight.device)
    lin.weight.copy_(weight)
    if bias is not None:
        lin.bias = nn.Parameter(bias.detach().clone())
    return lin


@torch.no_grad()
def merge_lora(model: nn.Module, requantize: bool = False) -> nn.Module:
    """Fold every LoRA delta into its weight (in place; returns the model).
    A LoRALinear becomes an nn.Linear of its weight's dtype. An int8 base
    (QLoRA) dequantizes exactly and merges in f32: into an nn.Linear of the
    factors' dtype, or with `requantize` into an Int8Linear quantized again
    per output channel, its `act_inv` kept (it scales the unchanged input)."""
    hits = [(n, m) for n, m in model.named_modules() if isinstance(m, LORA_MODULES)]
    for name, mod in hits:
        delta = ((mod.lora_a.float() @ mod.lora_b.float()) * mod.lora_scale).T
        if isinstance(mod, LoRALinear):
            merged = _plain_linear((mod.weight.float() + delta).to(mod.weight.dtype), mod.bias)
        else:
            w = mod.kernel_q.float() * mod.kernel_scale.float()[:, None] + delta
            if requantize:
                merged = Int8Linear(*quantize_weight(w), mod.bias, mod.act_inv, mod.switch)
            else:
                merged = _plain_linear(w.to(mod.lora_a.dtype), mod.bias)
        _set_module(model, name, merged)
    return model


def _is_lora(name: str) -> bool:
    return name.rpartition(".")[2].startswith("lora_")


def split_lora_state(model: nn.Module) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The state dict split into (LoRA factors and scales, everything else)."""
    lora, rest = {}, {}
    for k, v in model.state_dict().items():
        (lora if _is_lora(k) else rest)[k] = v
    return lora, rest


def trainable_lora_state(model: nn.Module,
                         trainable_modules: Optional[str] = None) -> Dict[str, nn.Parameter]:
    """{name: parameter} of what a LoRA fine-tune updates: the lora_a / lora_b
    factors plus the float parameters whose JAX-style path holds one of the
    comma-separated `trainable_modules` substrings (e.g. "projector")."""
    subs = [s.strip() for s in (trainable_modules or "").split(",") if s.strip()]
    out: Dict[str, nn.Parameter] = {}
    for name, p in model.named_parameters():
        if _is_lora(name) or (subs and p.is_floating_point()
                              and any(s in jax_path(name) for s in subs)):
            out[name] = p
    return out
