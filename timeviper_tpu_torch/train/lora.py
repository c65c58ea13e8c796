"""LoRA adapters for the port's linear layers (counterpart of
timeviper_tpu/train/lora.py).

`add_lora` swaps every targeted `nn.Linear` for a `LoRALinear` that keeps the
same weight and bias and adds factors in the JAX package's layout: `lora_a`
(d_in, r) drawn N(0, 1/r) from an explicit generator, `lora_b` (r, d_out) at
zero, so the model starts equal to the base, and `lora_scale` = alpha / r.
Targets are the JAX package's regexes, matched against the port's parameter
paths written the JAX way (`llm_backbone/layers/0/mixer/in_proj/x/kernel`).
The forward is y = x W^T + b + (x a b) * scale.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

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
        y = F.linear(x, self.weight, self.bias)
        delta = (x @ self.lora_a.to(x.dtype)) @ self.lora_b.to(x.dtype)
        return y + delta * self.lora_scale.to(y.dtype)


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
    """Plant LoRA factors on every targeted linear of `model` (in place;
    returns it). `generator` (on the model's device) draws `lora_a`; `dtype`
    is the factors' dtype, the weight's by default."""
    hits = []
    for name, mod in model.named_modules():
        kp = jax_path(name) + "/kernel"
        if (isinstance(mod, nn.Linear)
                and (not scope or kp.startswith(scope) or scope in kp)
                and any(re.fullmatch(t, kp) for t in targets)):
            hits.append((name, mod))
    if generator is None and hits:
        generator = torch.Generator(device=hits[0][1].weight.device).manual_seed(0)
    for name, mod in hits:
        _set_module(model, name, LoRALinear(mod, rank, alpha, generator, dtype))
    return model


@torch.no_grad()
def merge_lora(model: nn.Module) -> nn.Module:
    """Fold every LoRALinear's delta into its weight and put a plain
    nn.Linear back (in place; returns the model)."""
    hits = [(n, m) for n, m in model.named_modules() if isinstance(m, LoRALinear)]
    for name, mod in hits:
        d_out, d_in = mod.weight.shape
        lin = nn.Linear(d_in, d_out, bias=mod.bias is not None, dtype=mod.weight.dtype,
                        device=mod.weight.device)
        delta = (mod.lora_a.float() @ mod.lora_b.float()) * mod.lora_scale
        lin.weight.copy_((mod.weight.float() + delta.T).to(mod.weight.dtype))
        if mod.bias is not None:
            lin.bias.copy_(mod.bias)
        _set_module(model, name, lin)
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
