"""AdamW with per-module learning-rate groups (counterpart of
timeviper_tpu/train/optim.py, which builds it from optax).

The update is optax's chain, step for step: [zero the frozen gradients] ->
clip by global norm -> per group (scale_by_adam, add_decayed_weights on the
parameters of two or more dims, scale_by_schedule, scale(-1)) -> add to the
parameter in f32 and round to its dtype. The schedules use optax's formulas.

The port has an optimizer of its own rather than torch.optim.AdamW because
the moments stay in f32 whatever the parameter's dtype (bf16 LoRA factors and
projector weights), as the JAX package's `init_lora_train_state` keeps them:
a bf16 second moment cannot resolve eps = 1e-8.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional

import torch
from torch import nn


@dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 1e-5
    vision_lr: Optional[float] = None  # None -> learning_rate
    projector_lr: Optional[float] = None
    llm_lr: Optional[float] = None
    merge_lr: Optional[float] = None
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    max_grad_norm: float = 1.0
    warmup_steps: int = 0
    total_steps: int = 10000
    schedule: str = "cosine"  # "cosine" | "constant" | "linear"


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end


def _cosine(init: float, decay_steps: int) -> Callable[[int], float]:
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay steps, got {decay_steps}")
    return lambda count: init * 0.5 * (1 + math.cos(math.pi * min(count, decay_steps)
                                                    / decay_steps))


def _join(first, second, boundary: int) -> Callable[[int], float]:
    return lambda count: first(count) if count < boundary else second(count - boundary)


def lr_schedule(base_lr: float, cfg: OptimConfig) -> Callable[[int], float]:
    """Learning rate of update `count` (0 for the first), as optax's
    constant / linear / warmup-cosine schedules give it."""
    if cfg.schedule == "constant":
        if cfg.warmup_steps:
            return _join(_linear(0.0, base_lr, cfg.warmup_steps), lambda c: base_lr,
                         cfg.warmup_steps)
        return lambda count: base_lr
    warm = max(cfg.warmup_steps, 1)
    if cfg.schedule == "linear":
        decay = max(cfg.total_steps - cfg.warmup_steps, 1)
        return _join(_linear(0.0, base_lr, warm), _linear(base_lr, 0.0, decay), warm)
    if cfg.schedule != "cosine":
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    return _join(_linear(0.0, base_lr, warm), _cosine(base_lr, cfg.total_steps - warm), warm)


def module_label(name: str) -> str:
    """LR group of a parameter, by the first component of its path."""
    return {"vision_backbone": "vision", "projector": "projector", "llm_backbone": "llm",
            "merge_modules": "merge"}.get(name.split(".")[0], "llm")


def freeze_mask(params: Dict[str, nn.Parameter], trainable_modules: str) -> Dict[str, bool]:
    """True = trainable: the name (as a JAX-style path) holds one of the
    comma-separated substrings."""
    subs = [s.strip() for s in trainable_modules.split(",") if s.strip()]
    return {n: any(s in n.replace(".", "/") for s in subs) for n in params}


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class AdamW:
    """AdamW over a fixed {name: parameter} set, with f32 moments."""

    def __init__(self, params: Dict[str, nn.Parameter], cfg: OptimConfig):
        self.params = dict(params)
        self.cfg = cfg
        # the clip's norm of the gradients by name; a mesh sets the one that
        # sums over the shards (parallel/tensor_parallel.py:global_norm)
        self.norm_fn: Optional[Callable[[Dict[str, torch.Tensor]], torch.Tensor]] = None
        self.frozen = set()  # names whose gradients are zeroed (apply_freeze)
        lrs = {"vision": cfg.vision_lr, "projector": cfg.projector_lr, "llm": cfg.llm_lr,
               "merge": cfg.merge_lr}
        self.schedules = {g: lr_schedule(cfg.learning_rate if lr is None else lr, cfg)
                          for g, lr in lrs.items()}
        self.count = 0
        self.mu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in self.params.items()}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> None:
        """One update from f32 gradients keyed like the parameters."""
        cfg = self.cfg
        g = {n: (torch.zeros_like(self.mu[n]) if n in self.frozen else grads[n].float())
             for n in self.params}
        if cfg.max_grad_norm and cfg.max_grad_norm > 0:
            norm = self.norm_fn(g) if self.norm_fn is not None else global_norm(g.values())
            if not bool(norm < cfg.max_grad_norm):
                g = {n: t / norm * cfg.max_grad_norm for n, t in g.items()}
        self.count += 1
        # bias corrections in f32, as optax takes them
        c1, c2 = (float(1 - torch.tensor(b, dtype=torch.float32) ** self.count)
                  for b in (cfg.b1, cfg.b2))
        lrs = {grp: sched(self.count - 1) for grp, sched in self.schedules.items()}
        for n, p in self.params.items():
            mu, nu = self.mu[n], self.nu[n]
            mu.mul_(cfg.b1).add_(g[n], alpha=1 - cfg.b1)
            nu.mul_(cfg.b2).add_(g[n].square(), alpha=1 - cfg.b2)
            u = (mu / c1) / ((nu / c2).sqrt() + cfg.eps)
            if p.ndim >= 2:
                u = u + cfg.weight_decay * p.float()
            u = u * lrs[module_label(n)]
            p.copy_((p.float() - u).to(p.dtype))

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: Dict) -> None:
        if set(state["mu"]) != set(self.params):
            raise ValueError("optimizer state holds other parameters")
        self.count = int(state["count"])
        for n in self.params:
            self.mu[n].copy_(state["mu"][n])
            self.nu[n].copy_(state["nu"][n])


def build_optimizer(cfg: OptimConfig, params: Dict[str, nn.Parameter]) -> AdamW:
    """AdamW with per-module LR groups and global-norm clipping."""
    return AdamW(params, cfg)


def apply_freeze(opt: AdamW, trainable_modules: Optional[str]) -> AdamW:
    """Zero the gradients of the parameters `trainable_modules` does not name
    (optax's masked set_to_zero in front of the chain). They still take
    weight decay, as in the JAX package."""
    if trainable_modules:
        mask = freeze_mask(opt.params, trainable_modules)
        opt.frozen = {n for n, keep in mask.items() if not keep}
    return opt
