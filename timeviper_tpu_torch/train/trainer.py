"""Training loop: steps, logging, checkpoint / resume and an emergency save
(counterpart of timeviper_tpu/train/trainer.py), on one device.

The JAX trainer shards its step over a mesh; this one runs on one card (or
on the CPU when asked): the mesh fields of TrainerConfig are accepted and
must be 1. `remat` is True / "full" (one recompute per block) or False; the
JAX package's other remat policies and pdrop training are not ported. With
`lora=True` the optimizer holds the LoRA factors plus the
`trainable_modules` matches and every other parameter is frozen; otherwise
it holds every parameter and `trainable_modules` zeroes the others'
gradients.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Union

import torch

from timeviper_tpu_torch.data.loader import CollatedBatch, prefetch_to_device, to_device
from timeviper_tpu_torch.device import resolve_device
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch
from timeviper_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from timeviper_tpu_torch.train.optim import OptimConfig, apply_freeze, build_optimizer
from timeviper_tpu_torch.train.step import (
    accumulate_grads,
    apply_step,
    grad_step,
    train_step,
    trainable_params,
)

log = logging.getLogger(__name__)


@dataclass
class TrainerConfig:
    run_dir: str = "runs/default"
    max_steps: int = 1000
    log_every: int = 10
    save_every: int = 500
    keep_checkpoints: int = 3
    # mesh: one device here
    data_parallel: int = 1
    model_parallel: int = 1
    remat: Union[bool, str] = True
    trainable_modules: Optional[str] = None  # comma substrings; None = all
    lora: bool = False
    resume: bool = True
    grad_accum_steps: int = 1  # microbatches per optimizer update


class Trainer:
    def __init__(self, arch: VLMArch, model: TimeViperVLM, optim_cfg: OptimConfig,
                 trainer_cfg: TrainerConfig, device=None) -> None:
        cfg = trainer_cfg
        if cfg.data_parallel != 1 or cfg.model_parallel != 1:
            raise NotImplementedError("the port trains on one device: data_parallel and "
                                      "model_parallel must be 1")
        if cfg.remat not in (False, True, "full"):
            raise NotImplementedError(f"remat policy {cfg.remat!r} is not ported; 'full' is")
        self.arch, self.cfg = arch, cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.opt = build_optimizer(optim_cfg, trainable_params(
            self.model, cfg.lora, cfg.trainable_modules))
        if not cfg.lora:
            apply_freeze(self.opt, cfg.trainable_modules)
        self.step = 0
        # one entry per step (microbatch) logged: its metrics, the update count
        # at the log, seconds per step over the interval
        self.history: List[Dict[str, float]] = []
        if cfg.resume:
            ckpt = latest_checkpoint(cfg.run_dir)
            if ckpt:
                log.info("resuming from %s", ckpt)
                self.load_state(restore_checkpoint(ckpt, map_location=self.device))

    # -- state ------------------------------------------------------------

    def state(self) -> Dict[str, Any]:
        return {"params": {n: p.detach() for n, p in self.opt.params.items()},
                "optimizer": self.opt.state_dict(), "step": self.step}

    @torch.no_grad()
    def load_state(self, state: Dict[str, Any]) -> None:
        if set(state["params"]) != set(self.opt.params):
            raise ValueError("the checkpoint holds other parameters")
        for n, p in self.opt.params.items():
            p.copy_(state["params"][n])
        self.opt.load_state_dict(state["optimizer"])
        self.step = int(state["step"])

    def save(self, keep: Optional[int] = None) -> str:
        return save_checkpoint(self.cfg.run_dir, self.step, self.state(),
                               keep=self.cfg.keep_checkpoints if keep is None else keep)

    # -- steps ------------------------------------------------------------

    def train_step(self, cb: CollatedBatch) -> Dict[str, torch.Tensor]:
        return self._device_step(to_device(cb.batch, self.device), cb.plan)

    def _device_step(self, batch, plan) -> Dict[str, torch.Tensor]:
        metrics = train_step(self.model, self.arch, self.opt, batch, plan, remat=self.cfg.remat)
        self.step += 1
        return metrics

    def train(self, batches: Iterable[CollatedBatch]) -> None:
        """Run until `max_steps` updates or the batches end; a leftover run of
        microbatches still makes one update. Any exception saves a checkpoint
        first and is raised again."""
        cfg = self.cfg
        A = max(1, cfg.grad_accum_steps)
        pending: List[Dict[str, torch.Tensor]] = []
        grads_acc, n_micro = None, 0
        t_log = time.perf_counter()

        def flush_log():
            nonlocal pending, t_log
            if not pending:
                return
            vals = [{k: float(v) for k, v in m.items()} for m in pending]
            seconds = (time.perf_counter() - t_log) / len(vals)
            extra = {"step": self.step, "seconds": seconds}
            if self.device.type == "cuda":
                extra["max_memory_gib"] = torch.cuda.max_memory_allocated(self.device) / 2**30
            self.history.extend({**v, **extra} for v in vals)
            loss = sum(v["loss"] for v in vals) / len(vals)
            gnorm = sum(v["grad_norm"] for v in vals) / len(vals)
            log.info("step %d | loss %.4f | gnorm %.3f | %.2fs/it", self.step, loss, gnorm,
                     seconds)
            pending, t_log = [], time.perf_counter()

        try:
            for batch, plan in prefetch_to_device(batches, self.device):
                if self.step >= cfg.max_steps:
                    break
                if A == 1:
                    pending.append(self._device_step(batch, plan))
                else:
                    metrics, grads = grad_step(self.model, self.arch, self.opt.params, batch,
                                               plan, remat=cfg.remat)
                    grads_acc = accumulate_grads(grads_acc, grads)
                    pending.append(metrics)
                    n_micro += 1
                    if n_micro < A:
                        continue
                    apply_step(self.opt, grads_acc, float(A))
                    grads_acc, n_micro = None, 0
                    self.step += 1
                if self.step % cfg.log_every == 0:
                    flush_log()
                if self.step % cfg.save_every == 0:
                    log.info("saved %s", self.save())
            if grads_acc is not None and n_micro:
                apply_step(self.opt, grads_acc, float(n_micro))
                self.step += 1
            flush_log()
        except Exception:
            log.error("exception at step %d; emergency save", self.step)
            self.save(keep=cfg.keep_checkpoints + 1)
            raise
