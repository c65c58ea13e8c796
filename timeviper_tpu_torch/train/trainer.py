"""Training loop: steps, logging, checkpoint / resume and an emergency save
(counterpart of timeviper_tpu/train/trainer.py), on one device or a mesh.

With `data_parallel` or `model_parallel` above 1 (or a `mesh` given) the
Trainer builds a (data, 1, model) mesh from the process group
(parallel/sharding.py:make_mesh) and cuts the model to this rank's shard
(parallel/tensor_parallel.py:shard_model; `fsdp_params`, on by default as in
the JAX package, keeps each leaf whose spec names `data` as its data
shard). Every rank is handed the same global batches and takes its
contiguous rows (JAX P("data")); the step runs at the local head counts and
AdamW updates the local shards. Checkpoints and `full_state_dict` hold whole
tensors, gathered and written by rank 0: a run saved on a mesh resumes on
one device or on the same mesh. On a mesh a failing rank cannot gather the
others' shards, so there is no emergency save there.

`remat` (True or "full", or False) checkpoints each block, keeping what
`remat_policy` names ("full", "scan", "dots", "dots_scan";
models/remat.py), as the JAX TrainerConfig takes them (trainer.py:59-64).
With `lora=True` the optimizer holds the LoRA factors plus the
`trainable_modules` matches and every other parameter is frozen; otherwise
it holds every parameter and `trainable_modules` zeroes the others'
gradients. `use_pdrop` trains with the config's pdrop stages; the TransV merge modules train where
`trainable_modules` names them ("projector,merge" with LoRA, as the JAX
package's stage-2 recipe, docs/USAGE.md:26-37, unfreezes them), take the
`merge_lr` group and ride in the checkpoints with the other trained
parameters.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Union

import torch
import torch.distributed as dist

from timeviper_tpu_torch.data.loader import CollatedBatch, prefetch_to_device, to_device
from timeviper_tpu_torch.device import resolve_device
from timeviper_tpu_torch.models.remat import remat_policy
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch
from timeviper_tpu_torch.parallel.sharding import axis_size, make_mesh
from timeviper_tpu_torch.parallel.tensor_parallel import global_norm, shard_model, split_rows
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
    # mesh
    data_parallel: int = 1
    model_parallel: int = 1
    fsdp_params: bool = True
    remat: Union[bool, str] = True
    remat_policy: str = "full"  # "full" | "scan" | "dots" | "dots_scan"
    use_pdrop: bool = False
    trainable_modules: Optional[str] = None  # comma substrings; None = all
    lora: bool = False
    resume: bool = True
    grad_accum_steps: int = 1  # microbatches per optimizer update


class Trainer:
    """`model` is whole (with its LoRA factors planted); on a mesh the
    Trainer shards it in place. `mesh` (parallel/sharding.py:make_mesh) is
    built from the config's data_parallel and model_parallel when not
    given."""

    def __init__(self, arch: VLMArch, model: TimeViperVLM, optim_cfg: OptimConfig,
                 trainer_cfg: TrainerConfig, device=None, mesh=None) -> None:
        cfg = trainer_cfg
        if cfg.remat not in (False, True, "full"):
            raise ValueError(f"remat is True, 'full' or False, not {cfg.remat!r}; "
                             "the policy is remat_policy")
        self.remat = remat_policy(cfg.remat_policy) if cfg.remat else False
        self.arch, self.cfg = arch, cfg
        if mesh is None and (cfg.data_parallel > 1 or cfg.model_parallel > 1):
            mesh = make_mesh(data=cfg.data_parallel, model=cfg.model_parallel)
        self.mesh, self.layout, self.step_arch = mesh, None, arch
        if mesh is not None:
            got = (axis_size(mesh, "data"), axis_size(mesh, "seq"), axis_size(mesh, "model"))
            if got != (cfg.data_parallel, 1, cfg.model_parallel):
                raise ValueError(f"a (data, seq, model) mesh of {got} for data_parallel "
                                 f"{cfg.data_parallel} and model_parallel {cfg.model_parallel}")
            self.layout = shard_model(model, arch, mesh, cfg.fsdp_params)
            self.step_arch = self.layout.arch
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.opt = build_optimizer(optim_cfg, trainable_params(
            self.model, cfg.lora, cfg.trainable_modules))
        if self.layout is not None:
            self.opt.norm_fn = lambda g: global_norm(self.layout, g)
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

    @property
    def writer(self) -> bool:
        """Whether this process writes the run's files (rank 0 of a mesh)."""
        return self.mesh is None or dist.get_rank() == 0

    def _whole(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.layout is None:
            return {n: t.detach() for n, t in tensors.items()}
        return self.layout.full_state(tensors)

    def state(self) -> Dict[str, Any]:
        """The optimizer's parameters and moments as whole tensors (on a mesh
        a collective: every rank calls it)."""
        opt = self.opt.state_dict()
        return {"params": self._whole(self.opt.params),
                "optimizer": {"count": opt["count"], "mu": self._whole(opt["mu"]),
                              "nu": self._whole(opt["nu"])},
                "step": self.step}

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state dict with whole tensors (a collective on a mesh)."""
        return self._whole(self.model.state_dict())

    @torch.no_grad()
    def load_state(self, state: Dict[str, Any]) -> None:
        """Load a state of whole tensors (`state`); on a mesh each rank takes
        its shard."""
        if set(state["params"]) != set(self.opt.params):
            raise ValueError("the checkpoint holds other parameters")
        local = ((lambda n, t: t) if self.layout is None else self.layout.local)
        for n, p in self.opt.params.items():
            p.copy_(local(n, state["params"][n]))
        opt = state["optimizer"]
        self.opt.load_state_dict({"count": opt["count"],
                                  "mu": {n: local(n, t) for n, t in opt["mu"].items()},
                                  "nu": {n: local(n, t) for n, t in opt["nu"].items()}})
        self.step = int(state["step"])

    def save(self, keep: Optional[int] = None) -> str:
        state = self.state()
        keep = self.cfg.keep_checkpoints if keep is None else keep
        path = (save_checkpoint(self.cfg.run_dir, self.step, state, keep=keep) if self.writer
                else None)
        if self.mesh is not None:
            dist.barrier()
        return path or str(Path(self.cfg.run_dir).resolve() / f"checkpoint-{self.step}")

    # -- steps ------------------------------------------------------------

    def train_step(self, cb: CollatedBatch) -> Dict[str, torch.Tensor]:
        return self._device_step(to_device(cb.batch, self.device), cb.plan)

    def _rows(self, batch):
        return batch if self.mesh is None else split_rows(batch, self.mesh)

    def _device_step(self, batch, plan) -> Dict[str, torch.Tensor]:
        metrics = train_step(self.model, self.step_arch, self.opt, self._rows(batch), plan,
                             remat=self.remat, use_pdrop=self.cfg.use_pdrop,
                             layout=self.layout)
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
                    metrics, grads = grad_step(self.model, self.step_arch, self.opt.params,
                                               self._rows(batch), plan, remat=self.remat,
                                               use_pdrop=cfg.use_pdrop, layout=self.layout)
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
            if self.mesh is not None:
                log.error("exception at step %d on a mesh: no emergency save", self.step)
                raise
            log.error("exception at step %d; emergency save", self.step)
            self.save(keep=cfg.keep_checkpoints + 1)
            raise
