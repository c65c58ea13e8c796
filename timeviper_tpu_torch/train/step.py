"""Training step: loss, gradients, optimizer update (counterpart of
timeviper_tpu/train/step.py).

The JAX package differentiates a pure function of the parameter pytree under
one jit; here the step differentiates the model's loss with respect to the
optimizer's parameters with torch.autograd. One set of functions serves the
full and the LoRA step: what differs is the parameter set the optimizer
holds (`trainable_params`). Gradients are cast to f32 before they are summed
or reach Adam, as the JAX steps cast theirs. Gradient accumulation splits
the step into `grad_step`, `accumulate_grads` and `apply_step`, so each
microbatch may have its own fusion plan. `use_pdrop` runs the config's pdrop
stages in the loss (models/vlm.py:vlm_loss), as the JAX step builders take
it (step.py:42-49).

On a mesh (`layout`, parallel/tensor_parallel.py:MeshLayout) each rank
takes its rows of the global batch; its objective is the mean of its rows'
losses over the data axis's size, so that the data ranks' objectives sum to
the JAX package's mean over the global batch. The FSDP leaves read whole
where the forward uses them and their gradients come back reduce-scattered
(parallel/tensor_parallel.py:FSDPGather); the other gradients are psummed
over `data` (`sync_grads`), the metrics' loss and token count are psummed,
and the norms sum the shards.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from timeviper_tpu_torch.data.fusion import FusionPlan
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch, vlm_loss
from timeviper_tpu_torch.parallel.sharding import psum
from timeviper_tpu_torch.parallel.tensor_parallel import MeshLayout, sync_grads
from timeviper_tpu_torch.parallel.tensor_parallel import global_norm as mesh_norm
from timeviper_tpu_torch.train.lora import trainable_lora_state
from timeviper_tpu_torch.train.optim import AdamW, freeze_mask, global_norm

MODULES = ("vision_backbone", "projector", "llm_backbone", "merge_modules")


def trainable_params(model: nn.Module, lora: bool,
                     trainable_modules: Optional[str] = None) -> Dict[str, nn.Parameter]:
    """The optimizer's parameter set, with requires_grad set to match.

    LoRA: the factors plus the `trainable_modules` matches; every other
    parameter is frozen. Full: every parameter; with `trainable_modules` the
    others stay in the set (they take weight decay, as under the JAX
    package's apply_freeze) but no gradient is computed for them."""
    if lora:
        params = trainable_lora_state(model, trainable_modules)
        if not any(".lora_" in n for n in params):
            raise ValueError("a LoRA step needs add_lora'd parameters")
        train = set(params)
    else:
        params = dict(model.named_parameters())
        train = (set(params) if not trainable_modules else
                 {n for n, keep in freeze_mask(params, trainable_modules).items() if keep})
    for n, p in model.named_parameters():
        p.requires_grad_(n in train)
    return params


def grad_metrics(loss: torch.Tensor, aux: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], layout: Optional[MeshLayout] = None
                 ) -> Dict[str, torch.Tensor]:
    metrics = {"loss": loss.detach(), "grad_norm": mesh_norm(layout, grads),
               "n_tokens": aux["n_tokens"]}
    for mod in MODULES:
        sub = {n: g for n, g in grads.items() if n.split(".")[0] == mod}
        if sub:
            metrics[f"grad_norm/{mod}"] = mesh_norm(layout, sub)
    return metrics


def grad_step(model: TimeViperVLM, arch: VLMArch, params: Dict[str, nn.Parameter],
              batch: Dict[str, torch.Tensor], plan: FusionPlan, remat=True,
              use_pdrop: bool = False, layout: Optional[MeshLayout] = None
              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(metrics, f32 gradients of the mean row loss) for `params`; a
    parameter that takes no gradient gets zeros. With a `layout` the batch
    is this rank's rows and `arch` the local one (module doc)."""
    nd = layout.nd if layout is not None else 1
    live = [n for n, p in params.items() if p.requires_grad]
    loss, aux = vlm_loss(model, arch, batch, plan, remat=remat, use_pdrop=use_pdrop)
    if nd > 1:
        loss = loss / nd
    got = torch.autograd.grad(loss, [params[n] for n in live], allow_unused=True)
    grads = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
    for n, g in zip(live, got):
        if g is not None:
            grads[n] = g.float()
    if nd > 1:
        grads = sync_grads(layout, grads)
        loss = psum(loss.detach(), layout.mesh, "data")
        aux = {**aux, "n_tokens": psum(aux["n_tokens"], layout.mesh, "data")}
    return grad_metrics(loss, aux, grads, layout), grads


def accumulate_grads(acc: Optional[Dict[str, torch.Tensor]],
                     grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Add a microbatch's gradients into the accumulator (in place)."""
    if acc is None:
        return grads
    for n, g in grads.items():
        acc[n].add_(g)
    return acc


def apply_step(opt: AdamW, grads: Dict[str, torch.Tensor], denom: float
               ) -> Dict[str, torch.Tensor]:
    """One update from accumulated gradients (their mean over `denom`
    microbatches)."""
    grads = {n: g / denom for n, g in grads.items()}
    opt.update(grads)
    norm = opt.norm_fn(grads) if opt.norm_fn is not None else global_norm(grads.values())
    return {"grad_norm": norm}


def train_step(model: TimeViperVLM, arch: VLMArch, opt: AdamW,
               batch: Dict[str, Any], plan: FusionPlan, remat=True, use_pdrop: bool = False,
               layout: Optional[MeshLayout] = None) -> Dict[str, torch.Tensor]:
    """Forward, backward and one update of `opt`'s parameters."""
    metrics, grads = grad_step(model, arch, opt.params, batch, plan, remat, use_pdrop, layout)
    opt.update(grads)
    return metrics
