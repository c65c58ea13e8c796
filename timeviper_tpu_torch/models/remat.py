"""What a checkpointed block keeps for the backward: the JAX package's remat
policies (timeviper_tpu/models/nano.py:546-560) on torch.utils.checkpoint.

* "full": only the block's input; the whole block runs again in the
  backward.
* "dots": also the outputs of the matrix products without a batch
  dimension (aten.mm, aten.addmm: every linear; JAX's
  dots_with_no_batch_dims_saveable), through a selective-checkpoint
  context; the rest runs again. The SSD and attention kernels are bound with
  ctypes, so the policy never sees them: they run again, as the scan and the
  attention do under JAX's "dots".
* "scan": the block is cut at its sequence mixer into two checkpointed
  parts with the mixer call between them, outside any checkpoint
  (`run_block`): the mixer's output (JAX's named `ssd_out` / `attn_out`) is
  kept and the mixer never runs again. Its autograd node keeps what its own
  backward reads as well: the mixer's inputs, and on the card K1's f32 chunk
  states or K2's output and row log-sum-exp (ROADMAP, divergences).
* "dots_scan": both.

A block's forward is written once, as its parts (pre, mixer, post):
`run_parts` puts them together with no checkpoint (inference, training
without remat) and `run_block` under a policy.

A policy changes only what is kept: the gradients are those of "full".
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

POLICIES = ("full", "scan", "dots", "dots_scan")
SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
# A block cut at its sequence mixer: pre(hidden) -> streams, mixer(*streams)
# -> y, post(hidden, y, *streams) -> the block's output (`run_parts`).
Parts = Tuple[Callable, Optional[Callable], Callable]


def remat_policy(remat) -> Optional[str]:
    """False -> None (no checkpoint); True -> "full"; a policy name -> itself."""
    if remat is False or remat is None:
        return None
    if remat is True:
        return "full"
    if remat not in POLICIES:
        raise ValueError(f"unknown remat_policy {remat!r}; one of {POLICIES}")
    return remat


def _save_products(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def checkpointed(fn: Callable, *args, policy: str):
    """fn(*args) under a non-reentrant checkpoint that keeps what `policy`
    keeps of the products."""
    if policy in ("dots", "dots_scan"):
        return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _save_products))
    return checkpoint(fn, *args, use_reentrant=False)


def run_parts(parts: Parts, hidden: torch.Tensor) -> torch.Tensor:
    """A block's output from its parts (pre, mixer, post), the one place
    they are put together: with s = pre(hidden), post(hidden, mixer(*s), *s);
    a block without a sequence mixer (mixer None: an MLP block) gives
    post(hidden, None)."""
    pre, mixer, post = parts
    streams = pre(hidden)
    return post(hidden, None if mixer is None else mixer(*streams), *streams)


def run_block(parts: Parts, hidden: torch.Tensor, policy: str) -> torch.Tensor:
    """One block's output under `policy`. "full" and "dots" checkpoint the
    whole block; "scan" and "dots_scan" checkpoint pre and post apiece with
    the mixer call between them. A block without a mixer is checkpointed
    whole under every policy, as it is under JAX's names."""
    pre, mixer, post = parts
    if policy in ("full", "dots") or mixer is None:
        return checkpointed(functools.partial(run_parts, parts), hidden, policy=policy)
    streams = checkpointed(pre, hidden, policy=policy)
    return checkpointed(post, hidden, mixer(*streams), *streams, policy=policy)
