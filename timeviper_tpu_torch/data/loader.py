"""Batch assembly and device feeding, host half (counterpart of
timeviper_tpu/data/loader.py: pad_to, CollatedBatch, collate and
prefetch_to_device).

`collate` stacks rows that share one fusion layout, the packed training
regime of fixed pack size and frame budget. Rows with different layouts
(the JAX package's collate_hetero) and the threaded DataLoader over real
datasets are not ported.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Iterator, Sequence, Tuple

import numpy as np
import torch

from timeviper_tpu_torch.data.fusion import FusionPlan, fuse_labels, plan_fusion


def pad_to(x: np.ndarray, length: int, value) -> np.ndarray:
    if x.shape[0] >= length:
        return x[:length]
    pad = [(0, length - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad, constant_values=value)


@dataclass
class CollatedBatch:
    batch: Dict[str, np.ndarray]
    plan: FusionPlan


def collate(
    items: Sequence[Dict[str, Any]],
    image_token_id: int,
    tokens_per_frame: int,
    pad_token_id: int = 0,
) -> CollatedBatch:
    """Stack dataset items ({"input_ids", "labels", "pixels"?,
    "txt_seq_lens"?}) that share one fusion layout into a batch."""
    plans = [plan_fusion(it["input_ids"], image_token_id, tokens_per_frame,
                         it.get("txt_seq_lens")) for it in items]
    p0 = plans[0]
    if not all(p.text_len == p0.text_len and np.array_equal(p.gather_idx, p0.gather_idx)
               for p in plans[1:]):
        raise NotImplementedError("rows with different fusion layouts (heterogeneous "
                                  "batches) are not ported")
    ids, labels, pixels = [], [], []
    for it in items:
        row = np.asarray(it["input_ids"])
        ids.append(np.where(row == image_token_id, pad_token_id, row).astype(np.int32))
        labels.append(fuse_labels(p0, it["labels"]))
        if it.get("pixels") is not None:
            pixels.append(it["pixels"])
    batch = {"input_ids": np.stack(ids), "labels": np.stack(labels).astype(np.int32)}
    if pixels:
        batch["pixels"] = np.stack(pixels)
    return CollatedBatch(batch=batch, plan=p0)


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """Host arrays -> device tensors. For the card the copy starts from pinned
    memory without blocking, so it overlaps the work already queued."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


def prefetch_to_device(batches: Iterable[CollatedBatch], device: torch.device,
                       size: int = 2) -> Iterator[Tuple[Dict[str, torch.Tensor], FusionPlan]]:
    """Yield (device batch, plan) with up to `size` later batches' copies
    already started: the next batch's host-to-device copy overlaps the
    current step."""
    queue: collections.deque = collections.deque()
    for cb in batches:
        queue.append((to_device(cb.batch, device), cb.plan))
        if len(queue) > size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
