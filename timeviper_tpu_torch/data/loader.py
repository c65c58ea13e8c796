"""Batch assembly and device feeding (counterpart of
timeviper_tpu/data/loader.py).

`collate` stacks rows that share one fusion layout, the packed training
regime of fixed pack size and frame budget; rows with different layouts go
to `collate_hetero`, which pads them to the batch's largest dims and ships
each row's plan as data (`gather_idx`, `seq_idx`), its pads in a trailing
fresh segment. `DataLoader` assembles batches on background threads, in the
JAX package's order: one permutation from `seed + epoch`, drop-last, and a
disjoint stride of it for each of `process_count` processes (0 of 1 unless
given). `prefetch_to_device` starts the next batches' host-to-device copies
while the current step runs.
"""

from __future__ import annotations

import collections
import queue
import threading
import warnings
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Iterator, List, Sequence, Tuple, Union

import numpy as np
import torch

from timeviper_tpu_torch.data.fusion import (
    IGNORE_INDEX,
    FusionPlan,
    HeteroPlan,
    fuse_labels,
    pad_row_plan,
    plan_fusion,
)


def pad_to(x: np.ndarray, length: int, value) -> np.ndarray:
    if x.shape[0] >= length:
        return x[:length]
    pad = [(0, length - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad, constant_values=value)


@dataclass
class CollatedBatch:
    batch: Dict[str, np.ndarray]
    plan: Union[FusionPlan, HeteroPlan]


def collate(
    items: Sequence[Dict[str, Any]],
    image_token_id: int,
    tokens_per_frame: int,
    pad_token_id: int = 0,
) -> CollatedBatch:
    """Stack dataset items ({"input_ids", "labels", "pixels"?,
    "txt_seq_lens"?}) into a batch: rows that share one fusion layout with
    that plan, others through `collate_hetero`."""
    plans = [plan_fusion(it["input_ids"], image_token_id, tokens_per_frame,
                         it.get("txt_seq_lens")) for it in items]
    p0 = plans[0]
    if not all(p.text_len == p0.text_len and np.array_equal(p.gather_idx, p0.gather_idx)
               for p in plans[1:]):
        return collate_hetero(items, plans, image_token_id, pad_token_id)
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


def collate_hetero(
    items: Sequence[Dict[str, Any]],
    plans: Sequence[FusionPlan],
    image_token_id: int,
    pad_token_id: int = 0,
) -> CollatedBatch:
    """Pad rows with different fusion layouts to the batch's largest text,
    fused and visual lengths and frame count (timeviper_tpu/data/
    loader.py:95). Each row's `gather_idx` / `seq_idx` travel in the batch;
    its pads sit in a fresh trailing segment (the SSD state resets there and
    attention masks it off) with IGNORE labels, and its missing frames are
    zeros whose tokens no gather reads."""
    text_len = max(p.text_len for p in plans)
    fused_len = max(p.fused_len for p in plans)
    num_visual = max(p.num_visual for p in plans)
    frame_counts = [it["pixels"].shape[0] if it.get("pixels") is not None else 0
                    for it in items]
    num_frames = max(frame_counts)
    frame_shape = next((tuple(it["pixels"].shape[1:]) for it, fc in zip(items, frame_counts)
                        if fc), None)
    ids, labels, gathers, seqs, pixels = [], [], [], [], []
    for it, plan, fc in zip(items, plans, frame_counts):
        row = np.asarray(it["input_ids"])
        ids.append(pad_to(np.where(row == image_token_id, pad_token_id, row).astype(np.int32),
                          text_len, pad_token_id))
        labels.append(pad_to(fuse_labels(plan, it["labels"]), fused_len, IGNORE_INDEX))
        g, s = pad_row_plan(plan, text_len, fused_len, num_visual)
        gathers.append(g)
        seqs.append(s)
        if num_frames:
            px = it.get("pixels")
            if px is None or fc == 0:
                px = np.zeros((num_frames,) + frame_shape, np.float32)
            elif fc < num_frames:
                px = np.concatenate([px, np.zeros((num_frames - fc,) + frame_shape, px.dtype)])
            pixels.append(px)
    batch = {"input_ids": np.stack(ids), "labels": np.stack(labels).astype(np.int32),
             "gather_idx": np.stack(gathers), "seq_idx": np.stack(seqs)}
    if num_frames:
        batch["pixels"] = np.stack(pixels)
    return CollatedBatch(batch=batch, plan=HeteroPlan(
        fused_len=fused_len, text_len=text_len, num_visual=num_visual, num_frames=num_frames))


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


class DataLoader:
    """Collated batches assembled on `num_workers` threads, `prefetch` ahead
    (timeviper_tpu/data/loader.py:181): video decode and preprocessing run
    in native code that releases the interpreter lock. Each epoch permutes
    the items with numpy's generator seeded `seed + epoch` (no shuffle: in
    order), truncates (drop_last) or wraps the permutation to a multiple of
    `process_count * batch_size`, and process `process_index` takes every
    `process_count`-th item of it. Batches come out in index order, whatever
    the workers' speeds: every rank of a mesh, which reads the same data and
    takes its rows, sees the same batch at the same step."""

    def __init__(self, dataset, batch_size: int, image_token_id: int, tokens_per_frame: int,
                 pad_token_id: int = 0, shuffle: bool = True, seed: int = 0,
                 num_workers: int = 2, prefetch: int = 2, drop_last: bool = True,
                 process_index: int = 0, process_count: int = 1) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.image_token_id = image_token_id
        self.tokens_per_frame = tokens_per_frame
        self.pad_token_id = pad_token_id
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = max(process_count, 1)

    def _per_process_count(self) -> int:
        """Items each process yields an epoch, the same on every process."""
        n, pc = len(self.dataset), self.process_count
        if self.drop_last:
            return (n // (pc * self.batch_size)) * self.batch_size
        return -(-n // pc)

    def __len__(self) -> int:
        per = self._per_process_count()
        return per // self.batch_size if self.drop_last else -(-per // self.batch_size)

    def _index_batches(self, epoch: int) -> List[List[int]]:
        idxs = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idxs)
        total = self._per_process_count() * self.process_count
        if total > len(idxs):  # wrap, so every process yields as many batches
            idxs = np.concatenate([idxs, idxs[: total - len(idxs)]])
        else:
            idxs = idxs[:total]
        if self.process_count > 1:
            idxs = idxs[self.process_index::self.process_count]
        batches = [idxs[i: i + self.batch_size].tolist()
                   for i in range(0, len(idxs), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if not batches:
            warnings.warn(f"DataLoader yields 0 batches: {len(self.dataset)} items / "
                          f"{self.process_count} processes < batch_size={self.batch_size} "
                          f"with drop_last={self.drop_last}")
        return batches

    def epoch(self, epoch: int = 0) -> Iterator[CollatedBatch]:
        """The epoch's batches, in index order: worker w collates batches w,
        w + num_workers, ... into its own queue, and the queues are read in
        turn. A worker's exception is raised here, in the consumer, at its
        batch; closing the iterator early stops the workers."""
        batches = self._index_batches(epoch)
        nw = max(min(self.num_workers, len(batches)), 1)
        per = max(-(-self.prefetch // nw), 1)
        queues = [queue.Queue(maxsize=per) for _ in range(nw)]
        stop = threading.Event()

        def put(q, entry) -> bool:
            while not stop.is_set():
                try:
                    q.put(entry, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker(worker_id: int) -> None:
            q = queues[worker_id]
            try:
                for bi in range(worker_id, len(batches), nw):
                    if stop.is_set():
                        return
                    items = [self.dataset[i] for i in batches[bi]]
                    if not put(q, (collate(items, self.image_token_id, self.tokens_per_frame,
                                           self.pad_token_id), None)):
                        return
            except Exception as e:  # noqa: BLE001 - handed to the consumer, raised there
                put(q, (None, e))

        threads = [threading.Thread(target=worker, args=(w,), daemon=True) for w in range(nw)]
        for th in threads:
            th.start()
        try:
            for bi in range(len(batches)):
                cb, err = queues[bi % nw].get()
                if err is not None:
                    raise err
                yield cb
        finally:
            stop.set()
            for th in threads:
                th.join(timeout=5.0)
