"""The device mesh and the collectives of its `seq` axis (counterpart of
timeviper_tpu/parallel/sharding.py:34-53, `make_mesh`).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with the JAX
package's axes in its order, ("data", "seq", "model"), one rank a device.
JAX places collectives inside one program across devices (shard_map); here
every rank runs the same Python code on its own span and calls the
collectives below, named after the `jax.lax` calls they stand for:
`axis_index`, `axis_size`, `all_gather` (stacked, or tiled along a dim),
`ppermute` (a shift along the axis, `batch_isend_irecv`) and `psum`.

Transport: NCCL takes the card's tensors as they are. Gloo's send and recv
take host tensors only, so on a gloo group every wrapper copies a CUDA
tensor to the host and the result back (one rule for every collective);
bf16 travels as its bits in a float16 tensor and is summed in float32. This is a
transport, not a fallback: the arithmetic stays where the tensors are.
A collective is called even on an axis of one rank. `sent_bytes` counts
the bytes this rank has handed to the collectives (its part of each
all_gather and psum, each ppermute send).

The tensor-parallel and FSDP rules of the JAX file (:56-175) belong to the
next parallelism slice; a `model` axis above 1 raises.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

MESH_AXES = ("data", "seq", "model")
sent_bytes = 0
NOT_YET = ("a mesh with a model axis above 1 (tensor parallelism) comes with the training "
           "half of parallelism: the TP / FSDP rules of parallel/sharding.py (ROADMAP Queue 1 "
           "item 3)")


def make_mesh(data: int = 1, model: int = 1, seq: int = 1):
    """A (data, seq, model) mesh over the first data * seq * model ranks of
    the initialized process group: a "cuda" mesh on an NCCL group, a "cpu"
    one on a gloo group (gloo ranks may share a card)."""
    from torch.distributed.device_mesh import init_device_mesh

    if model > 1:
        raise NotImplementedError(NOT_YET)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: utils/dist.py:"
                           "initialize_distributed or torch.distributed.init_process_group")
    n = data * seq * model
    if dist.get_world_size() < n:
        raise ValueError(f"a mesh of {n} ranks in a group of {dist.get_world_size()}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, seq, model), mesh_dim_names=MESH_AXES)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def refuse_model_axis(mesh) -> None:
    """Raise NotImplementedError for a mesh with a model axis above 1."""
    if mesh is not None and axis_size(mesh, "model") > 1:
        raise NotImplementedError(NOT_YET)


def axis_index(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def _group(mesh, axis: str):
    return mesh.get_group(axis)


def _to_wire(x: torch.Tensor, group) -> torch.Tensor:
    """The tensor a collective of `group` sends: contiguous, on the host for
    gloo, bf16 as its bits in a float16 tensor there (gloo moves half
    precision; only psum does arithmetic, and it sends float32)."""
    x = x.contiguous()
    if dist.get_backend(group) == "gloo":
        x = x.cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.float16)
    return x


def _count(w: torch.Tensor) -> None:
    global sent_bytes
    sent_bytes += w.numel() * w.element_size()


def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if w.dtype != like.dtype:
        w = w.view(like.dtype)
    return w.to(like.device)


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0, tiled: bool = False
               ) -> torch.Tensor:
    """Every rank's x along the axis: stacked in a new `dim`, or with `tiled`
    concatenated along `dim` (jax.lax.all_gather)."""
    group = _group(mesh, axis)
    w = _to_wire(x, group)
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    _count(w)
    dist.all_gather(parts, w, group=group)
    parts = [_from_wire(p, x) for p in parts]
    return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)


def ppermute(x: torch.Tensor, mesh, axis: str, perm: Sequence[Tuple[int, int]]
             ) -> torch.Tensor:
    """Send x from axis index i to j for each (i, j) in perm; a rank that
    receives nothing gets zeros (jax.lax.ppermute)."""
    group = _group(mesh, axis)
    ranks = dist.get_process_group_ranks(group)
    me = axis_index(mesh, axis)
    w = _to_wire(x, group)
    out = torch.zeros_like(w)
    ops: List[dist.P2POp] = []
    for src, dst in perm:
        if src == me:
            _count(w)
            ops.append(dist.P2POp(dist.isend, w, ranks[dst], group))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[src], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _from_wire(out, x)


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of x over the axis (jax.lax.psum); low-precision sums run in
    float32 on gloo."""
    group = _group(mesh, axis)
    low = x.dtype in (torch.bfloat16, torch.float16) and dist.get_backend(group) == "gloo"
    w = x.float() if low else x
    w = _to_wire(w.clone(), group)
    _count(w)
    dist.all_reduce(w, group=group)
    return w.to(x.device, x.dtype)
