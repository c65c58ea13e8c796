"""The device mesh, its collectives, and the parameter sharding rules
(counterpart of timeviper_tpu/parallel/sharding.py).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with the JAX
package's axes in its order, ("data", "seq", "model"), one rank a device.
JAX lays out shardings and lets GSPMD place the collectives; here every
rank runs the same Python code on its own shard and calls the collectives
below, named after the `jax.lax` calls they stand for: `axis_index`,
`axis_size`, `all_gather` (stacked, or tiled along a dim), `ppermute` (a
shift along the axis, `batch_isend_irecv`) and `psum`. Under autograd they
carry the SPMD transposes: the gradient of an all_gather is the psum of the
cotangent sliced to this rank, of a ppermute the reverse shift, of a psum a
psum (each rank's objective counts, as in shard_map).

Tensor parallelism over `model` uses Megatron's four region operators, for
a value that every rank of the axis holds whole and differentiates once:

| operator            | forward    | backward   |
| `copy_to_model`     | identity   | psum       |
| `reduce_from_model` | psum       | identity   |
| `gather_from_model` | all_gather | slice      |
| `scatter_to_model`  | slice      | all_gather |

FSDP gathers a data-sharded leaf with `all_gather` over `data`, whose
backward is then the reduce-scatter of its gradient.

Transport: NCCL takes the card's tensors as they are. Gloo's send and recv
take host tensors only, so on a gloo group every wrapper copies a CUDA
tensor to the host and the result back (one rule for every collective);
bf16 travels as its bits in a float16 tensor, and a bf16 psum on gloo is an
all_gather summed in float32 where the tensors are. This is a transport, not
a fallback: the arithmetic stays where the tensors are.
A collective is called even on an axis of one rank. `sent_bytes` counts
the bytes this rank has handed to the collectives (its part of each
all_gather and psum, each ppermute send).

The rules (:56-185 of the JAX file) are data: (regex over the JAX pytree
path, spec), first match wins, a spec being a tuple of axis names or None
per dimension of the JAX leaf. `parallel/tensor_parallel.py` maps the
port's parameter names onto those paths and applies them.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

MESH_AXES = ("data", "seq", "model")
sent_bytes = 0
LATER = "ROADMAP Queue 1 item 4"
SEQ_X_MODEL = (f"a mesh with both a seq and a model axis above 1 comes with the next "
               f"parallelism slice ({LATER})")

Spec = Tuple[Optional[str], ...]


def make_mesh(data: int = 1, model: int = 1, seq: int = 1):
    """A (data, seq, model) mesh over the first data * seq * model ranks of
    the initialized process group: a "cuda" mesh on an NCCL group, a "cpu"
    one on a gloo group (gloo ranks may share a card)."""
    from torch.distributed.device_mesh import init_device_mesh

    if seq > 1 and model > 1:
        raise NotImplementedError(SEQ_X_MODEL)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: utils/dist.py:"
                           "initialize_distributed or torch.distributed.init_process_group")
    n = data * seq * model
    if dist.get_world_size() < n:
        raise ValueError(f"a mesh of {n} ranks in a group of {dist.get_world_size()}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, seq, model), mesh_dim_names=MESH_AXES)


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def mesh_shape(mesh) -> Dict[str, int]:
    return {a: axis_size(mesh, a) for a in MESH_AXES}


def _group(mesh, axis: str):
    return mesh.get_group(axis)


def _to_wire(x: torch.Tensor, group) -> torch.Tensor:
    """The tensor a collective of `group` sends: contiguous, on the host for
    gloo, bf16 as its bits in a float16 tensor there (gloo moves half
    precision; only psum does arithmetic, `_psum`)."""
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


def _all_gather(x: torch.Tensor, mesh, axis: str, dim: int, tiled: bool) -> torch.Tensor:
    group = _group(mesh, axis)
    w = _to_wire(x, group)
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    _count(w)
    dist.all_gather(parts, w, group=group)
    parts = [_from_wire(p, x) for p in parts]
    return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)


def _ppermute(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
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


def _psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    group = _group(mesh, axis)
    if x.dtype in (torch.bfloat16, torch.float16) and dist.get_backend(group) == "gloo":
        # gloo sums no bf16: every rank's part travels in its own dtype (half
        # the bytes of an f32 all_reduce) and is summed in f32 where x is
        return _all_gather(x, mesh, axis, 0, False).float().sum(0).to(x.dtype)
    w = _to_wire(x.clone(), group)
    _count(w)
    dist.all_reduce(w, group=group)
    return w.to(x.device, x.dtype)


def _my_slice(x: torch.Tensor, mesh, axis: str, dim: int, tiled: bool) -> torch.Tensor:
    """This rank's part of a gathered tensor (the inverse of all_gather)."""
    me = axis_index(mesh, axis)
    if not tiled:
        return x.select(dim, me)
    n = axis_size(mesh, axis)
    size = x.shape[dim] // n
    return x.narrow(dim, me * size, size).contiguous()


def _grad_on(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, tiled):
        ctx.args = mesh, axis, dim, tiled
        return _all_gather(x, mesh, axis, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, tiled = ctx.args
        return _my_slice(_psum(g.contiguous(), mesh, axis), mesh, axis, dim, tiled), \
            None, None, None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.args = mesh, axis, perm
        return _ppermute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, perm = ctx.args
        return _ppermute(g, mesh, axis, [(d, s) for s, d in perm]), None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = mesh, axis
        return _psum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, *ctx.args), None, None


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0, tiled: bool = False
               ) -> torch.Tensor:
    """Every rank's x along the axis: stacked in a new `dim`, or with `tiled`
    concatenated along `dim` (jax.lax.all_gather). Its gradient is the psum
    of the cotangent, sliced to this rank."""
    if _grad_on(x):
        return _AllGather.apply(x, mesh, axis, dim, tiled)
    return _all_gather(x, mesh, axis, dim, tiled)


def ppermute(x: torch.Tensor, mesh, axis: str, perm: Sequence[Tuple[int, int]]
             ) -> torch.Tensor:
    """Send x from axis index i to j for each (i, j) in perm; a rank that
    receives nothing gets zeros (jax.lax.ppermute)."""
    if _grad_on(x):
        return _Ppermute.apply(x, mesh, axis, list(perm))
    return _ppermute(x, mesh, axis, perm)


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of x over the axis (jax.lax.psum); low-precision sums run in
    float32 on gloo."""
    if _grad_on(x):
        return _Psum.apply(x, mesh, axis)
    return _psum(x, mesh, axis)


# ---------------------------------------------------------------------------
# Megatron's region operators over the model axis
# ---------------------------------------------------------------------------

MODEL = "model"


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.mesh, MODEL), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _psum(x, mesh, MODEL)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, tiled):
        ctx.args = mesh, axis, dim, tiled
        return _all_gather(x, mesh, axis, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        return _my_slice(g, *ctx.args), None, None, None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.args = mesh, dim
        return _my_slice(x, mesh, MODEL, dim, True)

    @staticmethod
    def backward(ctx, g):
        mesh, dim = ctx.args
        return _all_gather(g.contiguous(), mesh, MODEL, dim, True), None, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Identity; the backward sums the cotangent over `model` (the input of
    a column-parallel product, or a replicated leaf every rank uses for part
    of a sum)."""
    return _CopyToModel.apply(x, mesh) if _grad_on(x) else x


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The psum of partial sums over `model` (a row-parallel product); the
    backward passes the cotangent through."""
    return _ReduceFromModel.apply(x, mesh) if _grad_on(x) else _psum(x, mesh, MODEL)


def gather_replicated(x: torch.Tensor, mesh, axis: str, dim: int = 0, tiled: bool = False
                      ) -> torch.Tensor:
    """all_gather for a result that every rank of the axis holds whole and
    differentiates once: the backward keeps this rank's part of the
    cotangent, unsummed."""
    if _grad_on(x):
        return _GatherReplicated.apply(x, mesh, axis, dim % (x.dim() + (not tiled)), tiled)
    return _all_gather(x, mesh, axis, dim, tiled)


def gather_from_model(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """The ranks' parts concatenated along `dim` (column-parallel outputs made
    whole); the backward keeps this rank's part of the cotangent."""
    return gather_replicated(x, mesh, MODEL, dim % x.dim(), tiled=True)


def scatter_to_model(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous part along `dim` of a replicated tensor; the
    backward gathers the parts of the cotangent."""
    dim = dim % x.dim()
    if _grad_on(x):
        return _ScatterToModel.apply(x, mesh, dim)
    return _my_slice(x, mesh, MODEL, dim, True)


# ---------------------------------------------------------------------------
# Parameter sharding rules (timeviper_tpu/parallel/sharding.py:56-185)
# ---------------------------------------------------------------------------
# Paths look like "llm_backbone/layers/3/mixer/in_proj/gate/kernel".


def _llm_rules(prefix: str, fsdp: bool) -> Tuple[Tuple[str, Spec], ...]:
    # second dim of a (in, out) kernel that shards on "model" can optionally
    # shard its other dim on "data" (ZeRO-3/FSDP analog)
    d = "data" if fsdp else None
    return (
        # ---- embeddings / lm_head: shard vocab over model --------------
        (rf"{prefix}/embeddings$", ("model", d)),
        (rf"{prefix}/lm_head/kernel", (d, "model")),
        # ---- Mamba mixer ----------------------------------------------
        (rf"{prefix}/.*mixer/in_proj/(gate|x|B|C|dt)/kernel", (d, "model")),
        (rf"{prefix}/.*mixer/in_proj/.*/bias", ("model",)),
        (rf"{prefix}/.*mixer/conv1d/.*/weight", ("model", None)),
        (rf"{prefix}/.*mixer/conv1d/.*/bias", ("model",)),
        (rf"{prefix}/.*mixer/(A_log|D|dt_bias)", ("model",)),
        (rf"{prefix}/.*mixer/norm/weight", ("model",)),
        (rf"{prefix}/.*mixer/out_proj/kernel", ("model", d)),
        # ---- attention -------------------------------------------------
        (rf"{prefix}/.*(q_proj|k_proj|v_proj)/kernel", (d, "model")),
        (rf"{prefix}/.*(q_proj|k_proj|v_proj)/bias", ("model",)),
        (rf"{prefix}/.*o_proj/kernel", ("model", d)),
        (rf"{prefix}/.*o_proj/bias", ()),
        # ---- MLPs ------------------------------------------------------
        (rf"{prefix}/.*(up_proj|gate_proj)/kernel", (d, "model")),
        (rf"{prefix}/.*(up_proj|gate_proj)/bias", ("model",)),
        (rf"{prefix}/.*down_proj/kernel", ("model", d)),
        (rf"{prefix}/.*down_proj/bias", ()),
        # ---- norms (tiny) ----------------------------------------------
        (rf"{prefix}/.*", ()),
    )


def _vision_rules(prefix: str, fsdp: bool) -> Tuple[Tuple[str, Spec], ...]:
    d = "data" if fsdp else None
    return (
        (rf"{prefix}/.*attn/qkv/kernel", (d, "model")),
        (rf"{prefix}/.*attn/qkv/bias", ("model",)),
        (rf"{prefix}/.*attn/proj/kernel", ("model", d)),
        (rf"{prefix}/.*mlp/fc1/kernel", (d, "model")),
        (rf"{prefix}/.*mlp/fc1/bias", ("model",)),
        (rf"{prefix}/.*mlp/fc2/kernel", ("model", d)),
        (rf"{prefix}/.*", ()),
    )


def vlm_sharding_rules(fsdp_params: bool = False) -> Tuple[Tuple[str, Spec], ...]:
    """TP (+optional FSDP) rules for the whole VLM parameter pytree."""
    return (
        _llm_rules("llm_backbone", fsdp_params)
        + _vision_rules("vision_backbone", fsdp_params)
        + (
            ("projector/fc\\d/kernel", (None, "model")),
            ("projector/.*", ()),
            ("merge_modules/.*(q_proj|k_proj|v_proj)/kernel", (None, "model")),
            ("merge_modules/.*o_proj/kernel", ("model", None)),
            ("merge_modules/.*", ()),
            (".*", ()),
        )
    )


def spec_for_path(path_s: str, rules) -> Spec:
    for pat, spec in rules:
        if re.fullmatch(pat, path_s) or re.match(pat + "$", path_s):
            return spec
    return ()


def shrink_spec(spec: Spec, shape: Sequence[int], sizes: Dict[str, int]) -> Spec:
    """Drop axes that don't exist / don't divide (JAX `_shrink_spec`): one
    entry per dimension of `shape`."""
    parts = (list(spec) + [None] * len(shape))[:len(shape)]
    out = []
    for dim, ax in zip(shape, parts):
        size = sizes.get(ax, 1) if ax is not None else 1
        out.append(ax if ax is not None and size > 1 and dim % size == 0 else None)
    return tuple(out)


# batch tensors shard their leading axis over `data` (`batch_sharding`);
# (B, L, ...) activations shard L over `seq` (`seq_sharding`)
BATCH_SPEC: Spec = ("data",)
SEQ_SPEC: Spec = ("data", "seq")
