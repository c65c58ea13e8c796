"""Tensor and FSDP parallelism of the port's modules: what GSPMD carries out
from the rules of timeviper_tpu/parallel/sharding.py, written out.

`shard_model(model, arch, mesh, fsdp_params)` cuts a whole model, in
place, to this rank's shard and returns a `MeshLayout`. Each parameter's
spec is the JAX rule of its pytree path (`jax_param_paths` inverts
params.py:from_jax_numpy's naming), shrunk as `_shrink_spec` shrinks it and
written in the port's dimension order (a linear's kernel is (out, in) here,
(in, out) in the JAX package).

The model axis. A kind of layer runs tensor-parallel when all its
head-split leaves split, else whole on every rank with no collective (what
GSPMD gives for a leaf `_shrink_spec` leaves replicated):
* nano attention, qwen2 attention and the TransV cross-attentions: q/k/v
  column-parallel by heads (Hq / tp, Hkv / tp), o_proj row-parallel;
* nano's Mamba mixer: the in_proj parts column-parallel, the convs, A_log,
  D, dt_bias and the gated norm by SSD head or group (head h stays in group
  h // (H / G)), out_proj row-parallel;
* the MLPs by the hidden dimension; the embedding table and lm_head by
  vocabulary (a masked lookup then a psum; logits gathered);
* a ViT tower's fused qkv by heads within each of q, k and v, so that the
  local (N, 3 * (H / tp) * hd) rows are the layout K3 reads; InternVideo2's
  attention stays whole (its q and k norms span every head), its MLP splits;
* the projector's layers column-parallel with their outputs gathered, and
  their biases (`projector/.*`: replicated) sliced in the forward.
The kernels run at the local head counts: `MeshLayout.arch` holds the
backbone config at those counts. A row-parallel bias is added once, after
the psum. A replicated leaf used on a sharded product takes `copy_to_model`
(LoRA's a on a column-parallel base, b on a row-parallel one) or
`scatter_to_model` (LoRA's b on a column-parallel base, a on a row-parallel
one), so its gradient is whole on every rank.

The data axis. With `fsdp_params` each leaf whose spec names `data` keeps
its data shard, and its module gathers it where the forward reads it
(`FSDPGather`): under the Trainer's per-block remat a block's leaves are
whole only while the block runs and while its recompute and backward run,
and the gather's backward reduce-scatters their gradients. `sync_grads`
psums the other leaves' gradients over `data`; `global_norm` sums each
leaf's squares over the axes it is sharded on and counts a replicated leaf
once (optax.clip_by_global_norm's norm).

Not on a mesh: int8 linears (W8A8 serving, QLoRA) raise, naming the ROADMAP
item that takes them.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from timeviper_tpu_torch.parallel.sharding import (
    BATCH_SPEC,
    LATER,
    Spec,
    _all_gather,
    all_gather,
    axis_index,
    axis_size,
    copy_to_model,
    gather_from_model,
    mesh_shape,
    psum,
    reduce_from_model,
    scatter_to_model,
    shrink_spec,
    spec_for_path,
    vlm_sharding_rules,
)

INT8_ON_MESH = (f"an int8 base (W8A8 serving, QLoRA) on a mesh with a data or model axis "
                f"above 1 comes with the next parallelism slice ({LATER})")


class TPRole:
    """How a linear runs over the model axis: "col" (its output features
    split) or "row" (its input features split, the partial products psummed);
    `replicated_bias` a whole bias sliced in the forward (column); `gather`
    the column outputs made whole."""

    def __init__(self, mesh, kind: str, replicated_bias: bool = False, gather: bool = False):
        self.mesh, self.kind = mesh, kind
        self.replicated_bias, self.gather = replicated_bias, gather


def tp_linear(mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The forward of a linear (plain or LoRA) under its TPRole `mod.tp`."""
    r = mod.tp
    lora = getattr(mod, "lora_a", None) is not None
    bias = mod.bias
    if r.kind == "col":
        x = copy_to_model(x, r.mesh)
        if bias is not None and r.replicated_bias:
            bias = scatter_to_model(bias, r.mesh, 0)
        y = F.linear(x, mod.weight, bias)
        if lora:
            a = copy_to_model(mod.lora_a, r.mesh).to(x.dtype)
            b = scatter_to_model(mod.lora_b, r.mesh, 1).to(x.dtype)
            y = y + ((x @ a) @ b) * mod.lora_scale.to(y.dtype)
        return gather_from_model(y, r.mesh, -1) if r.gather else y
    y = F.linear(x, mod.weight)
    if lora:
        a = scatter_to_model(mod.lora_a, r.mesh, 0).to(x.dtype)
        b = copy_to_model(mod.lora_b, r.mesh).to(x.dtype)
        y = y + ((x @ a) @ b) * mod.lora_scale.to(y.dtype)
    y = reduce_from_model(y, r.mesh)
    return y if bias is None else y + bias


class TPLinear(nn.Linear):
    """An nn.Linear holding its shard (state_dict names unchanged)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tp_linear(self, x)


class TPEmbedding(nn.Embedding):
    """A vocabulary-parallel embedding table: this rank's rows look up the
    ids they hold, the others give zeros, and the rows are psummed."""

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        mesh, w = self.tp.mesh, self.weight
        V = w.shape[0]
        local = ids - axis_index(mesh, "model") * V
        inside = (local >= 0) & (local < V)
        out = F.embedding(torch.where(inside, local, torch.zeros_like(local)), w)
        out = torch.where(inside[..., None], out, out.new_zeros(()))
        return reduce_from_model(out, mesh)


class FSDPGather:
    """Mixed into the class of a module that holds data-sharded leaves
    (`fsdp_dims`: {leaf: dim}): reading such a leaf as an attribute
    all-gathers it over `data`, so each use in a forward (and again in a
    checkpointed block's recompute) gathers it, and the gather's backward
    reduce-scatters its gradient onto the shard. `named_parameters` and
    `state_dict` hold the shards."""

    def __getattr__(self, name: str):
        value = super().__getattr__(name)
        fsdp = self.__dict__.get("fsdp_dims")
        if fsdp is not None and name in fsdp[1]:
            return all_gather(value, fsdp[0], "data", dim=fsdp[1][name], tiled=True)
        return value


_FSDP_CLASSES: Dict[type, type] = {}


def _gather_on_read(mod: nn.Module, mesh, dims: Dict[str, int]) -> None:
    cls = type(mod)
    if cls not in _FSDP_CLASSES:
        _FSDP_CLASSES[cls] = type(f"FSDP{cls.__name__}", (FSDPGather, cls), {})
    mod.__class__ = _FSDP_CLASSES[cls]
    mod.fsdp_dims = (mesh, dims)


def vocab_logits(hidden: torch.Tensor, w: torch.Tensor, owner: nn.Module) -> torch.Tensor:
    """f32 logits of hidden rows against the (local) vocabulary matrix `w`
    of `owner` (lm_head or the tied embedding table), gathered whole when it
    is split over the model axis."""
    r = getattr(owner, "tp", None)
    h = hidden.float()
    if r is None:
        return F.linear(h, w)
    return gather_from_model(F.linear(copy_to_model(h, r.mesh), w), r.mesh, -1)


# ---------------------------------------------------------------------------
# Names, paths and specs
# ---------------------------------------------------------------------------


def _is_linear(mod: nn.Module) -> bool:
    from timeviper_tpu_torch.train.lora import LoRALinear

    return isinstance(mod, (nn.Linear, LoRALinear))


def jax_param_paths(model: nn.Module) -> Dict[str, Tuple[str, bool]]:
    """{port parameter name: (JAX pytree path, whether the leaf is a linear
    kernel, stored transposed here)}; the inverse of params.py's naming."""
    out = {}
    for prefix, mod in model.named_modules():
        base = prefix.replace(".", "/")
        for leaf, p in mod._parameters.items():
            if p is None:
                continue
            name = f"{prefix}.{leaf}" if prefix else leaf
            if isinstance(mod, nn.Embedding):
                out[name] = (base, False)
            elif _is_linear(mod) and leaf == "weight":
                out[name] = (f"{base}/kernel", True)
            else:
                out[name] = (f"{base}/{leaf}" if base else leaf, False)
    return out


def port_spec(path: str, kernel: bool, shape, sizes: Dict[str, int], fsdp: bool) -> Spec:
    """The shrunk JAX spec of a leaf, in the JAX leaf's dimension order."""
    jshape = tuple(reversed(shape)) if kernel else tuple(shape)
    return shrink_spec(spec_for_path(path, vlm_sharding_rules(fsdp)), jshape, sizes)


def _torch_order(spec: Spec, kernel: bool) -> Spec:
    return tuple(reversed(spec)) if kernel else spec


@dataclasses.dataclass
class LeafLayout:
    path: str  # the JAX pytree path
    spec: Spec  # the shrunk JAX spec, in the port's dimension order
    model_dim: Optional[int] = None  # the dim split over `model` (None: whole)
    qkv: bool = False  # the split is per part of [q | k | v]
    data_dim: Optional[int] = None  # the dim split over `data` (FSDP)


# ---------------------------------------------------------------------------
# Which kinds split
# ---------------------------------------------------------------------------


def _divides(tp: int, *dims: int) -> bool:
    return tp > 1 and all(d % tp == 0 for d in dims)


def _llm_splits(cfg, family: str, tp: int) -> Dict[str, bool]:
    s = {"attn": _divides(tp, cfg.num_attention_heads, cfg.num_key_value_heads),
         "mlp": _divides(tp, cfg.intermediate_size),
         "vocab": _divides(tp, cfg.vocab_size)}
    if family == "nano":
        s["mamba"] = _divides(tp, cfg.mamba_num_heads, cfg.mamba_n_groups)
    return s


def local_llm_config(cfg, family: str, tp: int):
    """The backbone config at this rank's head counts and widths."""
    s = _llm_splits(cfg, family, tp)
    kw = {}
    if s["attn"]:
        kw.update(num_attention_heads=cfg.num_attention_heads // tp,
                  num_key_value_heads=cfg.num_key_value_heads // tp)
    if s["mlp"]:
        kw["intermediate_size"] = cfg.intermediate_size // tp
    if s.get("mamba"):
        kw.update(mamba_num_heads=cfg.mamba_num_heads // tp,
                  mamba_n_groups=cfg.mamba_n_groups // tp)
    return dataclasses.replace(cfg, **kw) if kw else cfg


def _module_roles(model: nn.Module, arch, mesh, tp: int) -> Dict[str, Any]:
    """{port module name: TPRole or a tag} of the modules that split."""
    roles: Dict[str, Any] = {}
    if tp <= 1:
        return roles
    llm = _llm_splits(arch.llm, arch.llm_family, tp)
    col, row = TPRole(mesh, "col"), TPRole(mesh, "row")
    col_rep = TPRole(mesh, "col", replicated_bias=True)
    col_gather = TPRole(mesh, "col", replicated_bias=True, gather=True)
    towers = {(f"vision_backbone.{k}" if k else "vision_backbone"): (fam, cfg)
              for k, fam, cfg in arch.towers()}
    for name, mod in model.named_modules():
        parts = name.split(".")
        leaf = parts[-1]
        if name == "llm_backbone.embeddings" and llm["vocab"]:
            roles[name] = "vocab"
        elif name == "llm_backbone.lm_head" and llm["vocab"]:
            roles[name] = "vocab"
        elif name.startswith("llm_backbone.layers."):
            if re.fullmatch(r"llm_backbone\.layers\.\d+\.mixer\.in_proj\.(gate|x|B|C|dt)",
                            name) and llm.get("mamba"):
                roles[name] = col
            elif re.fullmatch(r"llm_backbone\.layers\.\d+\.mixer\.out_proj", name) \
                    and llm.get("mamba"):
                roles[name] = row
            elif re.fullmatch(r"llm_backbone\.layers\.\d+\.mixer", name) and llm.get("mamba") \
                    and hasattr(mod, "A_log"):
                roles[name] = "mamba"
            elif leaf in ("q_proj", "k_proj", "v_proj") and llm["attn"]:
                roles[name] = col
            elif leaf == "o_proj" and llm["attn"]:
                roles[name] = row
            elif leaf in ("up_proj", "gate_proj") and llm["mlp"]:
                roles[name] = col
            elif leaf == "down_proj" and llm["mlp"]:
                roles[name] = row
        elif name.startswith("merge_modules.") and llm["attn"]:
            if leaf in ("q_proj", "k_proj", "v_proj"):
                roles[name] = col_rep
            elif leaf == "o_proj":
                roles[name] = row
        elif name.startswith("projector") and re.fullmatch(r"fc\d", leaf) and _is_linear(mod):
            if mod.weight.shape[0] % tp == 0:
                roles[name] = col_gather
        elif name.startswith("vision_backbone") and ".layers." in name:
            tower = name.split(".layers.")[0]
            fam, vcfg = towers[tower]
            if leaf == "qkv" and fam != "internvideo2" and _divides(tp, vcfg.num_attention_heads):
                roles[name] = "qkv"
            elif leaf == "proj" and parts[-2] == "attn" and fam != "internvideo2" \
                    and _divides(tp, vcfg.num_attention_heads):
                roles[name] = row
            elif leaf == "fc1" and _divides(tp, vcfg.intermediate_size):
                roles[name] = col
            elif leaf == "fc2" and _divides(tp, vcfg.intermediate_size):
                roles[name] = row
    return roles


# ---------------------------------------------------------------------------
# The layout and the shard
# ---------------------------------------------------------------------------


def _split(t: torch.Tensor, dim: int, n: int, i: int, qkv: bool = False) -> torch.Tensor:
    if qkv:
        return torch.cat([_split(p, dim, n, i) for p in t.chunk(3, dim)], dim)
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


def _join(parts: List[torch.Tensor], dim: int, qkv: bool = False) -> torch.Tensor:
    if qkv:
        thirds = [p.chunk(3, dim) for p in parts]
        return torch.cat([torch.cat([t[j] for t in thirds], dim) for j in range(3)], dim)
    return torch.cat(parts, dim)


def _local(lf: LeafLayout, t: torch.Tensor, mesh) -> torch.Tensor:
    """A whole leaf's shard on this rank: its model part, then its data part."""
    if lf.model_dim is not None:
        t = _split(t, lf.model_dim, axis_size(mesh, "model"), axis_index(mesh, "model"), lf.qkv)
    if lf.data_dim is not None:
        t = _split(t, lf.data_dim, axis_size(mesh, "data"), axis_index(mesh, "data"))
    return t


class MeshLayout:
    """Where each parameter of a sharded model lives: `leaves` by port name,
    the mesh, and `arch` at the local head counts."""

    def __init__(self, mesh, arch, leaves: Dict[str, LeafLayout]):
        self.mesh, self.arch, self.leaves = mesh, arch, leaves
        self.tp, self.nd = axis_size(mesh, "model"), axis_size(mesh, "data")

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a whole tensor."""
        lf = self.leaves.get(name)
        return full if lf is None else _local(lf, full, self.mesh)

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of this rank's shard (a collective: every rank
        calls it)."""
        lf = self.leaves.get(name)
        if lf is None:
            return t
        t = t.detach()
        if lf.data_dim is not None:
            t = _all_gather(t, self.mesh, "data", lf.data_dim, True)
        if lf.model_dim is not None:
            parts = _all_gather(t, self.mesh, "model", 0, False).unbind(0)
            t = _join(list(parts), lf.model_dim, lf.qkv)
        return t

    def full_state(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {n: self.full(n, t) for n, t in tensors.items()}

    @property
    def fsdp_leaves(self) -> Dict[str, int]:
        return {n: lf.data_dim for n, lf in self.leaves.items() if lf.data_dim is not None}

    def replication(self, name: str) -> int:
        """How many ranks of the (data, model) mesh hold this leaf's shard."""
        lf = self.leaves.get(name)
        if lf is None:
            return self.nd * self.tp
        return ((self.nd if lf.data_dim is None else 1)
                * (self.tp if lf.model_dim is None else 1))


def _owner(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    parent, _, leaf = name.rpartition(".")
    return (model.get_submodule(parent) if parent else model), leaf


_MAMBA_LEAF = re.compile(r"(llm_backbone\.layers\.\d+\.mixer)\."
                         r"(conv1d\.[xBC]\.(weight|bias)|A_log|D|dt_bias|norm\.weight)")


def refuse_int8(model: nn.Module) -> None:
    from timeviper_tpu_torch.ops.int8_linear import Int8Linear

    if any(isinstance(m, Int8Linear) for m in model.modules()):
        raise NotImplementedError(INT8_ON_MESH)


def shard_model(model: nn.Module, arch, mesh, fsdp_params: bool = False) -> MeshLayout:
    """Cut a whole model (TimeViperVLM) to this rank's shard, in place, and
    return its layout (also kept as `model.mesh_layout`). The shards stay on
    the model's device; each whole tensor is freed as its shard replaces it."""
    if getattr(model, "mesh_layout", None) is not None:
        raise ValueError("the model is already sharded")
    sizes = mesh_shape(mesh)
    if sizes["data"] > 1 or sizes["model"] > 1:
        refuse_int8(model)
    tp = sizes["model"]
    roles = _module_roles(model, arch, mesh, tp)
    paths = jax_param_paths(model)
    leaves: Dict[str, LeafLayout] = {}
    for name, p in model.named_parameters():
        path, kernel = paths[name]
        spec = _torch_order(port_spec(path, kernel, p.shape, sizes, fsdp_params), kernel)
        lf = LeafLayout(path, spec)
        owner, leaf = name.rpartition(".")[0], name.rpartition(".")[2]
        role = roles.get(owner)
        if isinstance(role, TPRole):
            if leaf == "weight":
                lf.model_dim = 0 if role.kind == "col" else 1
            elif leaf == "bias" and role.kind == "col" and not role.replicated_bias:
                lf.model_dim = 0
        elif role == "qkv" and leaf in ("weight", "bias"):
            lf.model_dim, lf.qkv = 0, True
        elif role == "vocab":
            lf.model_dim = 0
        else:  # a Mamba mixer's convs, A_log, D, dt_bias and gated norm
            m = _MAMBA_LEAF.fullmatch(name)
            if m and roles.get(m.group(1)) == "mamba":
                lf.model_dim = 0
        if "data" in spec:
            lf.data_dim = spec.index("data")
        leaves[name] = lf
    for name, role in roles.items():
        mod = model.get_submodule(name)
        if role == "qkv":
            role = TPRole(mesh, "col")
        if isinstance(role, TPRole):
            if type(mod) is nn.Linear:
                mod.__class__ = TPLinear
            mod.tp = role
        elif role == "vocab":
            if type(mod) is nn.Embedding:
                mod.__class__ = TPEmbedding
            mod.tp = TPRole(mesh, "col")
    fsdp: Dict[str, Dict[str, int]] = {}
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            lf = leaves[name]
            if lf.model_dim is None and lf.data_dim is None:
                continue
            mod, leaf = _owner(model, name)
            shard = _local(lf, p.detach(), mesh)
            mod._parameters[leaf] = nn.Parameter(shard.contiguous().clone(),
                                                 requires_grad=p.requires_grad)
            if lf.data_dim is not None:
                fsdp.setdefault(name.rpartition(".")[0], {})[leaf] = lf.data_dim
    for owner, dims in fsdp.items():
        _gather_on_read(model.get_submodule(owner), mesh, dims)
    local = dataclasses.replace(arch, llm=local_llm_config(arch.llm, arch.llm_family, tp))
    layout = MeshLayout(mesh, local, leaves)
    model.mesh_layout = layout
    return layout


# ---------------------------------------------------------------------------
# FSDP, gradients and norms
# ---------------------------------------------------------------------------


def sync_grads(layout: Optional[MeshLayout], grads: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """Sum the gradients of the leaves replicated over `data` across it (an
    FSDP leaf's arrives reduce-scattered)."""
    if layout is None or layout.nd == 1:
        return grads
    fsdp = layout.fsdp_leaves
    return {n: g if n in fsdp else psum(g, layout.mesh, "data") for n, g in grads.items()}


def global_norm(layout: Optional[MeshLayout], grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of the whole leaves: each shard's squares
    summed over the mesh, a replicated leaf counted once."""
    if not grads:
        return torch.zeros(())
    if layout is None:
        return torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
    total = sum(g.float().square().sum() / layout.replication(n) for n, g in grads.items())
    for axis in ("data", "model"):
        if axis_size(layout.mesh, axis) > 1:
            total = psum(total, layout.mesh, axis)
    return torch.sqrt(total)


def split_rows(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's contiguous rows of a global batch (BATCH_SPEC)."""
    axis = BATCH_SPEC[0]
    nd, i = axis_size(mesh, axis), axis_index(mesh, axis)
    if nd == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor) and v.dim() >= 1:
            if v.shape[0] % nd:
                raise ValueError(f"{k}: {v.shape[0]} rows over {nd} data shards")
            n = v.shape[0] // nd
            v = v[i * n:(i + 1) * n]
        out[k] = v
    return out



def serving_arch(model: nn.Module, arch, mesh):
    """The arch a server runs `model` at on `mesh`: with a model axis above 1
    the model is sharded (once, without FSDP, as the JAX package's
    load_pretrained_vlm shards it) and the local head counts come back."""
    if axis_size(mesh, "model") <= 1:
        return arch
    layout = getattr(model, "mesh_layout", None)
    if layout is None:
        layout = shard_model(model, arch, mesh, fsdp_params=False)
    return layout.arch
