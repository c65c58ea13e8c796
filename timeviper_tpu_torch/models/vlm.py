"""TimeViper VLM assembly: vision -> projector -> fuse -> LLM (counterpart of
timeviper_tpu/models/vlm.py).

The host builds the fusion plan (data/fusion.py) and the model applies it as
one gather. `vlm_loss` is the training loss over a batch of rows that share
one plan: the rows run as a written-out batch dimension where the JAX package
vmaps its one-row loss. A pdrop config with `merge_module == "CrossAttention"`
gives the model its TransV modules (`merge_modules`, models/pdrop.py), and
`vlm_forward(use_pdrop=True)` and `vlm_loss(use_pdrop=True)` run the stages
(training through TransV's cross-attention backward on the card). The
backbone is Nemotron-H (`llm_family` "nano", models/nano.py) or Qwen2
("qwen2", models/qwen2.py); `vlm_forward`, `vlm_loss`, `init_cache` and
`decode_step` dispatch by family. Rows with different layouts (a
heterogeneous batch, data/loader.py:collate_hetero) carry their own
`gather_idx` / `seq_idx`: `vlm_loss` runs them as one batch with per-row
segment ids, and `vlm_forward_dynamic` runs one such row.

Vision towers by family: SigLIP and DINOv2 (models/vit.py), InternVideo2
(models/internvideo2.py, clips of 4 frames merged jointly by the projector),
and "multi": one tower and one projector per backbone id, held in
`nn.ModuleDict`s keyed as the JAX pytree is, their tokens interleaved per
frame.

A frozen tower runs under no_grad. A tower with a parameter that requires
grad runs with it (the JAX package trains the tower when `trainable_modules`
names it or is None): on the card its attention is K3 or K6 with the row
log-sum-exp and csrc/vit_attn_bwd.cu as the backward
(ops/vit_attention.py:VitAttnQKVFn, VitAttnFn), its fused LayerNorms K8
with the JAX package's LayerNorm gradient (ops/layernorm.py:FusedLNFn). The
tower is not rematerialised, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from timeviper_tpu_torch.config import VLMConfig
from timeviper_tpu_torch.data.fusion import IGNORE_INDEX, FusionPlan, HeteroPlan
from timeviper_tpu_torch.device import resolve_device
from timeviper_tpu_torch.models.cache import init_nano_cache, init_qwen2_cache
from timeviper_tpu_torch.models.internvideo2 import InternVideo2, encode_frames_iv2
from timeviper_tpu_torch.models.nano import NanoModel, nano_decode_step, nano_forward
from timeviper_tpu_torch.models.pdrop import init_merge_modules, make_pdrop_spec
from timeviper_tpu_torch.models.projector import Projector, projector_forward
from timeviper_tpu_torch.models.qwen2 import Qwen2Model, qwen2_decode_step, qwen2_forward
from timeviper_tpu_torch.models.vit import ViT, vit_forward

VIT_FAMILIES = ("siglip", "dinov2")


@dataclass(frozen=True)
class VLMArch:
    """Static bundle of configs, as timeviper_tpu.models.vlm.VLMArch. A
    multi-tower model sets `vision_backbones` to (backbone id, family,
    config) per tower and `vision` to the first tower's config."""

    vlm: VLMConfig
    vision: Any  # ViTConfig | InternVideo2Config
    llm: Any  # NanoConfig | Qwen2Config
    llm_family: str = "nano"  # "nano" | "qwen2"
    vision_family: str = "siglip"
    vision_backbones: Optional[Tuple[Tuple[str, str, Any], ...]] = None

    @property
    def tokens_per_frame(self) -> int:
        n = self.vlm.num_compressed_tokens
        if n > 0:
            return n * (len(self.vision_backbones) if self.vision_backbones else 1)
        return self.vision.num_patches

    @property
    def local_num_frames(self) -> int:
        """Frames merged jointly by one ToMe call (InternVideo2's clips)."""
        return self.vision.num_frames if self.vision_family == "internvideo2" else 1

    def towers(self) -> Tuple[Tuple[str, str, Any], ...]:
        """(module key, family, config) of each tower; a single tower's key
        is ""."""
        if self.vision_backbones:
            return tuple((tower_key(bid), fam, cfg) for bid, fam, cfg in self.vision_backbones)
        return (("", self.vision_family, self.vision),)


def tower_key(backbone_id: str) -> str:
    """A tower's key in the multi-tower ModuleDicts, as in the JAX pytree."""
    return backbone_id.replace("-", "_").replace("+", "_")


def _make_tower(family: str, cfg, dtype, device) -> nn.Module:
    if family == "internvideo2":
        return InternVideo2(cfg, dtype, device)
    if family in VIT_FAMILIES:
        return ViT(cfg, dtype, device)
    raise NotImplementedError(f"vision family {family!r} is not ported")


def _tower_forward(tower: nn.Module, family: str, cfg, pixels: torch.Tensor) -> torch.Tensor:
    """pixels (F, H, W, 3) -> per-frame features (F, patches, D)."""
    if family == "internvideo2":
        # (F / 4, 4 * g^2, D) clip features -> per frame; the projector
        # groups them again by local_num_frames
        clip_feats = encode_frames_iv2(tower, cfg, pixels)
        return clip_feats.reshape(pixels.shape[0], -1, clip_feats.shape[-1])
    return vit_forward(tower, cfg, pixels)


class TimeViperVLM(nn.Module):
    """The VLM's weights, on the card unless `device` names another device."""

    def __init__(self, arch: VLMArch, dtype=torch.bfloat16, device=None):
        super().__init__()
        if arch.llm_family not in ("nano", "qwen2"):
            raise NotImplementedError(f"the {arch.llm_family} backbone is not ported")
        device = resolve_device(device)
        self.arch = arch
        towers = {key: (_make_tower(fam, cfg, dtype, device),
                        Projector(cfg.hidden_size, arch.llm.hidden_size,
                                  arch.vlm.projector_type, dtype, device))
                  for key, fam, cfg in arch.towers()}
        if arch.vision_backbones:
            self.vision_backbone = nn.ModuleDict({k: v[0] for k, v in towers.items()})
            self.projector = nn.ModuleDict({k: v[1] for k, v in towers.items()})
        else:
            self.vision_backbone, self.projector = towers[""]
        backbone = NanoModel if arch.llm_family == "nano" else Qwen2Model
        self.llm_backbone = backbone(arch.llm, dtype, device)
        self.merge_modules = init_merge_modules(arch.llm, dtype, device)

    def tower(self, key: str) -> Tuple[nn.Module, Projector]:
        """The tower and projector of `key` (one of arch.towers())."""
        if key == "":
            return self.vision_backbone, self.projector
        return self.vision_backbone[key], self.projector[key]


def init_vlm_params(arch: VLMArch, generator: torch.Generator, dtype=torch.bfloat16,
                    device=None) -> TimeViperVLM:
    """Build the model on `device` (the card by default) with random weights
    drawn from `generator`, which must live on the same device. The TransV
    modules draw last, so the other weights are those of the same config
    without them."""
    model = TimeViperVLM(arch, dtype, device)
    for key, _, _ in arch.towers():
        for part in model.tower(key):
            part.reset_parameters(generator)
    model.llm_backbone.reset_parameters(generator)
    if model.merge_modules is not None:
        model.merge_modules.reset_parameters(generator)
    return model.eval()


def encode_visual(model: TimeViperVLM, arch: VLMArch, pixels: torch.Tensor) -> torch.Tensor:
    """pixels (frames, H, W, 3) -> (frames, tokens_per_frame, llm_dim). A
    frozen tower runs under no_grad, a trainable one with grad (on the card
    through the attention backward kernel). Several towers: each tower's tokens go
    through its own projector (no clip-joint merge, as in the JAX package),
    then interleave per frame, (F, n, towers, D) -> (F, n * towers, D), or
    concatenate where their counts differ."""
    tower_trains = torch.is_grad_enabled() and any(
        p.requires_grad for p in model.vision_backbone.parameters())
    n = arch.vlm.num_compressed_tokens
    multi = bool(arch.vision_backbones)
    outs = []
    for key, fam, cfg in arch.towers():
        tower, proj = model.tower(key)
        with torch.set_grad_enabled(tower_trains):
            feats = _tower_forward(tower, fam, cfg, pixels)
        outs.append(projector_forward(
            proj, feats, projector_type=arch.vlm.projector_type,
            num_compressed_tokens=n if n > 0 else feats.shape[1],
            local_num_frames=1 if multi else arch.local_num_frames,
            token_order=arch.vlm.visual_token_order,
            compress="tome" in arch.vlm.projector_type))
    if len(outs) == 1:
        return outs[0]
    if all(o.shape == outs[0].shape for o in outs):
        return torch.stack(outs, dim=2).reshape(outs[0].shape[0], -1, outs[0].shape[-1])
    return torch.cat(outs, dim=1)


def fuse_rows(model: TimeViperVLM, ids: torch.Tensor, visual: torch.Tensor,
              gather_idx: torch.Tensor) -> torch.Tensor:
    """(B, L, D): row b gathers gather_idx[b] from concat(its text
    embeddings (Lt), its visual tokens), the model's one gather of a plan."""
    text = model.llm_backbone.embeddings(ids)
    src = torch.cat([text, visual.to(text.dtype)], dim=1)
    rows = torch.arange(src.shape[0], device=src.device)[:, None]
    return src[rows, gather_idx.to(src.device, torch.long)]


def vlm_forward(
    model: TimeViperVLM,
    arch: VLMArch,
    *,
    input_ids: torch.Tensor,
    plan: FusionPlan,
    pixels: Optional[torch.Tensor] = None,
    visual_embeddings: Optional[torch.Tensor] = None,
    fill_cache: bool = False,
    cache_max_len: int = 0,
    valid_from: int = 0,
    logits_to_keep: int = 0,
    fused_conv: bool = False,
    labels: Optional[torch.Tensor] = None,
    use_pdrop: bool = False,
    pdrop_query_positions: Optional[Tuple[Optional[int], ...]] = None,
    pdrop_vision_start: Optional[int] = None,
    pdrop_query_pos: Optional[int] = None,
) -> Dict[str, Any]:
    """Prefill over one fused row: encode pixels unless visual embeddings are
    given, fuse them into the text by the plan, run the backbone. `fused_conv`
    (inference only) fuses each Mamba layer's conv into its scan
    (timeviper_tpu/models/vlm.py:227); the qwen2 backbone has no Mamba layer
    and ignores it.

    `labels` (fused_len,) are already fused; the output returns them as the
    stages leave them.

    `use_pdrop` on a pdrop config runs its stages (vlm.py:219-288) in one of
    the JAX package's two layouts. With `pdrop_vision_start`: one sample
    spanning the row, as the Generator's bucketed prefill lays it out, its
    visual block starting at `pdrop_vision_start` (a left pad included) and
    `pdrop_query_pos` the ranking query. Without: the static branch, the
    plan's packed samples (`plan.sample_layouts`), each ranked by its entry
    of `pdrop_query_positions` or, where none is given, by the row before its
    last answer span in the labels (vlm.py:268-272)."""
    emb = model.llm_backbone.embeddings.weight
    if visual_embeddings is None and pixels is not None:
        ve = encode_visual(model, arch, pixels)
        visual_embeddings = ve.reshape(-1, ve.shape[-1])
    if visual_embeddings is None:
        visual_embeddings = emb.new_zeros(0, arch.llm.hidden_size)
    if visual_embeddings.shape[0] != plan.num_visual:
        raise ValueError(f"{visual_embeddings.shape[0]} visual tokens for a plan of "
                         f"{plan.num_visual}")
    fused = fuse_rows(model, input_ids[None], visual_embeddings[None],
                      torch.as_tensor(np.asarray(plan.gather_idx))[None])
    seq_idx = (torch.as_tensor(np.asarray(plan.seq_idx), dtype=torch.int32,
                               device=emb.device)[None]
               if plan.seq_idx is not None else None)
    spec = None
    if use_pdrop and arch.llm.use_pdrop and pdrop_vision_start is not None:
        nv = plan.num_visual
        spec = make_pdrop_spec([(pdrop_vision_start, nv, fused.shape[1] - pdrop_vision_start - nv)],
                               arch.llm.pdrop_stages, [pdrop_query_pos])
    elif use_pdrop:
        spec = packed_pdrop_spec(arch, plan, pdrop_query_positions)
    return llm_forward(model.llm_backbone, arch, fused_conv, inputs_embeds=fused,
                       seq_idx=seq_idx, fill_cache=fill_cache, cache_max_len=cache_max_len,
                       valid_from=valid_from, logits_to_keep=logits_to_keep,
                       labels=None if labels is None else labels[None], pdrop_spec=spec,
                       pdrop_params=model.merge_modules)


def packed_pdrop_spec(arch: VLMArch, plan: FusionPlan, query_positions=None):
    """The static pdrop spec of the plan's packed samples (vlm.py:268-272),
    or None when the config has no pdrop: a sample with no query position
    ranks by its labels."""
    if not arch.llm.use_pdrop:
        return None
    return make_pdrop_spec(list(plan.sample_layouts), arch.llm.pdrop_stages,
                           list(query_positions) if query_positions else None)


def llm_forward(llm: nn.Module, arch: VLMArch, fused_conv: bool = False, **kw) -> Dict[str, Any]:
    """The backbone's full-sequence forward: nano_forward (which takes
    `fused_conv`) or qwen2_forward, by the arch's family."""
    if arch.llm_family == "qwen2":
        return qwen2_forward(llm, arch.llm, **kw)
    return nano_forward(llm, arch.llm, fused_conv=fused_conv, **kw)


def vlm_forward_dynamic(
    model: TimeViperVLM,
    arch: VLMArch,
    *,
    input_ids: torch.Tensor,
    gather_idx: torch.Tensor,
    seq_idx: torch.Tensor,
    pixels: Optional[torch.Tensor] = None,
    visual_embeddings: Optional[torch.Tensor] = None,
    labels: Optional[torch.Tensor] = None,
    remat=False,
) -> Dict[str, Any]:
    """Forward of one row whose fusion plan is data (timeviper_tpu/models/
    vlm.py:295): input_ids (Lt,) padded, gather_idx and seq_idx (fused_len,)
    from collate_hetero, pixels (frames, H, W, 3) padded with zero frames.
    Its pads sit in a trailing segment of their own, where the SSD state
    resets and attention masks them off."""
    emb = model.llm_backbone.embeddings.weight
    if visual_embeddings is None and pixels is not None:
        ve = encode_visual(model, arch, pixels)
        visual_embeddings = ve.reshape(-1, ve.shape[-1])
    if visual_embeddings is None:
        visual_embeddings = emb.new_zeros(0, arch.llm.hidden_size)
    fused = fuse_rows(model, input_ids[None].long(), visual_embeddings[None],
                      gather_idx[None])
    return llm_forward(model.llm_backbone, arch, inputs_embeds=fused,
                       seq_idx=seq_idx[None].to(torch.int32),
                       labels=None if labels is None else labels[None], remat=remat)


def vlm_loss(
    model: TimeViperVLM,
    arch: VLMArch,
    batch: Dict[str, torch.Tensor],
    plan: Union[FusionPlan, HeteroPlan],
    remat=True,
    use_pdrop: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Shifted cross-entropy over fused rows; the mean of the rows' own token
    means, as the JAX package's vmapped `vlm_loss` gives.
    Either backbone (nano_forward or qwen2_forward); `remat` is False, True
    or a policy name ("full", "scan", "dots", "dots_scan",
    models/remat.py); a tied qwen2 takes its logits from the embeddings.
    `use_pdrop` on a pdrop config runs its stages over the plan's packed
    samples (vlm.py:338-372): each row ranks its own "attn" keep sets by its
    labels, the labels shrink with the rows, and the TransV modules train.

    batch: {"input_ids": (B, Lt), "labels": (B, fused_len) already fused,
    "pixels": (B, F, H, W, 3) or "visual_embeddings": (B, Nv, D), optional}
    for rows that share `plan`. A heterogeneous batch (a HeteroPlan) adds
    each row's "gather_idx" and "seq_idx" (B, fused_len); pdrop refuses it,
    as the JAX package does (vlm.py:354).
    Returns (loss, {"n_tokens": labelled tokens summed over the rows})."""
    hetero = "gather_idx" in batch
    if hetero and use_pdrop:
        raise ValueError("pdrop needs static sample layouts; use homogeneous batches")
    ids = batch["input_ids"].long()
    Bsz = ids.shape[0]
    emb = model.llm_backbone.embeddings
    ve = batch.get("visual_embeddings")
    if ve is None and batch.get("pixels") is not None:
        px = batch["pixels"]
        enc = encode_visual(model, arch, px.reshape(-1, *px.shape[2:]))
        ve = enc.reshape(Bsz, -1, enc.shape[-1])
    if ve is None:
        ve = emb.weight.new_zeros(Bsz, 0, arch.llm.hidden_size)
    if hetero:
        gather, seq_idx = batch["gather_idx"], batch["seq_idx"].to(torch.int32)
    else:
        if ve.shape[1] != plan.num_visual:
            raise ValueError(f"{ve.shape[1]} visual tokens for a plan of {plan.num_visual}")
        gather = torch.as_tensor(np.asarray(plan.gather_idx)).expand(Bsz, -1)
        seq_idx = None
        if plan.seq_idx is not None:
            seq_idx = torch.as_tensor(np.asarray(plan.seq_idx), dtype=torch.int32,
                                      device=ids.device).expand(Bsz, -1).contiguous()
    fused = fuse_rows(model, ids, ve, gather)
    out = llm_forward(model.llm_backbone, arch, inputs_embeds=fused, seq_idx=seq_idx,
                      labels=batch["labels"], remat=remat,
                      pdrop_spec=packed_pdrop_spec(arch, plan) if use_pdrop else None,
                      pdrop_params=model.merge_modules)
    logits, labels = out["logits"][:, :-1], out["labels"][:, 1:].long()
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                          ignore_index=IGNORE_INDEX, reduction="none").view(labels.shape)
    n_valid = (labels != IGNORE_INDEX).sum(-1).clamp(min=1)
    loss = (nll.sum(-1) / n_valid).mean()
    return loss, {"n_tokens": n_valid.sum()}


def init_cache(arch: VLMArch, batch_size: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """An empty decode cache, on the card unless `device` names another."""
    init = init_qwen2_cache if arch.llm_family == "qwen2" else init_nano_cache
    return init(arch.llm, batch_size, max_len, dtype, resolve_device(device))


def decode_step(model: TimeViperVLM, arch: VLMArch, token: torch.Tensor, cache):
    """One token per row; the cache's lengths are host integers or one per
    row (models/nano.py:nano_decode_step, models/qwen2.py:qwen2_decode_step).
    The TransV modules ride along: a cache from a pdrop prefill merges each
    token again (vlm.py:396-406)."""
    step = qwen2_decode_step if arch.llm_family == "qwen2" else nano_decode_step
    return step(model.llm_backbone, arch.llm, token, cache, pdrop_params=model.merge_modules)
