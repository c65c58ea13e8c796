"""Reference PyTorch checkpoint -> the port's `state_dict` (counterpart of
timeviper_tpu/train/convert.py, with its names).

The reference stores `nn.Linear` weights (out, in), which is the port's
layout already, so a weight goes across as it is: no (in, out) numpy detour
and no f32 copy of the whole model. What does change (SURVEY.md §7 hard
part 5):

* nano's `load_hook` rename `embedding.` -> `embeddings.` (modeling_nano.py:1532);
* the fused Mamba in_proj rows `[gate | x | B | C | dt]` split by role into
  `in_proj.{gate,x,B,C,dt}`, and the conv1d taps (C, 1, K) into
  `conv1d.{x,B,C}` (C, K);
* the timm patch kernel (D, 3, ps, ps) -> the (D, ps*ps*3) weight of the
  patch matmul, in the (row, column, channel) order of the JAX package's
  (ps, ps, 3, D) kernel; InternVideo2's conv3d tubelet (D, 3, t, ps, ps) ->
  (D, t*ps*ps*3) the same way;
* the class row dropped from a timm `pos_embed`, and InternVideo2's table
  interpolated to the configured frames and grid;
* a SigLIP / DINOv2 tower loses its last block (the port builds only the
  blocks its penultimate features come from);
* the projector's Sequential indices 0/2(/4) -> fc1/fc2 (fc0/fc1/fc2);
* TransV's merge modules (`backbone.merge_modules.<i>` and the shared
  `backbone.alpha`) -> `merge_modules.<stage>`; the JAX package's whole-VLM
  converter leaves them out, this one loads them;
* no lm_head when the embeddings are tied.

`dtype` follows the JAX converters: linear weights and biases, embeddings
and the patch kernel in `dtype`, norms, conv taps, SSM leaves, position
tables, class and register tokens and alpha in float32. `dtype=None` keeps
every leaf as the file stores it (views where a split or a transpose
suffices), which is what `models/api.py` takes before it casts each tensor
on its way to the device.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping, Optional

import torch

StateDict = Dict[str, torch.Tensor]


def load_torch_state_dict(path: str) -> StateDict:
    """A .bin / .pt / .safetensors file -> {name: tensor}, as stored. A torch
    zip file is memory-mapped (`mmap=True`): its tensors are read from the
    page cache when they are used."""
    if str(path).endswith(".safetensors"):
        from safetensors.torch import load_file

        return dict(load_file(path))
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    except Exception:
        # Some reference checkpoints need full unpickling (the reference
        # forces weights_only=False globally, torch_load_patch.py:1-16).
        # Unpickling executes arbitrary code — gate it behind an explicit
        # opt-in so converting an untrusted file is never silently an RCE.
        if os.environ.get("TIMEVIPER_UNSAFE_TORCH_LOAD") != "1":
            raise RuntimeError(
                f"{path} is not loadable with weights_only=True; if you "
                "trust this checkpoint, set TIMEVIPER_UNSAFE_TORCH_LOAD=1 "
                "(unpickling executes code from the file)")
        sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return dict(sd)


def _as(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return t if dtype is None else t.to(dtype)


def _f32(dtype: Optional[torch.dtype]) -> Optional[torch.dtype]:
    """The type of the leaves the JAX converters keep in float32."""
    return None if dtype is None else torch.float32


def _lin(out: StateDict, name: str, sd: Mapping[str, torch.Tensor], prefix: str,
         dtype) -> None:
    out[f"{name}.weight"] = _as(sd[f"{prefix}.weight"], dtype)
    if f"{prefix}.bias" in sd:
        out[f"{name}.bias"] = _as(sd[f"{prefix}.bias"], dtype)


def convert_nano(sd: Mapping[str, torch.Tensor], cfg, dtype=torch.float32) -> StateDict:
    """NemotronHForCausalLM state dict -> a NanoModel state_dict.

    Torch names: backbone.embeddings.weight, backbone.layers.{i}.norm.weight,
    backbone.layers.{i}.mixer.*, backbone.norm_f.weight, lm_head.weight."""
    # load_hook rename (modeling_nano.py:1532-1536)
    sd = {k.replace("embedding.", "embeddings.") if "embedding." in k else k: v
          for k, v in sd.items()}
    f32 = _f32(dtype)
    out: StateDict = {"embeddings.weight": _as(sd["backbone.embeddings.weight"], dtype)}
    for i, block_type in enumerate(cfg.layers_block_type):
        pre, name = f"backbone.layers.{i}", f"layers.{i}"
        out[f"{name}.norm.weight"] = _as(sd[f"{pre}.norm.weight"], f32)
        mp, mn = f"{pre}.mixer", f"{name}.mixer"
        if block_type == "mamba":
            d_inner = cfg.mamba_intermediate_size
            gn = cfg.mamba_n_groups * cfg.ssm_state_size
            # fused torch in_proj rows are [gate | x | B | C | dt]
            # (modeling_nano.py:489-492, 583-592)
            sizes = [d_inner, d_inner, gn, gn, cfg.mamba_num_heads]
            w_in = sd[f"{mp}.in_proj.weight"]  # (P, D)
            if w_in.shape[0] != sum(sizes):
                raise ValueError(f"{mp}.in_proj.weight has {w_in.shape[0]} rows; the config "
                                 f"splits {sum(sizes)} as {sizes}")
            for role, w in zip(("gate", "x", "B", "C", "dt"), torch.split(w_in, sizes)):
                out[f"{mn}.in_proj.{role}.weight"] = _as(w, dtype)
            conv_w = sd[f"{mp}.conv1d.weight"].reshape(-1, cfg.mamba_d_conv)
            conv_b = sd.get(f"{mp}.conv1d.bias")
            for j, role in enumerate(torch.split(conv_w, [d_inner, gn, gn])):
                r = "xBC"[j]
                out[f"{mn}.conv1d.{r}.weight"] = _as(role, f32)
                if conv_b is not None:
                    out[f"{mn}.conv1d.{r}.bias"] = _as(
                        torch.split(conv_b, [d_inner, gn, gn])[j], f32)
            for leaf in ("dt_bias", "A_log", "D"):
                out[f"{mn}.{leaf}"] = _as(sd[f"{mp}.{leaf}"], f32)
            out[f"{mn}.norm.weight"] = _as(sd[f"{mp}.norm.weight"], f32)
            _lin(out, f"{mn}.out_proj", sd, f"{mp}.out_proj", dtype)
        elif block_type == "attention":
            for k in ("q_proj", "k_proj", "v_proj", "o_proj"):
                _lin(out, f"{mn}.{k}", sd, f"{mp}.{k}", dtype)
        else:
            _lin(out, f"{mn}.up_proj", sd, f"{mp}.up_proj", dtype)
            _lin(out, f"{mn}.down_proj", sd, f"{mp}.down_proj", dtype)
    out["norm_f.weight"] = _as(sd["backbone.norm_f.weight"], f32)
    if "lm_head.weight" in sd and not cfg.tie_word_embeddings:
        _lin(out, "lm_head", sd, "lm_head", dtype)
    return out


def convert_nano_merge_modules(sd: Mapping[str, torch.Tensor], cfg, dtype=torch.float32,
                               prefix: str = "backbone") -> Optional[StateDict]:
    """TransV merge modules: `backbone.merge_modules.{i}.{q,k,v,o}_proj` +
    the shared `backbone.alpha` vector (one entry per non-"drop" stage,
    modeling_nano.py:1482-1515) -> a models/pdrop.py:MergeModules
    state_dict keyed by stage index, each alpha a float32 scalar; None for
    a config without them."""
    stages = cfg.pdrop_stages
    if not stages or cfg.merge_module != "CrossAttention":
        return None
    alpha = sd.get(f"{prefix}.alpha")
    out: StateDict = {}
    alpha_i = 0
    for i, stage in enumerate(stages):
        if "drop" in stage.compress_type:
            continue
        mp = f"{prefix}.merge_modules.{i}"
        for k in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _lin(out, f"{i}.cross_attn.{k}", sd, f"{mp}.{k}", dtype)
        a = alpha[alpha_i] if alpha is not None else torch.zeros(())
        out[f"{i}.alpha"] = a.to(torch.float32)
        alpha_i += 1
    return out


def convert_qwen2(sd: Mapping[str, torch.Tensor], cfg, dtype=torch.float32) -> StateDict:
    """Qwen2ForCausalLM state dict -> a Qwen2Model state_dict."""
    f32 = _f32(dtype)
    out: StateDict = {"embeddings.weight": _as(sd["model.embed_tokens.weight"], dtype)}
    for i in range(cfg.num_hidden_layers):
        pre, name = f"model.layers.{i}", f"layers.{i}"
        for norm in ("input_layernorm", "post_attention_layernorm"):
            out[f"{name}.{norm}.weight"] = _as(sd[f"{pre}.{norm}.weight"], f32)
        for k in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _lin(out, f"{name}.self_attn.{k}", sd, f"{pre}.self_attn.{k}", dtype)
        for k in ("gate_proj", "up_proj", "down_proj"):
            _lin(out, f"{name}.mlp.{k}", sd, f"{pre}.mlp.{k}", dtype)
    out["norm_f.weight"] = _as(sd["model.norm.weight"], f32)
    if "lm_head.weight" in sd and not cfg.tie_word_embeddings:
        _lin(out, "lm_head", sd, "lm_head", dtype)
    return out


def _patch_weight(w: torch.Tensor) -> torch.Tensor:
    """(D, 3, [t,] ps, ps) conv kernel -> (D, [t *] ps * ps * 3): channels
    last, as the JAX package flattens its (ps, ps, 3, D) kernel."""
    return w.permute(0, *range(2, w.ndim), 1).reshape(w.shape[0], -1)


def convert_timm_vit(sd: Mapping[str, torch.Tensor], cfg, dtype=torch.float32) -> StateDict:
    """timm ViT (SigLIP / DINOv2) state dict -> a models/vit.py:ViT
    state_dict, without the last block (penultimate features).

    timm names: patch_embed.proj.weight (D,3,ps,ps), pos_embed, cls_token,
    reg_token, blocks.{i}.norm1/attn.qkv/attn.proj/norm2/mlp.fc1/mlp.fc2."""
    sd = {re.sub(r"^module\.", "", k): v for k, v in sd.items()}
    f32 = _f32(dtype)
    out: StateDict = {"patch_embed.weight": _as(_patch_weight(sd["patch_embed.proj.weight"]),
                                                dtype),
                      "patch_embed.bias": _as(sd["patch_embed.proj.bias"], dtype)}
    pos = sd["pos_embed"]
    if pos.shape[1] == cfg.num_patches + 1:
        # timm embed-class layout stores a cls row first; the forward adds
        # positions to the patches only
        pos = pos[:, 1:]
    if pos.shape[1] != cfg.num_patches:
        raise ValueError(f"pos_embed of {pos.shape[1]} rows for {cfg.num_patches} patches")
    out["pos_embed"] = _as(pos, f32)
    if cfg.use_class_token and "cls_token" in sd:
        out["cls_token"] = _as(sd["cls_token"], f32)
    if cfg.num_register_tokens and "reg_token" in sd:
        out["reg_tokens"] = _as(sd["reg_token"], f32)
    for i in range(cfg.num_hidden_layers - 1):
        pre, name = f"blocks.{i}", f"layers.{i}"
        for norm in ("norm1", "norm2"):
            for leaf in ("weight", "bias"):
                out[f"{name}.{norm}.{leaf}"] = _as(sd[f"{pre}.{norm}.{leaf}"], f32)
        for k in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
            _lin(out, f"{name}.{k}", sd, f"{pre}.{k}", dtype)
        if cfg.use_layer_scale:
            for ls in ("ls1", "ls2"):
                out[f"{name}.{ls}.gamma"] = _as(sd[f"{pre}.{ls}.gamma"], f32)
    return out


def convert_internvideo2(sd: Mapping[str, torch.Tensor], cfg, dtype=torch.float32
                         ) -> StateDict:
    """InternVideo2 PretrainVisionTransformer_clean state dict -> a
    models/internvideo2.py:InternVideo2 state_dict (its `effective_depth`
    blocks; `attn_pool.*` where the file has the clip projector).

    Torch names (vit_scale_clean.py:464-602): patch_embed.proj.weight
    (D,3,t,ps,ps) conv3d, cls_token, pos_embed, blocks.{i}.{norm1,attn.qkv,
    attn.q_norm,attn.k_norm,attn.proj,ls1.gamma,norm2,mlp.fc1,mlp.fc2,
    ls2.gamma}."""
    from timeviper_tpu_torch.models.internvideo2 import interpolate_pos_embed

    sd = {re.sub(r"^(vision_tower\.|model\.)", "", k): v for k, v in sd.items()}
    f32 = _f32(dtype)

    def _ls(pre, name):
        # real checkpoints: LayerScale stores `weight` (vit_scale_clean.py
        # :170); `gamma` accepted for timm-style dumps
        v = sd.get(f"{pre}.{name}.weight", sd.get(f"{pre}.{name}.gamma"))
        return _as(v, f32)

    out: StateDict = {}
    for i in range(cfg.effective_depth):
        pre, name = f"blocks.{i}", f"layers.{i}"
        for norm in ("norm1", "norm2", "attn.q_norm", "attn.k_norm"):
            out[f"{name}.{norm}.weight"] = _as(sd[f"{pre}.{norm}.weight"], f32)
        for k in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
            _lin(out, f"{name}.{k}", sd, f"{pre}.{k}", dtype)
        out[f"{name}.ls1.gamma"] = _ls(pre, "ls1")
        out[f"{name}.ls2.gamma"] = _ls(pre, "ls2")
    out["patch_embed.weight"] = _as(_patch_weight(sd["patch_embed.proj.weight"]), dtype)
    out["patch_embed.bias"] = _as(sd["patch_embed.proj.bias"], dtype)
    out["cls_token"] = _as(sd["cls_token"], f32)

    # position table: checkpoints are pretrained at `pretrain_t_size`
    # temporal positions / their own spatial grid; interpolate to the
    # configured frames/resolution (reference pos_embed.py:125-203)
    pos = sd["pos_embed"]
    target_t = cfg.num_frames // cfg.tubelet_size
    if pos.shape[1] != target_t * cfg.grid_size**2 + 1:
        orig_t = getattr(cfg, "pretrain_t_size", 8)
        if (pos.shape[1] - 1) % orig_t != 0:
            orig_t = target_t  # spatial-only mismatch
        pos = torch.from_numpy(interpolate_pos_embed(
            pos.to(torch.float32).numpy(), orig_t=orig_t, new_t=target_t,
            new_grid=cfg.grid_size))
        out["pos_embed"] = pos
    else:
        out["pos_embed"] = _as(pos, f32)

    if "clip_projector.cross_attn.q.weight" in sd:
        cp = "clip_projector"
        for norm in ("norm1_q", "norm1_k", "norm1_v"):
            for leaf in ("weight", "bias"):
                out[f"attn_pool.{norm}.{leaf}"] = _as(sd[f"{cp}.{norm}.{leaf}"], f32)
        for k in ("q", "k", "v"):
            # CrossAttention stores the bias apart as `{q,k,v}_bias`
            # (vit_scale_clean.py:46-57); none adds nothing
            w = _as(sd[f"{cp}.cross_attn.{k}.weight"], dtype)
            bias = sd.get(f"{cp}.cross_attn.{k}_bias")
            out[f"attn_pool.{k}.weight"] = w
            out[f"attn_pool.{k}.bias"] = (_as(bias, dtype) if bias is not None
                                          else torch.zeros(w.shape[0], dtype=w.dtype))
        _lin(out, "attn_pool.proj", sd, f"{cp}.cross_attn.proj", dtype)
    return out


def convert_projector(sd: Mapping[str, torch.Tensor], dtype=torch.float32,
                      prefix: str = "projector") -> StateDict:
    """ToMe / MLP projector: torch Sequential indices 0/2(/4) -> fc1/fc2
    (fc0/fc1/fc2, the fused_tome_mlp form)."""
    keys = [k for k in sd if k.startswith(f"{prefix}.projector.")]
    idx = sorted({int(k.split(".")[2]) for k in keys})
    names = ["fc1", "fc2"] if len(idx) == 2 else ["fc0", "fc1", "fc2"]
    out: StateDict = {}
    for name, i in zip(names, idx):
        _lin(out, name, sd, f"{prefix}.projector.{i}", dtype)
    return out


def _convert_tower(sd_sub, family: str, cfg, dtype) -> StateDict:
    if family == "internvideo2":
        return convert_internvideo2(sd_sub, cfg, dtype)
    return convert_timm_vit(sd_sub, cfg, dtype)


def convert_vlm_checkpoint(sd: Mapping[str, torch.Tensor], arch, dtype=torch.float32
                           ) -> StateDict:
    """Whole-VLM torch checkpoint (generic_vlm.py:874-910) -> a
    models/vlm.py:TimeViperVLM state_dict.

    Multi-encoder checkpoints keep per-tower weights under
    `vision_backbone.backbones.<sanitized_id>.` (generic_vlm.py:180-186)
    and per-tower projectors under `projector.projectors.<id>.`. A pdrop
    config with a CrossAttention merge module gets its TransV modules."""

    def sub(prefix):
        plen = len(prefix)
        return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix)}

    llm_sd = sub("llm_backbone.llm.")
    conv_llm = convert_nano if arch.llm_family == "nano" else convert_qwen2
    parts = [("llm_backbone", conv_llm(llm_sd, arch.llm, dtype))]
    if arch.vision_backbones:
        for bid, fam, cfg in arch.vision_backbones:
            key = bid.replace("-", "_").replace("+", "_")
            tower_sd = sub(f"vision_backbone.backbones.{key}.featurizer.")
            if not tower_sd:
                tower_sd = sub(f"vision_backbone.backbones.{key}.")
            parts.append((f"vision_backbone.{key}", _convert_tower(tower_sd, fam, cfg, dtype)))
            proj_sd = {k.replace(f".projectors.{key}", ""): v for k, v in sd.items()
                       if k.startswith(f"projector.projectors.{key}.")}
            if proj_sd:
                parts.append((f"projector.{key}", convert_projector(proj_sd, dtype)))
    else:
        parts += [("vision_backbone", _convert_tower(sub("vision_backbone.featurizer."),
                                                     arch.vision_family, arch.vision, dtype)),
                  ("projector", convert_projector(sd, dtype))]
    if arch.llm_family == "nano":
        merge = convert_nano_merge_modules(llm_sd, arch.llm, dtype)
        if merge is not None:
            parts.append(("merge_modules", merge))
    return {f"{prefix}.{k}": v for prefix, part in parts for k, v in part.items()}
