"""The weights bridge: a JAX parameter pytree (leaves as numpy arrays, or
anything numpy can copy) -> the port's `state_dict`.

Linear kernels are stored (in, out) in the JAX package and become
`nn.Linear.weight` (out, in); the ViT patch kernel (p, p, 3, D) becomes the
(D, p*p*3) weight of the patch matmul, InternVideo2's flattened tubelet
kernel (tb*ps*ps*3, D) is transposed like any linear; conv taps are
(channels, K) in both. A qwen2 backbone (`qwen2_state_dict`) keeps its
q/k/v biases and, with tied embeddings, has no lm_head. A multi-tower pytree holds one tower and one
projector per backbone key.
LoRA factors planted by the JAX package's add_lora (lora_a, lora_b,
lora_scale) come across unchanged; load them into a model that went through
the port's add_lora. A ViT's position table comes at the size the tree
holds (models/vit.py resizes it to the input's grid), a `fused_tome_mlp`
projector brings its fc0, and a nano tree with tied embeddings has no
lm_head. An int8 leaf of the JAX package's quantize
(kernel_q (in, out), kernel_scale, optional act_inv) becomes an Int8Linear's
buffers, kernel_q transposed to (out, in), and a Mamba in_proj fused by
fuse_decode_in_proj becomes `in_proj.fused`; load those into a model that went
through the port's quantize_params_int8 (and fuse_decode_in_proj). The TransV
modules `merge_modules` (a list, None for a stage without one) become
`merge_modules.<stage>`, their kernels transposed as any linear, `alpha` an
f32 scalar. Every leaf is copied (`np.array(leaf)`): a JAX buffer seen through numpy is
read-only, and the port must own its memory. bfloat16 leaves keep their type.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def to_tensor(leaf) -> torch.Tensor:
    arr = np.array(leaf)  # a copy, writable
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _linear(sd: Dict[str, torch.Tensor], prefix: str, p: Dict[str, Any]) -> None:
    if "kernel_q" in p:  # train/quantize.py's int8 leaf
        sd[f"{prefix}.kernel_q"] = to_tensor(p["kernel_q"]).T.contiguous()
        sd[f"{prefix}.kernel_scale"] = to_tensor(p["kernel_scale"])
        if "act_inv" in p:
            sd[f"{prefix}.act_inv"] = to_tensor(p["act_inv"])
    else:
        sd[f"{prefix}.weight"] = to_tensor(p["kernel"]).T.contiguous()
    if p.get("bias") is not None:
        sd[f"{prefix}.bias"] = to_tensor(p["bias"])
    # LoRA factors keep the JAX layout (train/lora.py:LoRALinear)
    for leaf in ("lora_a", "lora_b", "lora_scale"):
        if leaf in p:
            sd[f"{prefix}.{leaf}"] = to_tensor(p[leaf])


def _layer_scales(sd: Dict[str, torch.Tensor], pre: str, layer: Dict[str, Any]) -> None:
    for ls in ("ls1", "ls2"):
        if ls in layer:
            sd[f"{pre}.{ls}.gamma"] = to_tensor(layer[ls]["gamma"])


def vit_state_dict(tree: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """SigLIP or DINOv2 tower. The last block feeds no output (penultimate
    features) and is dropped."""
    sd: Dict[str, torch.Tensor] = {}
    pe = tree["patch_embed"]
    k = to_tensor(pe["kernel"])
    sd["patch_embed.weight"] = k.reshape(-1, k.shape[-1]).T.contiguous()
    sd["patch_embed.bias"] = to_tensor(pe["bias"])
    for leaf in ("pos_embed", "cls_token", "reg_tokens"):
        if leaf in tree:
            sd[leaf] = to_tensor(tree[leaf])
    for i, layer in enumerate(tree["layers"][: cfg.num_hidden_layers - 1]):
        pre = f"layers.{i}"
        for norm in ("norm1", "norm2"):
            sd[f"{pre}.{norm}.weight"] = to_tensor(layer[norm]["weight"])
            sd[f"{pre}.{norm}.bias"] = to_tensor(layer[norm]["bias"])
        _linear(sd, f"{pre}.attn.qkv", layer["attn"]["qkv"])
        _linear(sd, f"{pre}.attn.proj", layer["attn"]["proj"])
        _linear(sd, f"{pre}.mlp.fc1", layer["mlp"]["fc1"])
        _linear(sd, f"{pre}.mlp.fc2", layer["mlp"]["fc2"])
        _layer_scales(sd, pre, layer)
    return sd


def iv2_state_dict(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """InternVideo2 tower. The JAX init builds only the effective_depth
    blocks the features come from, so every block is kept; a tree with the
    pooling head (`attn_pool`) loads into a tower built with
    attn_pool=True."""
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "patch_embed", tree["patch_embed"])
    sd["cls_token"] = to_tensor(tree["cls_token"])
    sd["pos_embed"] = to_tensor(tree["pos_embed"])
    for i, layer in enumerate(tree["layers"]):
        pre = f"layers.{i}"
        for norm in ("norm1", "norm2"):
            sd[f"{pre}.{norm}.weight"] = to_tensor(layer[norm]["weight"])
        attn = layer["attn"]
        _linear(sd, f"{pre}.attn.qkv", attn["qkv"])
        _linear(sd, f"{pre}.attn.proj", attn["proj"])
        for norm in ("q_norm", "k_norm"):
            sd[f"{pre}.attn.{norm}.weight"] = to_tensor(attn[norm]["weight"])
        _linear(sd, f"{pre}.mlp.fc1", layer["mlp"]["fc1"])
        _linear(sd, f"{pre}.mlp.fc2", layer["mlp"]["fc2"])
        _layer_scales(sd, pre, layer)
    if "attn_pool" in tree:  # a full checkpoint's pooling head
        pool = tree["attn_pool"]
        for norm in ("norm1_q", "norm1_k", "norm1_v"):
            sd[f"attn_pool.{norm}.weight"] = to_tensor(pool[norm]["weight"])
            sd[f"attn_pool.{norm}.bias"] = to_tensor(pool[norm]["bias"])
        for name in ("q", "k", "v", "proj"):
            _linear(sd, f"attn_pool.{name}", pool[name])
            if pool[name].get("bias") is None:  # a checkpoint without one adds nothing
                w = sd[f"attn_pool.{name}.weight"]
                sd[f"attn_pool.{name}.bias"] = torch.zeros(w.shape[0], dtype=w.dtype)
    return sd


def tower_state_dict(tree: Dict[str, Any], family: str, cfg) -> Dict[str, torch.Tensor]:
    return iv2_state_dict(tree) if family == "internvideo2" else vit_state_dict(tree, cfg)


def projector_state_dict(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """fc1 and fc2, and fc0 first in a `fused_tome_mlp` projector."""
    sd: Dict[str, torch.Tensor] = {}
    if "fc0" in tree:
        _linear(sd, "fc0", tree["fc0"])
    _linear(sd, "fc1", tree["fc1"])
    _linear(sd, "fc2", tree["fc2"])
    return sd


def nano_state_dict(tree: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {"embeddings.weight": to_tensor(tree["embeddings"])}
    for i, (bt, layer) in enumerate(zip(cfg.layers_block_type, tree["layers"])):
        pre, mx = f"layers.{i}", layer["mixer"]
        sd[f"{pre}.norm.weight"] = to_tensor(layer["norm"]["weight"])
        if bt == "mamba":
            for role in mx["in_proj"]:  # gate/x/B/C/dt, or the one fused leaf
                _linear(sd, f"{pre}.mixer.in_proj.{role}", mx["in_proj"][role])
            for role in ("x", "B", "C"):
                cv = mx["conv1d"][role]
                sd[f"{pre}.mixer.conv1d.{role}.weight"] = to_tensor(cv["weight"])
                if cv.get("bias") is not None:
                    sd[f"{pre}.mixer.conv1d.{role}.bias"] = to_tensor(cv["bias"])
            for name in ("dt_bias", "A_log", "D"):
                sd[f"{pre}.mixer.{name}"] = to_tensor(mx[name])
            sd[f"{pre}.mixer.norm.weight"] = to_tensor(mx["norm"]["weight"])
            _linear(sd, f"{pre}.mixer.out_proj", mx["out_proj"])
        elif bt == "attention":
            for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
                _linear(sd, f"{pre}.mixer.{name}", mx[name])
        else:
            _linear(sd, f"{pre}.mixer.up_proj", mx["up_proj"])
            _linear(sd, f"{pre}.mixer.down_proj", mx["down_proj"])
    sd["norm_f.weight"] = to_tensor(tree["norm_f"]["weight"])
    if "lm_head" in tree:  # none with tied embeddings
        _linear(sd, "lm_head", tree["lm_head"])
    return sd


def qwen2_state_dict(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A qwen2 backbone: q/k/v biases where the tree has them, and no
    lm_head when the embeddings are tied (the tree then has none)."""
    sd: Dict[str, torch.Tensor] = {"embeddings.weight": to_tensor(tree["embeddings"])}
    for i, layer in enumerate(tree["layers"]):
        pre = f"layers.{i}"
        for norm in ("input_layernorm", "post_attention_layernorm"):
            sd[f"{pre}.{norm}.weight"] = to_tensor(layer[norm]["weight"])
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _linear(sd, f"{pre}.self_attn.{name}", layer["self_attn"][name])
        for name in ("gate_proj", "up_proj", "down_proj"):
            _linear(sd, f"{pre}.mlp.{name}", layer["mlp"][name])
    sd["norm_f.weight"] = to_tensor(tree["norm_f"]["weight"])
    if "lm_head" in tree:
        _linear(sd, "lm_head", tree["lm_head"])
    return sd


def merge_state_dict(merge_modules) -> Dict[str, torch.Tensor]:
    """The TransV list (None for a stage without a module) -> a
    models/pdrop.py:MergeModules state_dict, keyed by stage index."""
    sd: Dict[str, torch.Tensor] = {}
    for i, mm in enumerate(merge_modules):
        if mm is not None:
            sd[f"{i}.alpha"] = to_tensor(mm["alpha"]).float()
            for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
                _linear(sd, f"{i}.cross_attn.{name}", mm["cross_attn"][name])
    return sd


def from_jax_numpy(tree: Dict[str, Any], arch) -> Dict[str, torch.Tensor]:
    """The JAX VLM pytree (init_vlm_params's layout) -> TimeViperVLM state_dict."""
    llm = (qwen2_state_dict(tree["llm_backbone"]) if arch.llm_family == "qwen2"
           else nano_state_dict(tree["llm_backbone"], arch.llm))
    parts = [("llm_backbone", llm)]
    for key, family, cfg in arch.towers():
        vis, proj = tree["vision_backbone"], tree["projector"]
        dot = f".{key}" if key else ""
        if key:
            vis, proj = vis[key], proj[key]
        parts += [(f"vision_backbone{dot}", tower_state_dict(vis, family, cfg)),
                  (f"projector{dot}", projector_state_dict(proj))]
    if tree.get("merge_modules") is not None:
        parts.append(("merge_modules", merge_state_dict(tree["merge_modules"])))
    sd: Dict[str, torch.Tensor] = {}
    for prefix, part in parts:
        sd.update({f"{prefix}.{k}": v for k, v in part.items()})
    return sd
