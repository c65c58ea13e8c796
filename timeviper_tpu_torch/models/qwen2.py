"""Qwen2 / Qwen2.5 transformer backbone (counterpart of
timeviper_tpu/models/qwen2.py).

Pre-norm decoder blocks: RMSNorm, GQA attention with q/k/v biases and RoPE
(ops/rope.py), RMSNorm, a SiLU-gated MLP; logits in float32, from `lm_head`
or, with tied embeddings, from the embedding table. Modules hold the weights
under the JAX package's names (params.py maps one onto the other); the
forward passes are plain functions named as in the JAX package:

* `qwen2_forward` (prefill and training): positions restart at each packed
  segment (the bucketed prefill's left pad, segment -1, is a segment of its
  own, so the first real token sits at position 0); each layer's causal,
  segment-masked attention runs on q and k after RoPE through
  ops/flash_attention.py (K2 on the card, and under autograd K2-bwd for its
  backward). With `remat` each layer is checkpointed under one of the JAX
  package's remat policies ("full": only its input kept; "scan", "dots",
  "dots_scan": models/remat.py, the attention output being the named one).
  With a `pdrop_spec` the stages run
  before their layers and the positions are numbered again over the kept
  rows.
* `qwen2_decode_step`: one token per row. It rotates at the logical position
  `length - valid_from`, writes its K/V in place at `length` and attends
  over the slots [valid_from, length]: K9's non-causal mode
  (ops/block_attention.py) for one length shared by the batch (the
  Generator), the plain masked attention for (B,) lengths (the engine's
  slots).

Where the port leaves the JAX code behind, and why:

* The JAX forward computes attention as a dense masked einsum; here it is
  K2 on the card, the same function.
* A linear with a bias rounds once (nn.Linear), where the JAX package rounds
  the product and then the sum: about one bf16 ulp apart, equal in float32.
* After a pdrop prefill each layer's cache records its own row count
  `kv_len`, as the Nemotron-H path's does (models/nano.py), and the decode
  and the continuation write, mask and rotate each layer at it: a layer
  before a stage holds the pre-drop rows, and its next token sits at
  position kv_len - valid_from. The JAX qwen2 decode writes every layer at
  the post-drop length instead, which overwrites a live pre-drop row and
  masks the rest, the fault the JAX package repaired for its Nemotron-H path
  (tests/test_pdrop.py:test_pdrop_decode_with_attention_before_stage). Where
  no layer precedes a stage the two agree; elsewhere the port agrees with a
  teacher-forced pdrop forward (tests/test_torch_qwen2_generate.py).

W8A8 serving (train/quantize.py, ops/int8_linear.py), as the JAX qwen2's
`_apply_linear` takes int8 leaves (timeviper_tpu/models/qwen2.py:32-41):
`quantize_params_int8` swaps every linear of at least `min_size` weights
(q/k/v with their biases, which stay in the model's dtype and are added
after the int8 product's f32 rescale has rounded to it, as JAX
ops/int8_linear.py:69-70 adds them), `calibrate_act_scales` gives each one
its act_inv, and TIMEVIPER_LLM_INT8_MXU (default "auto": the int8 product
on the card, the dequantized weight on the CPU) switches the product; an
int8 lm_head gives f32 logits from its dequantized weight (`compute_logits`,
:241-251). tests/test_torch_qwen2_int8.py holds it against the JAX package.

Not ported: the JAX forward's `attention_mask` and `position_ids`
arguments, which no serving or training path passes.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from timeviper_tpu_torch.config import Qwen2Config
from timeviper_tpu_torch.models.nano import RMSNorm, kv_cache_buffers
from timeviper_tpu_torch.models.remat import Parts, remat_policy, run_block, run_parts
from timeviper_tpu_torch.models.pdrop import (
    apply_pdrop_stage,
    cached_merges,
    merge_dropped_cached,
)
from timeviper_tpu_torch.ops.attention import attention
from timeviper_tpu_torch.ops.block_attention import block_attn_lse
from timeviper_tpu_torch.ops.flash_attention import flash_attention
from timeviper_tpu_torch.ops.int8_linear import LLM_SWITCH, Int8Linear
from timeviper_tpu_torch.ops.norms import rms_norm
from timeviper_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from timeviper_tpu_torch.parallel.tensor_parallel import vocab_logits

# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class Qwen2Attention(nn.Module):
    def __init__(self, cfg: Qwen2Config, dtype, device):
        super().__init__()
        d, hd = cfg.hidden_size, cfg.head_dim
        kw = dict(dtype=dtype, device=device)
        self.q_proj = nn.Linear(d, cfg.num_attention_heads * hd, bias=cfg.attention_bias, **kw)
        self.k_proj = nn.Linear(d, cfg.num_key_value_heads * hd, bias=cfg.attention_bias, **kw)
        self.v_proj = nn.Linear(d, cfg.num_key_value_heads * hd, bias=cfg.attention_bias, **kw)
        self.o_proj = nn.Linear(cfg.num_attention_heads * hd, d, bias=False, **kw)


class Qwen2MLP(nn.Module):
    def __init__(self, cfg: Qwen2Config, dtype, device):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device)
        self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)


class Qwen2Layer(nn.Module):
    def __init__(self, cfg: Qwen2Config, dtype, device):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, device)
        self.self_attn = Qwen2Attention(cfg, dtype, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, device)
        self.mlp = Qwen2MLP(cfg, dtype, device)


class Qwen2Model(nn.Module):
    INT8_SWITCH = LLM_SWITCH  # the int8 path's switch (ops/int8_linear.py)

    def __init__(self, cfg: Qwen2Config, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dtype,
                                       device=device)
        self.layers = nn.ModuleList(Qwen2Layer(cfg, dtype, device)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm_f = RMSNorm(cfg.hidden_size, device)
        self.lm_head = (None if cfg.tie_word_embeddings else
                        nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, dtype=dtype,
                                  device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights drawn as the JAX init draws them (qwen2.py:55-91):
        linears N(0, 0.02), down_proj N(0, 0.02 / sqrt(layers)), biases 0,
        norms 1, embeddings N(0, 0.02)."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, 0.02, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)
        for layer in self.layers:
            layer.mlp.down_proj.weight.normal_(
                0.0, 0.02 / math.sqrt(self.cfg.num_hidden_layers), generator=generator)
        self.embeddings.weight.normal_(0.0, 0.02, generator=generator)


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------


def build_positions(seq_idx: Optional[torch.Tensor], B: int, L: int, device) -> torch.Tensor:
    """(B, L) positions that restart at each packed segment: the row index
    less the running maximum of the segment starts (qwen2.py:148-159)."""
    ar = torch.arange(L, device=device)[None]
    if seq_idx is None:
        return ar.expand(B, L)
    start = torch.cat([torch.zeros(B, 1, dtype=torch.bool, device=device),
                       seq_idx[:, 1:] != seq_idx[:, :-1]], dim=1)
    return ar - torch.where(start, ar, 0).cummax(dim=1).values


def project_qkv(attn: Qwen2Attention, cfg: Qwen2Config, x: torch.Tensor,
                positions: torch.Tensor):
    """q (B, S, Hq, hd) and k (B, S, Hkv, hd) after RoPE at `positions`
    (B, S), and v."""
    B, S, _ = x.shape
    Hq, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    q = apply_rope(attn.q_proj(x).reshape(B, S, Hq, hd), cos, sin)
    k = apply_rope(attn.k_proj(x).reshape(B, S, Hkv, hd), cos, sin)
    return q, k, attn.v_proj(x).reshape(B, S, Hkv, hd)


def mlp_forward(mlp: Qwen2MLP, x: torch.Tensor) -> torch.Tensor:
    return mlp.down_proj(F.silu(mlp.gate_proj(x)) * mlp.up_proj(x))


def attention_decode(attn: Qwen2Attention, cfg: Qwen2Config, x: torch.Tensor,
                     cache_layer: Dict[str, Any], length, valid_from=0
                     ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token x (B, 1, D) against the layer's fixed-capacity K/V buffers:
    rotated at position length - valid_from, its K/V written IN PLACE at slot
    `length`, attending over the slots [valid_from, length]. `length` and
    `valid_from` are host integers shared by the batch (K9's non-causal mode
    over that slice), or (B,) integer tensors, one per row (each row's K/V
    scattered at its own slot, the plain attention under a per-row key mask
    over the slots up to the longest row's). A layer whose entry holds
    `kv_len` (after a pdrop prefill) takes it in place of `length` and
    returns it one more."""
    B = x.shape[0]
    k, v = cache_layer["k"], cache_layer["v"]
    kv_len = cache_layer.get("kv_len")
    if kv_len is not None:
        length = kv_len
        cache_layer = {**cache_layer, "kv_len": kv_len + 1}
    if isinstance(length, torch.Tensor):
        vf = torch.as_tensor(valid_from).to(k.device, torch.long).expand(B)
        pos = length.to(k.device, torch.long)
        positions = (pos - vf)[:, None]
    else:
        positions = torch.full((B, 1), length - valid_from, dtype=torch.long, device=k.device)
    q, k_new, v_new = project_qkv(attn, cfg, x, positions)
    if not isinstance(length, torch.Tensor):
        if length >= k.shape[1]:
            raise ValueError(f"KV cache of {k.shape[1]} slots is full")
        k[:, length] = k_new[:, 0].to(k.dtype)
        v[:, length] = v_new[:, 0].to(v.dtype)
        out = block_attn_lse(q, k[:, valid_from:length + 1], v[:, valid_from:length + 1])[0]
        return attn.o_proj(out.reshape(B, 1, -1)), cache_layer
    span = int(length.max()) + 1
    if span > k.shape[1]:
        raise ValueError(f"KV cache of {k.shape[1]} slots is full")
    rows = torch.arange(B, device=k.device)
    k[rows, pos] = k_new[:, 0].to(k.dtype)
    v[rows, pos] = v_new[:, 0].to(v.dtype)
    slots = torch.arange(span, device=k.device)[None]
    mask = (slots <= pos[:, None]) & (slots >= vf[:, None])  # (B, span)
    out = attention(q, k[:, :span], v[:, :span], mask[:, None])
    return attn.o_proj(out.reshape(B, 1, -1)), cache_layer


def layer_parts(layer: Qwen2Layer, cfg: Qwen2Config, positions: torch.Tensor,
                seq_idx: Optional[torch.Tensor], cache: Optional[Dict[str, Any]] = None,
                max_len: int = 0) -> Parts:
    """One pre-norm layer cut at its attention (models/remat.py): pre the
    input norm, q/k/v and RoPE; mixer the causal, segment-masked flash path
    (K2), where a `cache` dict gets the K/V buffers of `max_len` slots; post
    o_proj and the residual, then the MLP on its own norm and residual."""
    eps = cfg.rms_norm_eps

    def pre(h):
        return project_qkv(layer.self_attn, cfg, rms_norm(h, layer.input_layernorm.weight, eps),
                           positions)

    def mixer(q, k, v):
        if cache is not None:
            cache.update(kv_cache_buffers(k, v, max_len))
        return flash_attention(q, k, v, segment_ids=seq_idx)

    def post(h, o, q, k, v):
        h = h + layer.self_attn.o_proj(o.reshape(*h.shape[:2], -1))
        return h + mlp_forward(layer.mlp, rms_norm(h, layer.post_attention_layernorm.weight,
                                                   eps))

    return pre, mixer, post


def _layer_forward(layer: Qwen2Layer, cfg: Qwen2Config, hidden: torch.Tensor,
                   positions: torch.Tensor, seq_idx: Optional[torch.Tensor],
                   fill_cache: bool = False, max_len: int = 0
                   ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """(the layer's output, its decode cache entry with `fill_cache`)."""
    cache = {} if fill_cache else None
    return run_parts(layer_parts(layer, cfg, positions, seq_idx, cache, max_len), hidden), cache


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def qwen2_forward(
    model: Qwen2Model,
    cfg: Qwen2Config,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    seq_idx: Optional[torch.Tensor] = None,
    fill_cache: bool = False,
    cache_max_len: int = 0,
    logits_to_keep: int = 0,
    valid_from: int = 0,
    labels: Optional[torch.Tensor] = None,
    remat=False,
    pdrop_spec=None,
    pdrop_params=None,
) -> Dict[str, Any]:
    """Full-sequence forward (prefill or training). Returns {"hidden_states",
    "logits", "labels"} (the labels passed through, as the JAX forward
    returns them) and, with `fill_cache`, the decode `cache`.
    `logits_to_keep` > 0 computes the f32 logits of the last rows only.
    `remat` (True or a policy, models/remat.py) checkpoints each layer
    (qwen2.py:215-218). `pdrop_spec`
    (models/pdrop.py, shared by the B rows) runs the config's stages before
    their layers, outside the layers' checkpoints, with the TransV modules
    `pdrop_params`; a filled cache then records each layer's `kv_len` and
    each stage's `ca_kv` (qwen2.py:186-238)."""
    policy = remat_policy(remat)
    hidden = model.embeddings(input_ids) if inputs_embeds is None else inputs_embeds
    B, L, _ = hidden.shape
    eps = cfg.rms_norm_eps
    positions = build_positions(seq_idx, B, L, hidden.device)
    stages = ({st.layer: (i, st) for i, st in enumerate(cfg.pdrop_stages)}
              if pdrop_spec is not None else {})
    new_layers, ca_kvs = [], []
    for idx, layer in enumerate(model.layers):
        if idx in stages:
            si, st = stages[idx]
            hidden, labels, seq_idx, pdrop_spec, ca_kv = apply_pdrop_stage(
                hidden, labels, seq_idx, pdrop_spec, st, si, cfg=cfg,
                attn_mixer=layer.self_attn if st.compress_type == "attn" else None,
                merge=pdrop_params)
            ca_kvs.append(ca_kv or {})
            positions = build_positions(seq_idx, B, hidden.shape[1], hidden.device)
        if policy and not fill_cache:
            hidden = run_block(layer_parts(layer, cfg, positions, seq_idx), hidden, policy)
            lc = None
        else:
            hidden, lc = _layer_forward(layer, cfg, hidden, positions, seq_idx, fill_cache,
                                        cache_max_len)
        if fill_cache and pdrop_spec is not None:
            lc["kv_len"] = hidden.shape[1]
        new_layers.append(lc or {})
    hidden = rms_norm(hidden, model.norm_f.weight, eps)
    logits = compute_logits(model, hidden[:, -logits_to_keep:] if logits_to_keep else hidden)
    out = {"hidden_states": hidden, "logits": logits, "labels": labels}
    if fill_cache:
        out["cache"] = {"layers": new_layers, "length": hidden.shape[1],
                        "valid_from": int(valid_from)}
        if ca_kvs:
            out["cache"]["ca_kv"] = ca_kvs
    return out


def compute_logits(model: Qwen2Model, hidden: torch.Tensor) -> torch.Tensor:
    """f32 logits (..., V) of hidden rows (B, D) or (B, S, D) (the verify
    pass's): from lm_head, an int8 lm_head by its f32 dequant, or the
    embedding table when the embeddings are tied (qwen2.py:241-251); a
    vocabulary split over a model axis is gathered whole."""
    lm = model.lm_head
    if lm is None:
        w, owner = model.embeddings.weight.float(), model.embeddings
    else:
        w = lm.f32_weight() if isinstance(lm, Int8Linear) else lm.weight.float()
        owner = lm
    return vocab_logits(hidden, w, owner)


def qwen2_decode_step(
    model: Qwen2Model, cfg: Qwen2Config, input_ids: torch.Tensor, cache: Dict[str, Any],
    pdrop_params=None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. input_ids (B, 1). Returns (logits (B, V) f32, cache
    with length one more). The cache's `length` and `valid_from` are host
    integers or (B,) tensors (attention_decode). A cache from a pdrop
    prefill with TransV (`ca_kv`) and the merge modules `pdrop_params` merge
    the token again at each stage's layer (qwen2.py:276-300)."""
    hidden = model.embeddings(input_ids)
    length, valid_from = cache["length"], cache["valid_from"]
    eps = cfg.rms_norm_eps
    merges = cached_merges(cfg, cache, pdrop_params)
    new_layers = []
    for idx, (layer, lc) in enumerate(zip(model.layers, cache["layers"])):
        if idx in merges:
            hidden = merge_dropped_cached(hidden, *merges[idx], cfg)
        a, lc = attention_decode(layer.self_attn, cfg,
                                 rms_norm(hidden, layer.input_layernorm.weight, eps), lc,
                                 length, valid_from)
        hidden = hidden + a
        hidden = hidden + mlp_forward(
            layer.mlp, rms_norm(hidden, layer.post_attention_layernorm.weight, eps))
        new_layers.append(lc)
    logits = compute_logits(model, rms_norm(hidden[:, 0], model.norm_f.weight, eps))
    new_cache = {"layers": new_layers, "length": length + 1, "valid_from": valid_from}
    if "ca_kv" in cache:
        new_cache["ca_kv"] = cache["ca_kv"]
    return logits, new_cache
