"""Continuation on a filled decode cache: ask several questions of one video
without running its prefill again (counterpart of
timeviper_tpu/models/prefix_cache.py, its Nemotron-H path).

`nano_forward_continue` runs S suffix tokens (a question, or the next clip of
a streamed video) on top of a cache that holds `length` processed tokens:

* Mamba layers continue exactly: the conv reads the cache's rolling window of
  raw inputs (ops/conv.py:init_conv_state layout) before the suffix, and the
  SSD scan (K1 on the card) starts from the cached `ssm_state`.
* Attention layers append the suffix's K/V rows at [length, length + S) of a
  copy of the layer's buffers. The suffix's queries attend the prefix rows
  [valid_from, length) in one non-causal block and their own rows in one
  causal block; both are ops/block_attention.py:block_attn_lse (K9 on the
  card), and the two parts merge by their row sums and maxima.

Nemotron-H attention has no RoPE, so a continuation computes the same
function as one prefill of prefix and suffix together.

Where the port leaves the JAX code behind, and why:

* Only the real suffix runs. `length` and the suffix length are host
  integers here (models/cache.py), so there are no trailing pads: the JAX
  machinery that makes pads inert for XLA's static shapes (dt activated
  before the kernel and zeroed at the pads, the conv window sliced at the
  real length) has nothing to do. The result at the real rows, the updated
  cache and the new length are JAX's.
* One suffix-attention path for every S. JAX scans the keys with an
  online softmax for short suffixes only because its TPU kernel needed
  S >= 256 and 256-aligned shapes; K9 needs neither, and the scan computes
  the same function. The prefix part reads exactly the filled rows, so the
  JAX `kv_bucket` cap on attended rows has no counterpart.
* The input cache is never written. One cache serves any number of
  questions, in any order, as JAX's immutable pytree does: the attention
  layers' K/V buffers are copied before the suffix rows are written (the
  decode step writes rows in place, models/nano.py), and the Mamba states
  are new tensors.

A cache from a pdrop prefill (models/pdrop.py) continues too: an attention
layer appends at its own `kv_len` (a layer before a stage holds the pre-drop
rows), and with the merge modules the suffix rows cross-attend each stage's
cached TransV K/V (`ca_kv`) before its layer
(timeviper_tpu/models/prefix_cache.py:294-329, :456-470).

`qwen2_forward_continue` is the Qwen2 counterpart: every layer is an
attention layer, and suffix row i rotates at the logical position
(length - valid_from) + i, as the decode step rotates its token
(timeviper_tpu/models/prefix_cache.py:333-420). After a pdrop prefill a
layer's own `kv_len` takes the place of `length` in the position too
(models/qwen2.py says why).

The speculative verify pass (models/speculative.py) runs through both
continuations: `logits_all=True` returns the f32 logits of every suffix row,
and `chunk_size` overrides the config's SSD chunk as in the JAX package. JAX
passes `chunk_size=S` only to keep its padded S-row scan off the Pallas grid;
here only the S real rows run, and a suffix that fits one chunk of both sizes
is one chunk at either: it runs at the config's chunk, the one K1 takes (K1
refuses a chunk that is not a multiple of 64 in 64-1,024). A longer suffix
runs at the override.

Not ported yet: a cache with slot-validity masks (`kv_valid`, made only by
the sequence-parallel masked prefill), which raises NotImplementedError.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from timeviper_tpu_torch.config import NanoConfig
from timeviper_tpu_torch.models.nano import (
    AttentionMixer,
    MambaMixer,
    compute_logits,
    mamba_in_proj,
    mlp_mixer_forward,
)
from timeviper_tpu_torch.models.pdrop import cached_merges, merge_dropped_cached
from timeviper_tpu_torch.ops.block_attention import block_attn_lse, merge_parts
from timeviper_tpu_torch.ops.conv import causal_conv1d
from timeviper_tpu_torch.models.qwen2 import Qwen2Attention, project_qkv, mlp_forward
from timeviper_tpu_torch.models.qwen2 import compute_logits as qwen2_compute_logits
from timeviper_tpu_torch.ops.norms import gated_rms_norm, rms_norm
from timeviper_tpu_torch.ops.ssd_kernel import ssd_scan


def _conv_continue(raw: torch.Tensor, window: torch.Tensor, weight, bias, activation):
    """The causal conv of `raw` (B, S, C) continued from the rolling window
    (B, C, K) of the K raw inputs before it, oldest first. Returns (the
    conv's output (B, S, C), the new window of the last K raw inputs)."""
    K = window.shape[-1]
    ext = torch.cat([window[..., 1:].transpose(1, 2).to(raw.dtype), raw], dim=1)
    out = causal_conv1d(ext, weight, bias, activation)[:, K - 1:]
    return out, ext[:, -K:].transpose(1, 2).to(window.dtype).contiguous()


def scan_chunk(cfg: NanoConfig, S: int, chunk_size: Optional[int] = None) -> int:
    """The SSD chunk of an S-row continuation: `chunk_size` where given,
    except that a suffix of at most both sizes is one chunk at either and
    takes the config's."""
    if chunk_size is None or S <= min(chunk_size, cfg.chunk_size):
        return cfg.chunk_size
    return chunk_size


def _mamba_continue(m: MambaMixer, cfg: NanoConfig, x: torch.Tensor,
                    cache_layer: Dict[str, Any], chunk_size: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """x (B, S, D) normed rows that follow those the cache entry has seen ->
    (out (B, S, D), new cache entry). An `ssm_state` of None starts from
    zero; longctx.py runs its chunks through here."""
    B, S, _ = x.shape
    di = cfg.mamba_intermediate_size
    G, N, H, P = cfg.mamba_n_groups, cfg.ssm_state_size, cfg.mamba_num_heads, cfg.mamba_head_dim
    gate, xr, Br, Cr, dt = mamba_in_proj(m, cfg, x)
    cv, cs, act = m.conv1d, cache_layer["conv_state"], cfg.mamba_hidden_act
    xs, win_x = _conv_continue(xr, cs["x"], cv["x"].weight, cv["x"].bias, act)
    Bs, win_B = _conv_continue(Br, cs["B"], cv["B"].weight, cv["B"].bias, act)
    Cs, win_C = _conv_continue(Cr, cs["C"], cv["C"].weight, cv["C"].bias, act)
    y, final_state = ssd_scan(
        xs.reshape(B, S, H, P), dt, -torch.exp(m.A_log), Bs.reshape(B, S, G, N),
        Cs.reshape(B, S, G, N), chunk_size=scan_chunk(cfg, S, chunk_size), D=m.D,
        dt_bias=m.dt_bias, dt_limit=cfg.time_step_limit, initial_state=cache_layer["ssm_state"])
    y = gated_rms_norm(y.reshape(B, S, di), gate, m.norm.weight, eps=cfg.layer_norm_epsilon,
                       group_size=di // G)
    return m.out_proj(y), {"conv_state": {"x": win_x, "B": win_B, "C": win_C},
                           "ssm_state": final_state}


def attention_suffix(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length: int,
                     valid_from: int = 0) -> torch.Tensor:
    """Attention of S suffix queries q (B, S, Hq, hd) over a cache buffer k,
    v (B, M, Hkv, hd) whose rows [length, length + S) already hold the
    suffix's own K/V: query i sees rows [valid_from, length + i]. Two K9
    blocks, merged by (l, m) (ops/block_attention.py:merge_parts)."""
    S = q.shape[1]
    prefix = block_attn_lse(q, k[:, valid_from:length], v[:, valid_from:length], causal=False)
    own = block_attn_lse(q, k[:, length:length + S], v[:, length:length + S], causal=True)
    return merge_parts([prefix, own])[0]


def _append_kv(cache_layer: Dict[str, Any], k_new: torch.Tensor, v_new: torch.Tensor,
               length: int) -> Dict[str, Any]:
    """The layer's cache entry with the suffix's K/V rows written at
    [length, length + S) of copies of its buffers. A pdrop entry's `kv_len`
    grows by S."""
    S = k_new.shape[1]
    if length + S > cache_layer["k"].shape[1]:
        raise ValueError(f"a suffix of {S} rows after {length} overflows the cache's "
                         f"{cache_layer['k'].shape[1]} slots")
    k, v = cache_layer["k"].clone(), cache_layer["v"].clone()
    k[:, length:length + S] = k_new.to(k.dtype)
    v[:, length:length + S] = v_new.to(v.dtype)
    lc = {"k": k, "v": v}
    if "kv_len" in cache_layer:
        lc["kv_len"] = length + S
    return lc


def _attention_continue(m: AttentionMixer, cfg: NanoConfig, x: torch.Tensor,
                        cache_layer: Dict[str, Any], length: int, valid_from: int
                        ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """x (B, S, D) normed suffix -> (out (B, S, D), a new cache entry with the
    suffix rows written, `_append_kv`). A layer's own `kv_len` (after a pdrop
    prefill) takes the place of `length`."""
    B, S, _ = x.shape
    Hq, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    length = cache_layer.get("kv_len", length)
    q = m.q_proj(x).reshape(B, S, Hq, hd)
    lc = _append_kv(cache_layer, m.k_proj(x).reshape(B, S, Hkv, hd),
                    m.v_proj(x).reshape(B, S, Hkv, hd), length)
    out = attention_suffix(q, lc["k"], lc["v"], length, valid_from)
    return m.o_proj(out.reshape(B, S, Hq * hd)), lc


def _refuse_unported(cache: Dict[str, Any]) -> None:
    if "kv_valid" in cache or any("kv_valid" in lc for lc in cache["layers"]):
        raise NotImplementedError("a cache with slot-validity masks (kv_valid, the "
                                  "sequence-parallel masked prefill's) is not ported")


@torch.no_grad()
def nano_forward_continue(model, cfg: NanoConfig, inputs_embeds: torch.Tensor,
                          cache: Dict[str, Any], pdrop_params=None, logits_all: bool = False,
                          chunk_size: Optional[int] = None
                          ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run a suffix on top of a filled cache. inputs_embeds (B, S, D) holds
    the S real suffix rows, no pads. Returns (the f32 logits (B, V) of its
    last row, or (B, S, V) of every row with `logits_all`, the updated cache
    with length += S). The input cache is left untouched. `pdrop_params`
    (the merge modules) merge the suffix rows with a pdrop cache's `ca_kv`;
    `chunk_size` overrides the SSD chunk (`scan_chunk`)."""
    _refuse_unported(cache)
    S = inputs_embeds.shape[1]
    length, valid_from = int(cache["length"]), int(cache["valid_from"])
    eps = cfg.layer_norm_epsilon
    hidden = inputs_embeds
    merges = cached_merges(cfg, cache, pdrop_params)
    new_layers = []
    for idx, (block, lc) in enumerate(zip(model.layers, cache["layers"])):
        if idx in merges:
            hidden = merge_dropped_cached(hidden, *merges[idx], cfg)
        normed = rms_norm(hidden, block.norm.weight, eps)
        if block.block_type == "mamba":
            out, lc = _mamba_continue(block.mixer, cfg, normed, lc, chunk_size)
        elif block.block_type == "attention":
            out, lc = _attention_continue(block.mixer, cfg, normed, lc, length, valid_from)
        else:
            out, lc = mlp_mixer_forward(block.mixer, cfg, normed), {}
        hidden = hidden + out
        new_layers.append(lc)
    hidden = rms_norm(hidden if logits_all else hidden[:, -1], model.norm_f.weight, eps)
    new_cache = {"layers": new_layers, "length": length + S, "valid_from": valid_from}
    if "ca_kv" in cache:
        new_cache["ca_kv"] = cache["ca_kv"]
    return compute_logits(model, hidden), new_cache


def _qwen2_attention_continue(attn: Qwen2Attention, cfg, x: torch.Tensor,
                              cache_layer: Dict[str, Any], length: int, valid_from: int
                              ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """x (B, S, D) normed suffix -> (out (B, S, D), a new cache entry with the
    suffix's K/V, after RoPE at (length - valid_from) + i, written at
    [length, length + S), `_append_kv`). A layer's own `kv_len` takes the
    place of `length`."""
    B, S, _ = x.shape
    length = cache_layer.get("kv_len", length)
    positions = (length - valid_from) + torch.arange(S, device=x.device)[None].expand(B, S)
    q, k_new, v_new = project_qkv(attn, cfg, x, positions)
    lc = _append_kv(cache_layer, k_new, v_new, length)
    out = attention_suffix(q, lc["k"], lc["v"], length, valid_from)
    return attn.o_proj(out.reshape(B, S, -1)), lc


@torch.no_grad()
def qwen2_forward_continue(model, cfg, inputs_embeds: torch.Tensor, cache: Dict[str, Any],
                           pdrop_params=None, logits_all: bool = False,
                           chunk_size: Optional[int] = None
                           ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the S real suffix rows inputs_embeds (B, S, D) on top of a filled
    qwen2 cache. Returns (the f32 logits (B, V) of the last row, or (B, S, V)
    of every row with `logits_all`, the updated cache with length += S); the
    input cache is left untouched. `pdrop_params` (the merge modules) merge
    the suffix rows with a pdrop cache's `ca_kv`. `chunk_size` is accepted for the speculative loop's one call and unused: the backbone
    has no SSD scan."""
    _refuse_unported(cache)
    S = inputs_embeds.shape[1]
    length, valid_from = int(cache["length"]), int(cache["valid_from"])
    eps = cfg.rms_norm_eps
    hidden = inputs_embeds
    merges = cached_merges(cfg, cache, pdrop_params)
    new_layers = []
    for idx, (layer, lc) in enumerate(zip(model.layers, cache["layers"])):
        if idx in merges:
            hidden = merge_dropped_cached(hidden, *merges[idx], cfg)
        a, lc = _qwen2_attention_continue(
            layer.self_attn, cfg, rms_norm(hidden, layer.input_layernorm.weight, eps), lc,
            length, valid_from)
        hidden = hidden + a
        hidden = hidden + mlp_forward(
            layer.mlp, rms_norm(hidden, layer.post_attention_layernorm.weight, eps))
        new_layers.append(lc)
    hidden = rms_norm(hidden if logits_all else hidden[:, -1], model.norm_f.weight, eps)
    new_cache = {"layers": new_layers, "length": length + S, "valid_from": valid_from}
    if "ca_kv" in cache:
        new_cache["ca_kv"] = cache["ca_kv"]
    return qwen2_compute_logits(model, hidden), new_cache


def forward_continue(arch):
    """The continuation of the arch's backbone family."""
    return qwen2_forward_continue if arch.llm_family == "qwen2" else nano_forward_continue
