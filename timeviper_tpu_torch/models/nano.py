"""Nemotron-H hybrid backbone: Mamba-2 / attention / MLP layers (counterpart of
timeviper_tpu/models/nano.py).

Modules hold the weights under the JAX package's names (params.py maps one
onto the other); the forward passes are plain functions named as in the JAX
package:

* `nano_forward` (prefill and training): Mamba layers run the chunked SSD
  scan (ops/ssd_kernel.py, kernels K1 / K4 on the card), attention layers
  causal packed attention (ops/flash_attention.py, kernels K2 / K2-bwd on
  the card); with `fill_cache` it also returns the decode cache, with
  `remat` each block is checkpointed under one of the JAX package's remat
  policies ("full", "scan", "dots", "dots_scan"; models/remat.py).
* `nano_decode_step`: one token; Mamba layers take the O(1) state update,
  attention layers write their KV buffer in place at `length` and attend
  over the slots [valid_from, length]. `length` and `valid_from` are host
  integers, or (B,) tensors with one per row (the serving engine).

Attention has no RoPE; the MLP is up -> relu^2 -> down. Head h of a Mamba
layer reads group h // (H/G). Linear weights are torch's (out, in); a LoRA'd
linear (train/lora.py) adds its delta in its own forward, an int8 one
(ops/int8_linear.py:Int8Linear, train/quantize.py) its W8A8 or weight-only
product.

Two switches of the JAX package choose fused kernels, read as it reads them
(timeviper_tpu/models/nano.py:257-262, :342-344):
* `fused_conv` (the Generator passes TIMEVIPER_FUSED_CONV): a Mamba prefill
  with d_conv 4 and a chunk size that is a multiple of 128 runs the conv,
  SiLU and scan as one call, ops/ssd_kernel.py:ssd_conv_scan_fused (K5);
* TIMEVIPER_FUSED_DECODE=1: a decode step whose shapes pass
  fused_mamba_decode_supported and whose x conv has a bias runs the x conv,
  the state update and the gated norm as one call, ops/decode_fused.py (K7).
Where the JAX package also asks for the TPU, the port asks nothing more: a
CPU tensor takes the fused call's plain version, a CUDA tensor its kernel.

pdrop (models/pdrop.py): with a `pdrop_spec`, each stage runs before its
layer and the row shrinks. The attention layers' caches then record their
own row count `kv_len` (a layer before a stage holds the pre-drop rows), the
decode writes and masks each layer at its `kv_len`, and the cache keeps each
stage's TransV K/V (`ca_kv`), which every decoded token cross-attends at the
stage's layer (`nano_decode_step(pdrop_params=...)`).
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from timeviper_tpu_torch.config import NanoConfig
from timeviper_tpu_torch.models.pdrop import (
    apply_pdrop_stage,
    cached_merges,
    merge_dropped_cached,
)
from timeviper_tpu_torch.models.remat import Parts, remat_policy, run_block, run_parts
from timeviper_tpu_torch.ops.attention import attention
from timeviper_tpu_torch.ops.block_attention import block_attn_lse
from timeviper_tpu_torch.ops.conv import causal_conv1d, causal_conv1d_update, init_conv_state
from timeviper_tpu_torch.ops.decode_fused import fused_mamba_decode, fused_mamba_decode_supported
from timeviper_tpu_torch.ops.flash_attention import flash_attention
from timeviper_tpu_torch.ops.int8_linear import LLM_SWITCH, Int8Linear
from timeviper_tpu_torch.ops.norms import gated_rms_norm, rms_norm
from timeviper_tpu_torch.ops.ssd import _process_dt, ssd_update_step
from timeviper_tpu_torch.ops.ssd_kernel import ssd_conv_scan_fused, ssd_scan
from timeviper_tpu_torch.parallel.tensor_parallel import vocab_logits

# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    """Holds a float32 norm weight (the JAX `{"weight": ...}` leaf)."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, dtype=torch.float32, device=device))


class ConvWeights(nn.Module):
    """Depthwise conv taps (channels, K) and bias (channels,), float32."""

    def __init__(self, channels: int, K: int, bias: bool, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(channels, K, dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.zeros(channels, dtype=torch.float32, device=device))
                     if bias else None)


class MambaMixer(nn.Module):
    def __init__(self, cfg: NanoConfig, dtype, device):
        super().__init__()
        d, di, H = cfg.hidden_size, cfg.mamba_intermediate_size, cfg.mamba_num_heads
        gn = cfg.mamba_n_groups * cfg.ssm_state_size
        kw = dict(bias=cfg.use_bias, dtype=dtype, device=device)
        # in_proj stays split by role, as in the JAX pytree
        self.in_proj = nn.ModuleDict({
            "gate": nn.Linear(d, di, **kw), "x": nn.Linear(d, di, **kw),
            "B": nn.Linear(d, gn, **kw), "C": nn.Linear(d, gn, **kw),
            "dt": nn.Linear(d, H, **kw),
        })
        K, cb = cfg.mamba_d_conv, cfg.use_conv_bias
        self.conv1d = nn.ModuleDict({
            "x": ConvWeights(di, K, cb, device), "B": ConvWeights(gn, K, cb, device),
            "C": ConvWeights(gn, K, cb, device),
        })
        f32 = dict(dtype=torch.float32, device=device)
        self.dt_bias = nn.Parameter(torch.zeros(H, **f32))
        self.A_log = nn.Parameter(torch.zeros(H, **f32))
        self.D = nn.Parameter(torch.ones(H, **f32))
        self.norm = RMSNorm(di, device)
        self.out_proj = nn.Linear(di, d, **kw)


class AttentionMixer(nn.Module):
    def __init__(self, cfg: NanoConfig, dtype, device):
        super().__init__()
        d, hd = cfg.hidden_size, cfg.head_dim
        kw = dict(bias=cfg.attention_bias, dtype=dtype, device=device)
        self.q_proj = nn.Linear(d, cfg.num_attention_heads * hd, **kw)
        self.k_proj = nn.Linear(d, cfg.num_key_value_heads * hd, **kw)
        self.v_proj = nn.Linear(d, cfg.num_key_value_heads * hd, **kw)
        self.o_proj = nn.Linear(cfg.num_attention_heads * hd, d, **kw)


class MLPMixer(nn.Module):
    def __init__(self, cfg: NanoConfig, dtype, device):
        super().__init__()
        kw = dict(bias=cfg.mlp_bias, dtype=dtype, device=device)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)


_MIXERS = {"mamba": MambaMixer, "attention": AttentionMixer, "mlp": MLPMixer}


class NanoBlock(nn.Module):
    def __init__(self, cfg: NanoConfig, block_type: str, dtype, device):
        super().__init__()
        self.block_type = block_type
        self.norm = RMSNorm(cfg.hidden_size, device)
        self.mixer = _MIXERS[block_type](cfg, dtype, device)


class NanoModel(nn.Module):
    INT8_SWITCH = LLM_SWITCH  # the int8 path's switch (ops/int8_linear.py)

    def __init__(self, cfg: NanoConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dtype,
                                       device=device)
        self.layers = nn.ModuleList(
            NanoBlock(cfg, bt, dtype, device) for bt in cfg.layers_block_type)
        self.norm_f = RMSNorm(cfg.hidden_size, device)
        # tied embeddings: no lm_head, the logits come from the embedding
        # table (timeviper_tpu/models/nano.py:162, :684)
        self.lm_head = (None if cfg.tie_word_embeddings else
                        nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, dtype=dtype,
                                  device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights drawn as the JAX init draws them (nano.py:55-164)."""
        cfg = self.cfg
        dev = self.embeddings.weight.device
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, 0.02, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)
            elif isinstance(mod, ConvWeights):
                mod.weight.normal_(0.0, 0.1, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
        self.embeddings.weight.normal_(0.0, 0.02, generator=generator)
        H = cfg.mamba_num_heads
        lo, hi = math.log(cfg.time_step_min), math.log(cfg.time_step_max)
        for block in self.layers:
            m = block.mixer
            if not isinstance(m, MambaMixer):
                continue
            # dt_bias: inverse softplus of a log-uniform dt
            u = torch.rand(H, generator=generator, device=dev)
            dt = torch.exp(u * (hi - lo) + lo).clamp(min=cfg.time_step_floor)
            m.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
            m.A_log.copy_(torch.log(torch.arange(1, H + 1, dtype=torch.float32, device=dev)))
            m.D.fill_(1.0)
            m.out_proj.weight.normal_(0.0, 0.02 / math.sqrt(cfg.num_hidden_layers),
                                      generator=generator)


# ---------------------------------------------------------------------------
# Layer applies
# ---------------------------------------------------------------------------


def mamba_in_proj(m: MambaMixer, cfg: NanoConfig, x: torch.Tensor):
    """(gate, x, B, C, dt) raw streams of the Mamba in-projection: five split
    linears, or the one `fused` linear of train/quantize.py:fuse_decode_in_proj
    (timeviper_tpu/models/nano.py:198)."""
    ip = m.in_proj
    if "fused" in ip:
        di, gn = cfg.mamba_intermediate_size, cfg.mamba_n_groups * cfg.ssm_state_size
        return ip["fused"](x).split([di, di, gn, gn, cfg.mamba_num_heads], dim=-1)
    return ip["gate"](x), ip["x"](x), ip["B"](x), ip["C"](x), ip["dt"](x)


def mamba_parts(m: MambaMixer, cfg: NanoConfig, seq_idx: Optional[torch.Tensor] = None,
                cache: Optional[Dict[str, Any]] = None, fused_conv: bool = False) -> Parts:
    """The full-sequence Mamba-2 mixer on x (B, L, D) as (pre, mixer, post)
    (models/remat.py:run_parts): pre the in-projections and the three convs,
    mixer the SSD scan (K1), post the gated norm and out_proj. A `cache` dict
    gets the decode state. `fused_conv` (inference only) leaves the convs to
    the scan, one call (K5), when the shapes allow it."""
    di = cfg.mamba_intermediate_size
    G, N, H, P = cfg.mamba_n_groups, cfg.ssm_state_size, cfg.mamba_num_heads, cfg.mamba_head_dim
    cv, act = m.conv1d, cfg.mamba_hidden_act
    fused = fused_conv and cfg.mamba_d_conv == 4 and cfg.chunk_size % 128 == 0

    def pre(x):
        gate, xr, Br, Cr, dt = mamba_in_proj(m, cfg, x)
        if cache is not None:
            K = cfg.mamba_d_conv
            cache["conv_state"] = {"x": init_conv_state(xr, K), "B": init_conv_state(Br, K),
                                   "C": init_conv_state(Cr, K)}
        if not fused:
            xr, Br, Cr = (causal_conv1d(s, cv[r].weight, cv[r].bias, act, seq_idx)
                          for r, s in zip("xBC", (xr, Br, Cr)))
        return xr, Br, Cr, dt, gate

    def mixer(xs, Bs, Cs, dt, gate):
        B, L, _ = xs.shape
        args = (xs.reshape(B, L, H, P), dt, -torch.exp(m.A_log), Bs.reshape(B, L, G, N),
                Cs.reshape(B, L, G, N))
        kw = dict(chunk_size=cfg.chunk_size, D=m.D, dt_bias=m.dt_bias,
                  dt_limit=cfg.time_step_limit, seq_idx=seq_idx)
        if fused:
            y, final_state = ssd_conv_scan_fused(
                *args, {"wx": cv["x"].weight, "bx": cv["x"].bias, "wB": cv["B"].weight,
                        "bB": cv["B"].bias, "wC": cv["C"].weight, "bC": cv["C"].bias}, **kw)
        else:
            y, final_state = ssd_scan(*args, **kw)
        if cache is not None:
            cache["ssm_state"] = final_state
        return y

    def post(x, y, xs, Bs, Cs, dt, gate):
        y = gated_rms_norm(y.reshape(*x.shape[:2], di), gate, m.norm.weight,
                           eps=cfg.layer_norm_epsilon, group_size=di // G)
        return m.out_proj(y)

    return pre, mixer, post


def mamba_mixer_forward(
    m: MambaMixer,
    cfg: NanoConfig,
    x: torch.Tensor,
    seq_idx: Optional[torch.Tensor] = None,
    fill_cache: bool = False,
    fused_conv: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Full-sequence Mamba-2 mixer (`mamba_parts`). x (B, L, D); seq_idx
    (B, L) int32. Returns (out, the decode cache entry with `fill_cache`)."""
    cache = {} if fill_cache else None
    return run_parts(mamba_parts(m, cfg, seq_idx, cache, fused_conv), x), cache


def mamba_mixer_decode(
    m: MambaMixer, cfg: NanoConfig, x: torch.Tensor, cache_layer: Dict[str, Any]
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token. x (B, 1, D). Returns (out (B, 1, D), new cache entry)."""
    B = x.shape[0]
    di = cfg.mamba_intermediate_size
    G, N, H, P = cfg.mamba_n_groups, cfg.ssm_state_size, cfg.mamba_num_heads, cfg.mamba_head_dim
    gate, xr, Br, Cr, dt = mamba_in_proj(m, cfg, x[:, 0])
    cv, cs, act = m.conv1d, cache_layer["conv_state"], cfg.mamba_hidden_act
    if (os.environ.get("TIMEVIPER_FUSED_DECODE", "0") == "1"
            and fused_mamba_decode_supported(cfg) and cv["x"].bias is not None):
        # the B and C convs and the dt processing stay outside the fused call
        Bs, cs_B = causal_conv1d_update(Br, cs["B"], cv["B"].weight, cv["B"].bias, act)
        Cs, cs_C = causal_conv1d_update(Cr, cs["C"], cv["C"].weight, cv["C"].bias, act)
        dtf = _process_dt(dt, m.dt_bias, cfg.time_step_limit)
        y, cs_x, ssm_state = fused_mamba_decode(
            xr, Bs, Cs, dtf, gate, cs["x"], cache_layer["ssm_state"], cv["x"].weight,
            cv["x"].bias, m.A_log, m.D, m.norm.weight, n_groups=G, head_dim=P,
            eps=cfg.layer_norm_epsilon)
        return m.out_proj(y)[:, None], {
            "conv_state": {"x": cs_x, "B": cs_B, "C": cs_C}, "ssm_state": ssm_state}
    xs, cs_x = causal_conv1d_update(xr, cs["x"], cv["x"].weight, cv["x"].bias, act)
    Bs, cs_B = causal_conv1d_update(Br, cs["B"], cv["B"].weight, cv["B"].bias, act)
    Cs, cs_C = causal_conv1d_update(Cr, cs["C"], cv["C"].weight, cv["C"].bias, act)
    y, ssm_state = ssd_update_step(
        cache_layer["ssm_state"], xs.reshape(B, H, P), dt, -torch.exp(m.A_log),
        Bs.reshape(B, G, N), Cs.reshape(B, G, N), D=m.D, dt_bias=m.dt_bias,
        dt_limit=cfg.time_step_limit)
    y = gated_rms_norm(y.reshape(B, di), gate, m.norm.weight, eps=cfg.layer_norm_epsilon,
                       group_size=di // G)
    return m.out_proj(y)[:, None], {
        "conv_state": {"x": cs_x, "B": cs_B, "C": cs_C}, "ssm_state": ssm_state}


def kv_cache_buffers(k: torch.Tensor, v: torch.Tensor, max_len: int) -> Dict[str, Any]:
    """A prefill's K/V (B, L, Hkv, hd) in zeroed buffers of `max_len` slots:
    an attention layer's decode cache entry."""
    B, L = k.shape[:2]
    if max_len < L:
        raise ValueError(f"cache capacity {max_len} < prefill length {L}")
    kc = k.new_zeros(B, max_len, *k.shape[2:])
    vc = v.new_zeros(B, max_len, *v.shape[2:])
    kc[:, :L] = k
    vc[:, :L] = v
    return {"k": kc, "v": vc}


def attention_parts(m: AttentionMixer, cfg: NanoConfig,
                    segment_ids: Optional[torch.Tensor] = None,
                    cache: Optional[Dict[str, Any]] = None, max_len: int = 0) -> Parts:
    """Prefill attention, causal and packed by segment ids, as (pre, mixer,
    post): pre q/k/v, mixer the flash path (K2), post o_proj. A `cache` dict
    gets the K/V buffers of `max_len` slots."""
    Hq, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    def pre(x):
        B, L, _ = x.shape
        return (m.q_proj(x).reshape(B, L, Hq, hd), m.k_proj(x).reshape(B, L, Hkv, hd),
                m.v_proj(x).reshape(B, L, Hkv, hd))

    def mixer(q, k, v):
        if cache is not None:
            cache.update(kv_cache_buffers(k, v, max_len))
        return flash_attention(q, k, v, segment_ids=segment_ids)

    def post(x, o, q, k, v):
        return m.o_proj(o.reshape(*x.shape[:2], Hq * hd))

    return pre, mixer, post


def attention_mixer_decode(
    m: AttentionMixer,
    cfg: NanoConfig,
    x: torch.Tensor,
    cache_layer: Dict[str, Any],
    length,
    valid_from=0,
    kv_valid_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token against the fixed-capacity KV buffer. The new K/V row is
    written IN PLACE at slot `length` (no copy of the buffer per token); the
    token attends over slots [valid_from, length].

    `length` and `valid_from` are host integers shared by every row, or (B,)
    integer tensors, one per row (the serving engine's slots sit at
    different lengths): then each row writes its K/V at its own slot, an
    index scatter, and a key mask limits it to its own [valid_from_b,
    length_b]. The keys read are the slots up to the longest row's; its
    length is read on the host, so CPU tensors cost no device sync.

    A layer whose cache entry holds `kv_len` (a pdrop prefill's, in either
    form) writes and masks at it instead of `length`, and returns it one
    more (timeviper_tpu/models/nano.py:474-507).

    A cache from the sequence-sharded pdrop prefill keeps its dropped rows
    in place and masks them: the layer's own `kv_valid` (max_len,) bool, or
    else the cache-wide `kv_valid_mask`, limits the slots further, with the
    slot written now set; the layer returns its mask so updated. Such a step
    takes host lengths, and its attention is one K9 block on the card
    (ops/block_attention.py:block_attn_lse, the mask folded into its segment
    ids)."""
    B = x.shape[0]
    Hq, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    k, v = cache_layer["k"], cache_layer["v"]
    q = m.q_proj(x).reshape(B, 1, Hq, hd)
    k_new = m.k_proj(x).reshape(B, Hkv, hd).to(k.dtype)
    v_new = m.v_proj(x).reshape(B, Hkv, hd).to(v.dtype)
    kv_len = cache_layer.get("kv_len")
    if kv_len is not None:  # after a pdrop prefill: this layer's own row count
        length = kv_len
        cache_layer = {**cache_layer, "kv_len": kv_len + 1}
    layer_valid = cache_layer.get("kv_valid", kv_valid_mask)
    if not isinstance(length, torch.Tensor):
        if length >= k.shape[1]:
            raise ValueError(f"KV cache of {k.shape[1]} slots is full")
        k[:, length] = k_new
        v[:, length] = v_new
        ks, vs = k[:, valid_from:length + 1], v[:, valid_from:length + 1]
        if layer_valid is None:
            out = attention(q, ks, vs)
        else:
            layer_valid = layer_valid.clone()
            layer_valid[length] = True
            if "kv_valid" in cache_layer:
                cache_layer = {**cache_layer, "kv_valid": layer_valid}
            out = block_attn_lse(q, ks, vs, valid_kv=layer_valid[valid_from:length + 1])[0]
        return m.o_proj(out.reshape(B, 1, Hq * hd)), cache_layer
    if layer_valid is not None:
        raise ValueError("a cache with slot-validity masks decodes with host lengths")
    span = int(length.max()) + 1
    if span > k.shape[1]:
        raise ValueError(f"KV cache of {k.shape[1]} slots is full")
    pos = length.to(k.device, torch.long)
    vf = torch.as_tensor(valid_from).to(k.device, torch.long).expand(B)
    rows = torch.arange(B, device=k.device)
    k[rows, pos] = k_new
    v[rows, pos] = v_new
    slots = torch.arange(span, device=k.device)[None]
    mask = (slots <= pos[:, None]) & (slots >= vf[:, None])  # (B, span)
    out = attention(q, k[:, :span], v[:, :span], mask[:, None])
    return m.o_proj(out.reshape(B, 1, Hq * hd)), cache_layer


def mlp_mixer_forward(m: MLPMixer, cfg: NanoConfig, x: torch.Tensor) -> torch.Tensor:
    """up -> relu^2 -> down."""
    return m.down_proj(F.relu(m.up_proj(x)).square())


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def block_parts(block: NanoBlock, cfg: NanoConfig, seq_idx: Optional[torch.Tensor],
                cache: Optional[Dict[str, Any]] = None, cache_max_len: int = 0,
                fused_conv: bool = False) -> Parts:
    """One pre-norm block, hidden + mixer(norm(hidden)), as (pre, mixer,
    post) cut at its sequence mixer (models/remat.py); an MLP block has no
    mixer (None). A `cache` dict gets the layer's decode cache entry."""
    def norm(h):
        return rms_norm(h, block.norm.weight, cfg.layer_norm_epsilon)

    if block.block_type == "mamba":
        pre, mixer, post = mamba_parts(block.mixer, cfg, seq_idx, cache, fused_conv)
    elif block.block_type == "attention":
        pre, mixer, post = attention_parts(block.mixer, cfg, seq_idx, cache, cache_max_len)
    else:
        return (lambda h: (), None,
                lambda h, _: h + mlp_mixer_forward(block.mixer, cfg, norm(h)))
    return (lambda h: pre(norm(h)), mixer, lambda h, y, *s: h + post(h, y, *s))


def _block_forward(block: NanoBlock, cfg: NanoConfig, hidden: torch.Tensor,
                   seq_idx: Optional[torch.Tensor], fill_cache: bool, cache_max_len: int,
                   fused_conv: bool = False
                   ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """(the block's output, its decode cache entry with `fill_cache`: None for
    an MLP block)."""
    cache = {} if fill_cache else None
    out = run_parts(block_parts(block, cfg, seq_idx, cache, cache_max_len, fused_conv), hidden)
    return out, cache or None


def nano_forward(
    model: NanoModel,
    cfg: NanoConfig,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    seq_idx: Optional[torch.Tensor] = None,
    fill_cache: bool = False,
    cache_max_len: int = 0,
    logits_to_keep: int = 0,
    valid_from: int = 0,
    labels: Optional[torch.Tensor] = None,
    remat=False,
    fused_conv: bool = False,
    pdrop_spec=None,
    pdrop_params=None,
) -> Dict[str, Any]:
    """Full-sequence forward (prefill or training). Returns {"hidden_states",
    "logits", "labels"} (the labels passed through, as the JAX forward returns
    them) and, with `fill_cache`, the decode `cache`. `logits_to_keep` > 0
    computes the f32 logits of the last rows only. `remat` (True or "full")
    keeps only each block's input for the backward and recomputes the block
    there; "scan", "dots" and "dots_scan" keep more, as the JAX package's
    policies of those names do (models/remat.py). `fused_conv` (inference
    only) fuses each Mamba layer's conv into its scan
    (ops/ssd_kernel.py:ssd_conv_scan_fused).

    `pdrop_spec` (models/pdrop.py, shared by the B rows) runs the config's
    pdrop stages before their layers, outside the blocks' checkpoints as in
    the JAX package (nano.py:622-646), with the TransV modules
    `pdrop_params` (a MergeModules or None); the labels and seq_idx shrink
    with the rows, and a filled cache records each attention layer's
    `kv_len` and each stage's `ca_kv` (timeviper_tpu/models/nano.py:616-681)."""
    policy = remat_policy(remat)
    hidden = model.embeddings(input_ids) if inputs_embeds is None else inputs_embeds
    stages = ({st.layer: (i, st) for i, st in enumerate(cfg.pdrop_stages)}
              if pdrop_spec is not None else {})
    new_layers, ca_kvs = [], []
    for idx, block in enumerate(model.layers):
        if idx in stages:
            si, st = stages[idx]
            hidden, labels, seq_idx, pdrop_spec, ca_kv = apply_pdrop_stage(
                hidden, labels, seq_idx, pdrop_spec, st, si, cfg=cfg,
                attn_mixer=block.mixer if st.compress_type == "attn" else None,
                merge=pdrop_params)
            ca_kvs.append(ca_kv or {})
        if policy and not fill_cache:
            hidden = run_block(block_parts(block, cfg, seq_idx), hidden, policy)
            layer_cache = None
        else:
            hidden, layer_cache = _block_forward(block, cfg, hidden, seq_idx, fill_cache,
                                                 cache_max_len, fused_conv)
            if fill_cache and pdrop_spec is not None and block.block_type == "attention":
                layer_cache["kv_len"] = hidden.shape[1]
        new_layers.append(layer_cache or {})
    hidden = rms_norm(hidden, model.norm_f.weight, cfg.layer_norm_epsilon)
    logits = compute_logits(model, hidden[:, -logits_to_keep:] if logits_to_keep else hidden)
    out = {"hidden_states": hidden, "logits": logits, "labels": labels}
    if fill_cache:
        out["cache"] = {"layers": new_layers, "length": hidden.shape[1],
                        "valid_from": int(valid_from)}
        if ca_kvs:
            out["cache"]["ca_kv"] = ca_kvs
    return out


def compute_logits(model: NanoModel, hidden: torch.Tensor) -> torch.Tensor:
    """f32 logits (..., V) of hidden rows (B, D) or (B, S, D) (the verify
    pass's); lm_head in float32, an int8 lm_head by its f32 dequant, formed
    once, or the embedding table when the embeddings are tied
    (timeviper_tpu/models/nano.py:684). A vocabulary split over a model axis
    gives this rank's columns, gathered whole
    (parallel/tensor_parallel.py:vocab_logits)."""
    lm = model.lm_head
    if lm is None:
        w, owner = model.embeddings.weight.float(), model.embeddings
    else:
        w = lm.f32_weight() if isinstance(lm, Int8Linear) else lm.weight.float()
        owner = lm
    return vocab_logits(hidden, w, owner)


def nano_decode_step(
    model: NanoModel, cfg: NanoConfig, input_ids: torch.Tensor, cache: Dict[str, Any],
    pdrop_params=None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. input_ids (B, 1). Returns (logits (B, V) f32, cache).
    The cache's `length` and `valid_from` are host integers or (B,) tensors
    (attention_mixer_decode); the returned length is one more. A cache from a
    pdrop prefill with TransV (`ca_kv`) and the merge modules `pdrop_params`
    merge the token again at each stage's layer
    (timeviper_tpu/models/nano.py:721-737). A cache with slot-validity masks
    (`kv_valid`, the sequence-sharded pdrop prefill's) sets the slot each
    step writes (:718-766)."""
    hidden = model.embeddings(input_ids)
    length, valid_from = cache["length"], cache["valid_from"]
    eps = cfg.layer_norm_epsilon
    merges = cached_merges(cfg, cache, pdrop_params)
    kv_valid = cache.get("kv_valid")
    if kv_valid is not None:  # the slot this step writes becomes valid
        kv_valid = kv_valid.clone()
        kv_valid[length] = True
    new_layers = []
    for idx, (block, lc) in enumerate(zip(model.layers, cache["layers"])):
        if idx in merges:
            hidden = merge_dropped_cached(hidden, *merges[idx], cfg)
        normed = rms_norm(hidden, block.norm.weight, eps)
        if block.block_type == "mamba":
            out, lc = mamba_mixer_decode(block.mixer, cfg, normed, lc)
        elif block.block_type == "attention":
            out, lc = attention_mixer_decode(block.mixer, cfg, normed, lc, length, valid_from,
                                             kv_valid)
        else:
            out = mlp_mixer_forward(block.mixer, cfg, normed)
        hidden = hidden + out
        new_layers.append(lc)
    hidden = rms_norm(hidden, model.norm_f.weight, eps)
    logits = compute_logits(model, hidden[:, 0])
    new_cache = {"layers": new_layers, "length": length + 1, "valid_from": valid_from}
    if kv_valid is not None:
        new_cache["kv_valid"] = kv_valid
    if "ca_kv" in cache:
        new_cache["ca_kv"] = cache["ca_kv"]
    return logits, new_cache
