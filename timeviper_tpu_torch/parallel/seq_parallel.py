"""Sequence-parallel long-context prefill over the mesh's `seq` axis
(counterpart of timeviper_tpu/parallel/seq_parallel.py).

The fused visual + text row is cut into equal spans, one a rank, and every
rank holds a whole copy of the weights (JAX replicates the parameters over
`seq`). Each rank runs the port's single-card kernels on its own span and
the collectives of parallel/sharding.py join the spans:

* Mamba layers: the depthwise conv (K = 4) takes the left neighbour's last
  K - 1 rows by `ppermute` (`_halo_conv`); the SSD scan (K1) runs on the
  local span from a zero state and returns its final state; one
  `all_gather` of the (B, H, P, N) states and the spans' decays lets every
  rank compose the state entering its span, and the correction
  C_i . h_in . exp(sum dA) is added in PyTorch (`ssd_seq_sharded`, whose
  compose step, `compose_spans`, also joins K5's local scans).
* Attention layers: the local queries attend the all-gathered K/V
  (`attention_seq_sharded`, which also gives the decode cache its K/V) or,
  for a prefill that keeps no cache, the K/V blocks as they come round the
  ring (`attention_seq_ring`); both are K9 blocks merged by their row
  statistics (ops/block_attention.py:merge_parts). No (Lloc, L) score
  matrix is built.
* Everything else is per token.

Under autograd (training through the sharded prefill, the logits path or
`return_hidden`) the collectives carry their SPMD transposes
(parallel/sharding.py): the gradient of a gathered state or K/V is the psum
of its cotangent sliced to this rank, of a halo the reverse shift. The
Mamba layers keep their path (K1 forward, K4 backward); an attention layer
runs `attention_seq_sharded` under `SpanAttnFn`: K9's parts forward,
K2-bwd's causal mode over my block and its non-causal mode over the keys
left of it backward, so each rank does its span's share of the attention
work. The logits come from the rank that holds the last rows and are
gathered as a value every rank holds whole, so that each rank's parameter
gradient is its span's part: their psum over `seq` is the gradient of the
one-device prefill. Each block is checkpointed (its input
kept, its forward and its collectives run again in the backward, the same
on every rank), as the Trainer's "full" remat keeps a block.

Left pads (global rows before `valid_from`) and pdrop's dropped tokens are
masked, not removed: shapes never change. A masked row's embeddings and
Mamba in-projections are zeroed, its dt is made -inf before the scan so that
softplus gives it dt = 0 exactly (no decay, no contribution: the same as the
JAX package's dt zeroed after softplus; the kernels' softplus is log1p(exp)
below 20), attention masks it from the keys, and the residual stream is
zeroed after every block. After a pdrop stage the conv runs over the kept
rows only (`_compact_conv`). The JAX package zeroes dt only after a drop
and lets a left pad's dt decay a state that is still zero there; the two
agree.

`nano_prefill_seq_parallel(fill_cache=True)` returns a decode-ready cache
that every rank holds whole: the global final SSM state, the last rank's
conv window, the gathered K/V in buffers of `cache_max_len` rows and, under
pdrop, a per-layer and a cache-wide slot-validity mask (`kv_valid`, which
models/nano.py:nano_decode_step and models/prefix_cache.py read) and the
TransV K/V (`ca_kv`). Each rank then decodes it on its own card.

With the fused conv (TIMEVIPER_FUSED_CONV=1, as the Generator reads it), a
Mamba layer before any drop runs K5 on its span with the K - 1 halo rows in
front, their dt -inf: the conv reads them and the scan ignores them. The
convolved C that the correction needs is then computed once more in PyTorch.

Not carried over: `lax.map`'s query chunks and the layer scan
(`_find_repeat_unit`, `_scan_layers_enabled`), which are XLA memory and
compile-time machinery.

The entry points take the global tensors (every rank passes the same) and
each rank reads its own span: `inputs_embeds` (B, L, D) with L a multiple of
the `seq` axis, `pixels` (F, H, W, 3) with F one.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from timeviper_tpu_torch.config import NanoConfig
from timeviper_tpu_torch.models.nano import (
    NanoModel,
    compute_logits,
    kv_cache_buffers,
    mamba_in_proj,
    mlp_mixer_forward,
)
from timeviper_tpu_torch.models.pdrop import uni_keep_indices
from timeviper_tpu_torch.ops.attention import cross_attention, make_attention_mask
from timeviper_tpu_torch.ops.block_attention import (
    block_attn_lse,
    fold_segments,
    merge_parts,
    row_lse,
)
from timeviper_tpu_torch.ops.conv import causal_conv1d, init_conv_state
from timeviper_tpu_torch.ops.norms import gated_rms_norm, rms_norm
from timeviper_tpu_torch.ops.ssd import _process_dt
from timeviper_tpu_torch.ops.ssd_kernel import NO_LIMIT, ssd_conv_scan_fused, ssd_scan
from timeviper_tpu_torch.ops.flash_attention import (
    cross_attention_bwd,
    cross_attention_bwd_plain,
    flash_attention_bwd,
)
from timeviper_tpu_torch.parallel.sharding import (
    SEQ_X_MODEL,
    all_gather,
    axis_index,
    axis_size,
    gather_replicated,
    ppermute,
    psum,
)

SEQ = "seq"

# ---------------------------------------------------------------------------
# Sequence-sharded SSD
# ---------------------------------------------------------------------------


def _masked_dt(dt, dt_mask, dt_limit):
    """dt with the rows outside `dt_mask` (B, Lloc) set to -inf, which
    softplus turns into dt = 0 exactly: such a row neither decays nor feeds
    the state."""
    if dt_mask is None:
        return dt
    if dt_limit[0] > 0.0:
        raise ValueError("a masked row's dt is 0 only without a lower dt limit")
    return dt.masked_fill(~dt_mask[..., None], float("-inf"))


def ssd_seq_sharded(x, dt, A, B_, C, *, mesh, chunk_size: int, D=None, dt_bias=None,
                    dt_limit=NO_LIMIT, dt_mask=None, return_final_state: bool = False,
                    seq_idx=None):
    """The SSD scan of a span x (B, Lloc, H, P), dt (B, Lloc, H), B_, C
    (B, Lloc, G, N) composed with the spans left of it (seq_parallel.py:60):
    K1 on the span from a zero state, then `compose_spans`.

    `dt_mask` (B, Lloc) bool makes the masked rows exact no-ops (their dt is
    0). `seq_idx` (B, Lloc) int32, the span of nondecreasing packed segment
    ids: the local scan resets at segment starts, the carry into the span is
    dropped when the seam starts a segment, and a span that starts a segment
    inside stops the carry through it. Returns y, and with
    `return_final_state` the state after the last span, the same on every
    rank."""
    dt = _masked_dt(dt, dt_mask, dt_limit)
    y_local, state_local = ssd_scan(x, dt, A, B_, C, chunk_size=chunk_size, D=D,
                                    dt_bias=dt_bias, dt_limit=dt_limit, seq_idx=seq_idx)
    dA = _process_dt(dt, dt_bias, dt_limit) * A.float()
    y, state = compose_spans(y_local, state_local, dA, C, mesh=mesh, seq_idx=seq_idx)
    return (y, state) if return_final_state else y


def compose_spans(y_local, state_local, dA, C, *, mesh, seq_idx=None):
    """Joins a span's local scan, y_local (B, Lloc, H, P) and its final state
    (B, H, P, N) from a zero state, with the spans left of it: one
    all_gather of the states and the spans' decays exp(sum dA), the prefix
    compose of the states entering each span (seq_parallel.py:147), and the
    correction C_i . h_in . exp(cumsum dA) added to y. dA (B, Lloc, H) f32
    is dt * A after softplus and the limits; C (B, Lloc, G, N) the convolved
    C. Returns (y, the state after the last span)."""
    H = dA.shape[2]
    decays = all_gather(torch.exp(dA.sum(dim=1)), mesh, SEQ)  # (n, B, H)
    states = all_gather(state_local, mesh, SEQ)  # (n, B, H, P, N)
    n, my = decays.shape[0], axis_index(mesh, SEQ)
    if seq_idx is not None:
        firsts = all_gather(seq_idx[:, 0].contiguous(), mesh, SEQ)  # (n, B)
        lasts = all_gather(seq_idx[:, -1].contiguous(), mesh, SEQ)
        prev_last = torch.cat([torch.full_like(lasts[:1], -1), lasts[:-1]])
        cont_in = (prev_last == firsts).float()
        through = (firsts == lasts).float()
    else:
        cont_in = through = torch.ones(decays.shape[:2], device=dA.device)
    carry = torch.zeros_like(state_local)
    inbounds = []
    for k in range(n):  # the prefix compose over the spans, in order
        inbound = carry * cont_in[k][:, None, None, None]
        inbounds.append(inbound)
        carry = inbound * (decays[k] * through[k][:, None])[..., None, None] + states[k]
    # every rank's graph reads the gathered states the same way: under
    # autograd each gather's backward (a collective) then runs on every rank
    h_in = torch.stack(inbounds)[my]
    Bsz, L, _, P = y_local.shape
    G, N = C.shape[-2:]
    y_corr = torch.einsum("blgn,bgrpn->blgrp", C.float(),
                          h_in.reshape(Bsz, G, H // G, P, N)).reshape(Bsz, L, H, P)
    y_corr = y_corr * torch.exp(torch.cumsum(dA, dim=1))[..., None]
    if seq_idx is not None:  # the inbound state reaches the span's first segment only
        y_corr = y_corr * (seq_idx == seq_idx[:, :1])[..., None, None]
    return (y_local.float() + y_corr).to(y_local.dtype), carry


# ---------------------------------------------------------------------------
# The conv across spans
# ---------------------------------------------------------------------------


def _with_halo(x, mesh, K: int, seq_idx=None):
    """x (B, Lloc, C) with the left neighbour's last K - 1 rows in front
    (zeros on the first rank), and the segment ids to match: the halo rows
    carry the neighbour's last id, -1 on the first rank (never matching)."""
    n, my = axis_size(mesh, SEQ), axis_index(mesh, SEQ)
    perm = [(i, i + 1) for i in range(n - 1)]
    xp = torch.cat([ppermute(x[:, -(K - 1):], mesh, SEQ, perm), x], dim=1)
    ext_seq = None
    if seq_idx is not None:
        halo_seg = seq_idx[:, -1:].expand(-1, K - 1).contiguous()
        seg_left = ppermute(halo_seg, mesh, SEQ, perm)
        if my == 0:
            seg_left = torch.full_like(seg_left, -1)
        ext_seq = torch.cat([seg_left, seq_idx], dim=1)
    return xp, ext_seq


def _halo_conv(x, weight, bias, activation, mesh, seq_idx=None):
    """The depthwise causal conv of a span across the seam
    (seq_parallel.py:1030): a tap that crosses a segment boundary, at the
    seam or inside the span, reads zero."""
    K = weight.shape[-1]
    xp, ext_seq = _with_halo(x, mesh, K, seq_idx)
    return causal_conv1d(xp, weight, bias, activation, ext_seq)[:, K - 1:]


def _compact_conv(x, weight, bias, activation, mesh, local_valid):
    """The conv over the kept rows only (seq_parallel.py:465): after a pdrop
    stage a kept row's K - 1 left taps are the kept rows before it. The span
    is compacted in order, the last K - 1 kept rows of the whole prefix are
    composed across the spans, and the result goes back to its rows; the
    dropped rows come out as garbage for the caller to zero."""
    K = weight.shape[-1]
    Bsz, Lloc, Ch = x.shape
    order = torch.argsort((~local_valid).to(torch.int8), stable=True)  # kept first
    inv = torch.argsort(order)
    xc = x[:, order]
    n_valid = int(local_valid.sum())
    cnt = min(n_valid, K - 1)
    tail = x.new_zeros(Bsz, K - 1, Ch)
    tail[:, :cnt] = xc[:, n_valid - cnt:n_valid]
    tails = all_gather(tail, mesh, SEQ)  # (n, B, K-1, C)
    cnts = all_gather(torch.tensor([cnt], device=x.device), mesh, SEQ)[:, 0].tolist()
    my = axis_index(mesh, SEQ)
    carry = torch.zeros_like(tail)  # the last K - 1 kept rows, right-aligned
    for k, c in enumerate(cnts):
        if k == my:
            halo = carry
        carry = torch.cat([carry, tails[k]], dim=1)[:, c:c + K - 1]
    y = causal_conv1d(torch.cat([halo, xc], dim=1), weight, bias, activation)[:, K - 1:]
    return y[:, inv]


# ---------------------------------------------------------------------------
# Attention across spans
# ---------------------------------------------------------------------------


def _span(t, j: int, Lloc: int, dim: int):
    if t is None:
        return None
    return t.narrow(dim, j * Lloc, Lloc)


def attention_seq_ring(q, k, v, *, mesh, valid_g=None, seq_g=None):
    """Causal attention of the local queries q (B, Lloc, Hq, hd) with the
    K/V blocks rotating round the ring (seq_parallel.py:287): one block in
    flight a step, K9 on each as it arrives (causal on my own, non-causal on
    the others), merged by (o, l, m). Blocks right of mine pass through and
    contribute nothing. `valid_g` (L,) bool, `seq_g` (B, L) packed segment
    ids, global."""
    n, my = axis_size(mesh, SEQ), axis_index(mesh, SEQ)
    Lloc = q.shape[1]
    vm, sm = _span(valid_g, my, Lloc, 0), _span(seq_g, my, Lloc, 1)
    parts = [block_attn_lse(q, k, v, causal=True, valid_kv=vm, valid_q=vm, seg_q=sm, seg_kv=sm)]
    perm = [(i, (i + 1) % n) for i in range(n)]
    kc, vc = k, v
    for s in range(1, n):
        kc, vc = ppermute(kc, mesh, SEQ, perm), ppermute(vc, mesh, SEQ, perm)
        if s <= my:  # block my - s, left of mine
            j = my - s
            parts.append(block_attn_lse(q, kc, vc, causal=False,
                                        valid_kv=_span(valid_g, j, Lloc, 0), valid_q=vm,
                                        seg_q=sm, seg_kv=_span(seq_g, j, Lloc, 1)))
    return merge_parts(parts)[0] if len(parts) > 1 else parts[0][0]


def _span_attn(q, kg, vg, lo: int, seg):
    """K9 over my block of the row (causal) and over the keys left of it
    (non-causal), merged: (o, l, m). `seg` (B, L) int32 folded segment ids,
    or None."""
    hi = lo + q.shape[1]
    sq = None if seg is None else seg[:, lo:hi]
    parts = [block_attn_lse(q, kg[:, lo:hi], vg[:, lo:hi], causal=True, seg_q=sq, seg_kv=sq)]
    if lo:
        parts.append(block_attn_lse(q, kg[:, :lo], vg[:, :lo], causal=False, seg_q=sq,
                                    seg_kv=None if seg is None else seg[:, :lo]))
    return merge_parts(parts) if len(parts) > 1 else parts[0]


def _part_bwd(q, k, v, o, dout, lse, causal: bool, seg=None):
    """(dq, dk, dv) of one key part given the merged output and row
    log-sum-exp: K2-bwd's causal mode (Lq == Lk, segment ids) or its
    non-causal mode on the card, their formulas in f32 on the CPU."""
    if q.device.type == "cpu":
        mask = make_attention_mask(q.shape[1], k.shape[1], causal=causal, q_segment_ids=seg,
                                   kv_segment_ids=seg, device=q.device)
        return cross_attention_bwd_plain(q, k, v, o, dout, lse=lse, mask=mask)
    k, v = k.contiguous(), v.contiguous()
    if causal:
        return flash_attention_bwd(q, k, v, o, dout, lse, seg)
    return cross_attention_bwd(q, k, v, o, dout, lse)


class SpanAttnFn(torch.autograd.Function):
    """Causal attention of my span's queries q (B, Lloc, Hq, hd), rows lo on
    of the row, over the gathered keys kg, vg (B, L, Hkv, hd). Forward: K9's
    two parts merged (`_span_attn`), keeping o and the row log-sum-exp.
    Backward: K2-bwd's causal mode over my block and its non-causal mode over
    the keys left of it, each given the merged o and log-sum-exp, so that
    each part's probabilities are the merged ones and the parts' gradients
    add up. The non-causal mode takes no segment ids: with `seg`, it runs
    once for each segment that my block shares with the keys left of it,
    that segment's queries against its keys (a packed row's segments are
    runs, so usually once)."""

    @staticmethod
    def forward(ctx, q, kg, vg, lo, seg):
        o, l, m = _span_attn(q, kg, vg, lo, seg)
        o = o.contiguous()  # merge_parts' weights are transposed views; K2-bwd reads rows
        ctx.lo = lo
        ctx.save_for_backward(q, kg, vg, o, row_lse(l, m), seg)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, kg, vg, o, lse, seg = ctx.saved_tensors
        lo = ctx.lo
        hi = lo + q.shape[1]
        dout = dout.contiguous()
        sq = None if seg is None else seg[:, lo:hi].contiguous()
        dq, dk_mine, dv_mine = _part_bwd(q, kg[:, lo:hi], vg[:, lo:hi], o, dout, lse, True, sq)
        dq = dq.float()
        dk, dv = torch.zeros_like(kg), torch.zeros_like(vg)
        dk[:, lo:hi], dv[:, lo:hi] = dk_mine, dv_mine
        if lo and seg is None:
            a, b, c = _part_bwd(q, kg[:, :lo], vg[:, :lo], o, dout, lse, False)
            dq += a.float()
            dk[:, :lo], dv[:, :lo] = b, c
        elif lo:
            for bi in range(q.shape[0]):
                r, left = slice(bi, bi + 1), seg[bi, :lo]
                for s in torch.unique(sq[bi]).tolist():
                    ki = (left == s).nonzero()[:, 0]
                    if not len(ki):
                        continue
                    qi = (sq[bi] == s).nonzero()[:, 0]
                    a, b, c = _part_bwd(q[r, qi], kg[r, ki], vg[r, ki], o[r, qi], dout[r, qi],
                                        lse[r][:, :, qi].contiguous(), False)
                    dq[r, qi] += a.float()
                    dk[r, ki], dv[r, ki] = b, c
        return dq.to(q.dtype), dk, dv, None, None


def attention_seq_sharded(q, k, v, *, mesh, kv_valid=None, seq_g=None,
                          return_kv: bool = False):
    """Causal attention of the local queries against the all-gathered K/V
    (seq_parallel.py:375): K9 non-causal over the keys left of my span and
    K9 causal over my own block, merged; under autograd `SpanAttnFn`, whose
    backward is K2-bwd's, and the gather's transpose hands each rank its
    keys' gradient. `kv_valid` (L,) masks global key slots (left pads,
    dropped tokens; a masked query row attends the masked keys, as K9 folds
    them); `seq_g` (B, L) packed segment ids. With `return_kv`, also the
    gathered (kg, vg) (B, L, Hkv, hd), the decode cache's K/V for the layer."""
    my, Lloc = axis_index(mesh, SEQ), q.shape[1]
    kg = all_gather(k, mesh, SEQ, dim=1, tiled=True)
    vg = all_gather(v, mesh, SEQ, dim=1, tiled=True)
    L = kg.shape[1]
    seg = fold_segments(q.shape[0], L, L, valid_kv=kv_valid, valid_q=kv_valid, seg_q=seq_g,
                        seg_kv=seq_g, device=q.device)[0]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, kg, vg)):
        out = SpanAttnFn.apply(q, kg, vg, my * Lloc, seg)
    else:
        out = _span_attn(q, kg, vg, my * Lloc, seg)[0]
    return (out, (kg, vg)) if return_kv else out


# ---------------------------------------------------------------------------
# pdrop across spans
# ---------------------------------------------------------------------------


def _select_row(h, global_idx: int, mesh, my: int, Lloc: int):
    """The (B, D) row at a global position, from the rank that holds it, on
    every rank (one psum of a row; seq_parallel.py:446)."""
    local = global_idx - my * Lloc
    row = h[:, local] if 0 <= local < Lloc else h.new_zeros(h.shape[0], h.shape[2])
    return psum(row, mesh, SEQ)


def _rank_scores_attn_sharded(h, attn_mixer, cfg: NanoConfig, query_pos: int, mesh, my: int,
                              Lloc: int, valid_g):
    """The "attn" ranking across spans (seq_parallel.py:513): the query row
    from its rank, each rank's keys scored with the stage layer's q / k
    projections, one all-gather of the (Hq, Lloc) logits, and the same
    softmax on every rank over the valid rows up to the query. Returns the
    mean over heads (L,) f32."""
    Hq, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    hs = h.detach()
    qrow = _select_row(hs, query_pos, mesh, my, Lloc)
    q = attn_mixer.q_proj(qrow).reshape(Hkv, Hq // Hkv, hd).float()
    k = attn_mixer.k_proj(hs[0]).reshape(Lloc, Hkv, hd).float()
    logits = torch.einsum("grd,lgd->grl", q, k).reshape(Hq, Lloc) / math.sqrt(hd)
    lg = all_gather(logits, mesh, SEQ, dim=1, tiled=True)
    L = lg.shape[1]
    mask = (torch.arange(L, device=h.device) <= query_pos) & valid_g
    return torch.softmax(lg.masked_fill(~mask[None], float("-inf")), dim=-1).mean(dim=0)


def _transv_merge_sharded(h, mm, cfg: NanoConfig, dropped_mask, suffix_local, mesh,
                          return_ca_kv: bool):
    """TransV across spans (seq_parallel.py:538): the local rows cross-attend
    the dropped tokens' K/V, projected locally and all-gathered
    (ops/attention.py:cross_attention with kv_valid, K9 on the card); the
    tanh(alpha)-gated result replaces the text-suffix rows. Returns (h, the
    dropped rows' K/V in order, or None)."""
    Hq, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    ca = mm.cross_attn
    Lloc = h.shape[1]
    kg = all_gather(ca.k_proj(h[0]).reshape(Lloc, Hkv, hd), mesh, SEQ, dim=0, tiled=True)
    vg = all_gather(ca.v_proj(h[0]).reshape(Lloc, Hkv, hd), mesh, SEQ, dim=0, tiled=True)
    q = ca.q_proj(h[0]).reshape(1, Lloc, Hq, hd)
    out = cross_attention(q, kg[None], vg[None], kv_valid=dropped_mask[None])
    merged = h[0] + torch.tanh(mm.alpha.to(h.dtype)) * ca.o_proj(out.reshape(Lloc, Hq * hd))
    new_h = torch.where(suffix_local[:, None], merged, h[0])[None]
    ca_kv = None
    if return_ca_kv:
        idx = dropped_mask.nonzero()[:, 0]
        ca_kv = {"k": kg[idx], "v": vg[idx]}
    return new_h, ca_kv


def _stage_keep_mask(stage, hidden, model, cfg, valid_g, vis_mask, cur_nv: int, keep: int,
                     query_pos: int, mesh, my: int, Lloc: int):
    """The global keep mask (L,) of a stage's visual tokens."""
    vv = valid_g & vis_mask
    if stage.compress_type == "uni":
        rank = torch.cumsum(vv.to(torch.int64), 0) - 1
        krm = torch.zeros(cur_nv, dtype=torch.bool, device=vv.device)
        krm[torch.from_numpy(uni_keep_indices(cur_nv, keep)).to(vv.device, torch.long)] = True
        return vv & krm[rank.clamp(0, cur_nv - 1)]
    if stage.compress_type == "attn":
        scores = _rank_scores_attn_sharded(hidden, model.layers[stage.layer].mixer, cfg,
                                           query_pos, mesh, my, Lloc, valid_g)
        svis = torch.where(vv, scores, float("-inf"))
        # the top `keep`, ties to the lower index (jax.lax.top_k)
        top = torch.sort(svis, descending=True, stable=True).indices[:keep]
        keep_mask = torch.zeros_like(vv)
        keep_mask[top] = True
        return keep_mask
    raise NotImplementedError(f"pdrop compress type {stage.compress_type!r}")


# ---------------------------------------------------------------------------
# The backbone's prefill
# ---------------------------------------------------------------------------


def _zero_invalid(x, lv):
    return torch.where(lv[None, :, None], x, x.new_zeros(()))


def nano_prefill_seq_parallel(
    model: NanoModel,
    cfg: NanoConfig,
    inputs_embeds: torch.Tensor,
    mesh,
    *,
    logits_to_keep: int = 1,
    valid_from: int = 0,
    fill_cache: bool = False,
    cache_max_len: int = 0,
    seq_idx: Optional[torch.Tensor] = None,
    return_hidden: bool = False,
    use_pdrop: bool = False,
    pdrop_vision_start: Optional[int] = None,
    pdrop_num_vision: int = 0,
    pdrop_query_pos: Optional[int] = None,
    merge_params=None,
    fused_conv: bool = False,
):
    """The backbone's prefill with the row sharded over the mesh's `seq`
    axis (seq_parallel.py:605). inputs_embeds (B, L, D) global, the same on
    every rank; rows before `valid_from` are left pads. A `data` axis splits
    the B rows.

    Returns the f32 logits (B, logits_to_keep, V) of the last rows, the
    same on every rank, and
    * with `fill_cache`, the decode cache (module doc), in the model's
      dtype as nano_forward's; refused on a `data` axis above 1, as in the
      JAX package (a cache is one request's);
    * with `return_hidden`, this rank's (B / data, L / seq, D) post-norm
      hidden rows (the forward of the packed-training hook).
    Under autograd the logits and the hidden rows carry gradients (module
    doc); a cache is filled without one.
    `seq_idx` (B, L) packs segments (nondecreasing ids). `use_pdrop` runs
    the config's stages on a batch-1 generation layout: the visual block of
    `pdrop_num_vision` rows at global row `pdrop_vision_start`, ranked by
    `pdrop_query_pos`, with the TransV modules `merge_params` (a
    MergeModules or None). `fused_conv` runs K5 on the layers before any
    drop (module doc)."""
    if use_pdrop and seq_idx is not None:
        raise ValueError("pdrop and packed seq_idx are exclusive")
    if fill_cache and return_hidden:
        raise ValueError("fill_cache and return_hidden are exclusive")
    if use_pdrop and return_hidden:
        raise ValueError("pdrop and return_hidden are exclusive")
    if axis_size(mesh, "model") > 1:
        raise NotImplementedError(SEQ_X_MODEL)
    with torch.set_grad_enabled(torch.is_grad_enabled() and not fill_cache):
        return _prefill(model, cfg, inputs_embeds, mesh, logits_to_keep, valid_from, fill_cache,
                        cache_max_len, seq_idx, return_hidden, use_pdrop, pdrop_vision_start,
                        pdrop_num_vision, pdrop_query_pos, merge_params, fused_conv)


def _prefill(model, cfg, inputs_embeds, mesh, logits_to_keep, valid_from, fill_cache,
             cache_max_len, seq_idx, return_hidden, use_pdrop, pdrop_vision_start,
             pdrop_num_vision, pdrop_query_pos, merge_params, fused_conv):
    Bg, L, _ = inputs_embeds.shape
    grad = torch.is_grad_enabled()
    n, my = axis_size(mesh, SEQ), axis_index(mesh, SEQ)
    nd, di = axis_size(mesh, "data"), axis_index(mesh, "data")
    if L % n or Bg % nd:
        raise ValueError(f"a row of {L} over {n} spans, {Bg} rows over {nd} data shards")
    if fill_cache:
        if cache_max_len < L:
            raise ValueError(f"cache capacity {cache_max_len} < prefill length {L}")
        if nd != 1:
            raise ValueError("fill_cache requires a data=1 mesh (sequence-sharded serving is "
                             "per request); shard batches at the engine level instead")
    K = cfg.mamba_d_conv
    Lloc, Bl = L // n, Bg // nd
    if Lloc < K - 1:
        raise ValueError(f"a span of {Lloc} rows is shorter than the conv's halo")
    rows = slice(di * Bl, (di + 1) * Bl)
    hidden = inputs_embeds[rows, my * Lloc:(my + 1) * Lloc]
    dev = hidden.device
    iota = torch.arange(L, device=dev)
    valid_g = iota >= int(valid_from)
    seq_glob = seq_loc = None
    if seq_idx is not None:
        seq_glob = seq_idx[rows].to(dev, torch.int32)
        seq_loc = seq_glob[:, my * Lloc:(my + 1) * Lloc].contiguous()
    eps = cfg.layer_norm_epsilon
    di_, G, N = cfg.mamba_intermediate_size, cfg.mamba_n_groups, cfg.ssm_state_size
    H, P = cfg.mamba_num_heads, cfg.mamba_head_dim
    Hq, hd = cfg.num_attention_heads, cfg.head_dim
    fused = fused_conv and K == 4 and cfg.chunk_size % 128 == 0

    def mamba(m, normed, lv, dropped, cache):
        gate, xr, Br, Cr, dtr = mamba_in_proj(m, cfg, normed)
        raw = {r: _zero_invalid(s, lv) for r, s in zip("xBC", (xr, Br, Cr))}
        if fill_cache:  # decode goes on from the last K global rows
            cache["conv_state"] = {r: all_gather(init_conv_state(s, K), mesh, SEQ)[-1]
                                   for r, s in raw.items()}
        cv, act = m.conv1d, cfg.mamba_hidden_act
        dt_mask = lv[None].expand(Bl, Lloc)
        A = -torch.exp(m.A_log)
        if fused and not dropped:
            ext = {r: _with_halo(s, mesh, K, seq_loc) for r, s in raw.items()}
            seq_ext = ext["x"][1]
            dt_span = _masked_dt(dtr, dt_mask, cfg.time_step_limit)
            dt_ext = torch.cat([dtr.new_full((Bl, K - 1, H), float("-inf")), dt_span], dim=1)
            Le = Lloc + K - 1
            y_ext, st = ssd_conv_scan_fused(
                ext["x"][0].reshape(Bl, Le, H, P), dt_ext, A,
                ext["B"][0].reshape(Bl, Le, G, N), ext["C"][0].reshape(Bl, Le, G, N),
                {"wx": cv["x"].weight, "bx": cv["x"].bias, "wB": cv["B"].weight,
                 "bB": cv["B"].bias, "wC": cv["C"].weight, "bC": cv["C"].bias},
                chunk_size=cfg.chunk_size, D=m.D, dt_bias=m.dt_bias,
                dt_limit=cfg.time_step_limit, seq_idx=seq_ext)
            Cs = _zero_invalid(causal_conv1d(ext["C"][0], cv["C"].weight, cv["C"].bias, act,
                                             seq_ext)[:, K - 1:], lv)
            dA = _process_dt(dt_span, m.dt_bias, cfg.time_step_limit) * A.float()
            y, state = compose_spans(y_ext[:, K - 1:], st, dA, Cs.reshape(Bl, Lloc, G, N),
                                     mesh=mesh, seq_idx=seq_loc)
        else:
            if dropped:
                conv = {r: _compact_conv(s, cv[r].weight, cv[r].bias, act, mesh, lv)
                        for r, s in raw.items()}
            else:
                conv = {r: _halo_conv(s, cv[r].weight, cv[r].bias, act, mesh, seq_loc)
                        for r, s in raw.items()}
            xs, Bs, Cs = (_zero_invalid(conv[r], lv) for r in "xBC")
            y, state = ssd_seq_sharded(
                xs.reshape(Bl, Lloc, H, P), dtr, A, Bs.reshape(Bl, Lloc, G, N),
                Cs.reshape(Bl, Lloc, G, N), mesh=mesh, chunk_size=cfg.chunk_size, D=m.D,
                dt_bias=m.dt_bias, dt_limit=cfg.time_step_limit, dt_mask=dt_mask,
                return_final_state=True, seq_idx=None if dropped else seq_loc)
        if fill_cache:
            cache["ssm_state"] = state
        y = gated_rms_norm(y.reshape(Bl, Lloc, di_), gate, m.norm.weight, eps=eps,
                           group_size=di_ // G)
        return m.out_proj(y)

    def attention(m, normed, vg, cache):
        Hkv = cfg.num_key_value_heads
        q = m.q_proj(normed).reshape(Bl, Lloc, Hq, hd)
        k = m.k_proj(normed).reshape(Bl, Lloc, Hkv, hd)
        v = m.v_proj(normed).reshape(Bl, Lloc, Hkv, hd)
        if fill_cache:
            o, (kg, vg_) = attention_seq_sharded(q, k, v, mesh=mesh, kv_valid=vg, seq_g=seq_glob,
                                                 return_kv=True)
            cache.update(kv_cache_buffers(kg, vg_, cache_max_len))
            if use_pdrop:  # this layer's validity: a pre-stage layer keeps later drops
                cache["kv_valid"] = F.pad(vg, (0, cache_max_len - L))
        elif grad:
            o = attention_seq_sharded(q, k, v, mesh=mesh, kv_valid=vg, seq_g=seq_glob)
        else:
            o = attention_seq_ring(q, k, v, mesh=mesh, valid_g=vg, seq_g=seq_glob)
        return m.o_proj(o.reshape(Bl, Lloc, Hq * hd))

    def apply_layer(block, hidden, vg, dropped):
        lv = vg[my * Lloc:(my + 1) * Lloc]
        normed = rms_norm(hidden, block.norm.weight, eps)
        cache: Dict[str, Any] = {}
        if block.block_type == "mamba":
            out = mamba(block.mixer, normed, lv, dropped, cache)
        elif block.block_type == "attention":
            out = attention(block.mixer, normed, vg, cache)
        else:
            out = mlp_mixer_forward(block.mixer, cfg, normed)
        return _zero_invalid(hidden + out, lv), cache

    hidden = _zero_invalid(hidden, valid_g[my * Lloc:(my + 1) * Lloc])
    stages = {}
    if use_pdrop:
        if Bl != 1:
            raise ValueError("sequence-sharded pdrop is the generation path (batch 1)")
        stages = {st.layer: (i, st) for i, st in enumerate(cfg.pdrop_stages)}
        nv0 = pdrop_num_vision
        vs = int(pdrop_vision_start or 0)
        qpos = int(pdrop_query_pos or 0)
        vis_mask = (iota >= vs) & (iota < vs + nv0)
        suffix_local = torch.arange(my * Lloc, (my + 1) * Lloc, device=dev) >= vs + nv0
    cur_nv, dropped = pdrop_num_vision, False
    ratios = (1.0,) + tuple(st.ratio for st in cfg.pdrop_stages)
    cache_layers: List[Dict[str, Any]] = []
    ca_kvs: List[Dict[str, Any]] = []
    for idx, block in enumerate(model.layers):
        if idx in stages:
            si, st = stages[idx]
            keep = min(int(nv0 * ratios[si + 1]), cur_nv)
            keep_mask = _stage_keep_mask(st, hidden, model, cfg, valid_g, vis_mask, cur_nv,
                                         keep, qpos, mesh, my, Lloc)
            new_valid = torch.where(vis_mask, keep_mask, valid_g)
            mm = merge_params.stage(si) if merge_params is not None else None
            ca_kv = None
            if mm is not None and cur_nv > keep:
                hidden, ca_kv = _transv_merge_sharded(
                    hidden, mm, cfg, valid_g & vis_mask & ~new_valid, suffix_local, mesh,
                    fill_cache)
            ca_kvs.append(ca_kv or {})
            dropped = dropped or cur_nv > keep
            valid_g, cur_nv = new_valid, keep
        if grad:  # each block checkpointed, as the Trainer's "full" remat
            hidden, cache = checkpoint(
                lambda h, b=block, v=valid_g, d=dropped: apply_layer(b, h, v, d)[0], hidden,
                use_reentrant=False), {}
        else:
            hidden, cache = apply_layer(block, hidden, valid_g, dropped)
        cache_layers.append(cache)
    hidden = rms_norm(hidden, model.norm_f.weight, eps)
    # the last rank's rows' logits, a value every rank holds whole
    logits = gather_replicated(compute_logits(model, hidden[:, -logits_to_keep:]), mesh,
                               SEQ)[-1]
    if nd > 1:
        logits = gather_replicated(logits, mesh, "data", dim=0, tiled=True)
    if return_hidden:
        return logits, hidden
    if not fill_cache:
        return logits
    cache = {"layers": cache_layers, "length": L, "valid_from": int(valid_from)}
    if use_pdrop:
        cache["kv_valid"] = F.pad(valid_g, (0, cache_max_len - L))
        if any(ca_kvs):
            cache["ca_kv"] = ca_kvs
    return logits, cache


# ---------------------------------------------------------------------------
# The vision stage
# ---------------------------------------------------------------------------


def encode_frames_seq_parallel(model, arch, pixels, mesh, *,
                               clip_size: Optional[int] = None) -> torch.Tensor:
    """Each rank encodes its span of the frames (F, H, W, 3), `clip_size`
    frames at a time (seq_parallel.py:989). The tower (K3 on the card), ToMe
    and the projector are frame-local, so no collective runs. Returns this
    rank's (1, F / seq * tokens_per_frame, llm_dim) visual tokens; the
    Generator all-gathers them where the prompt needs them whole. One ViT
    tower only (SigLIP or DINOv2)."""
    from timeviper_tpu_torch.models.vlm import VIT_FAMILIES, encode_visual

    if arch.vision_backbones or arch.vision_family not in VIT_FAMILIES:
        raise ValueError("the frame-sharded encode takes one ViT tower")
    n, my = axis_size(mesh, SEQ), axis_index(mesh, SEQ)
    Fr = pixels.shape[0]
    if Fr % n:
        raise ValueError(f"{Fr} frames over {n} ranks")
    Floc = Fr // n
    local = pixels[my * Floc:(my + 1) * Floc]
    dev = model.llm_backbone.embeddings.weight.device
    px = torch.as_tensor(np.asarray(local) if not isinstance(local, torch.Tensor) else local,
                         device=dev)
    step = clip_size or Floc
    ve = torch.cat([encode_visual(model, arch, px[s:s + step]) for s in range(0, Floc, step)])
    return ve.reshape(1, -1, ve.shape[-1])
