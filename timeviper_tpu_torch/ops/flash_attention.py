"""K2 and K2-bwd: causal flash attention, forward and backward, as hand-written
CUDA kernels, and K2-bwd's non-causal mode, the backward of TransV's
cross-attention.

Counterpart of timeviper_tpu/ops/flash_pallas.py:flash_attention, which runs
the attention layers of the Nemotron-H prefill and training step through
JAX's bundled Pallas TPU kernel (whose VJP is two more kernels, dkv and dq).
The forward lives in csrc/flash_fwd.cu (the causal mode of
csrc/attn_sm90.cuh, K9's tile) and, under autograd, also writes the row
log-sum-exp; the backward lives in csrc/flash_bwd.cu (a dQ kernel, which
also writes each row's delta and scaled LSE, then a dK/dV kernel, on the
same header's TMA ring and wgmma, at FLASH_BWD_TILE). The plain version is
ops/attention.py:attention under a causal, segment-equality mask,
differentiated by autograd; `flash_lse_plain` is the plain row log-sum-exp.

`flash_attention` is the entry point: a CPU tensor takes the plain version; a
CUDA tensor launches the kernels or raises. Under autograd the CUDA path is
`FlashAttnFn`, whose backward is `flash_attention_bwd` (K2-bwd's wrapper).
`cross_attention_bwd` is K2-bwd's non-causal mode (separate query and key
lengths, no segment ids), the backward of ops/block_attention.py:
BlockAttnFn, whose forward is K9; its plain version,
`cross_attention_bwd_plain`, computes the same formulas in f32 from the
same forward output. Each wrapper counts its own launches.
A tile is (query (row, head) pairs a block, keys a tile): a block packs
`gqa_pack(Hq, Hkv)` query heads of one KV head (4 on the 9B: 128 pairs are
32 tokens). The paths run FLASH_TILE; `flash_attention_fwd(tile=)` runs the
forward at any tile of FLASH_TILES for the K2 microbenchmark
(bench/microbench_flash.py, the counterpart of scripts/microbench_flash.py's
block-size sweep). tv_flash_fwd refuses a tile it does not instantiate.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from timeviper_tpu_torch.ops import _cuda
from timeviper_tpu_torch.ops.attention import attention, make_attention_mask
from timeviper_tpu_torch.ops.block_attention import gqa_pack, pad_key_ids

FLASH_TILE = (128, 128)  # (query (row, head) pairs a block, keys a tile) every path runs
FLASH_TILES = ((128, 128), (128, 64), (192, 64))  # instantiated in csrc/flash_fwd.cu
# K2-bwd's tile, built in csrc/flash_bwd.cu (tv_flash_bwd refuses another):
# (keys a dK/dV block, queries a tile of its stream, (row, head) pairs a dQ
# block, keys a tile of its stream)
FLASH_BWD_TILE = (128, 64, 128, 128)


def flash_attention_plain(q, k, v, segment_ids=None):
    """The plain version: dense causal (and segment) mask, f32 softmax."""
    mask = make_attention_mask(q.shape[1], k.shape[1], causal=True,
                               q_segment_ids=segment_ids,
                               kv_segment_ids=segment_ids, device=q.device)
    return attention(q, k, v, mask)


def flash_lse_plain(q, k, segment_ids=None, causal: bool = True):
    """The row log-sum-exp (B, Hq, Lq) f32 of the masked logits scaled by
    1/sqrt(D), as K2 writes it for K2-bwd (and as ops/block_attention.py:
    row_lse forms it from K9's row statistics, `causal` False): m + log(l),
    +inf for a row that sees no key."""
    _, Lq, Hq, D = q.shape
    Lk = k.shape[1]
    mask = make_attention_mask(Lq, Lk, causal=causal, q_segment_ids=segment_ids,
                               kv_segment_ids=segment_ids, device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.repeat_interleave(Hq // k.shape[2], 2).float()) / math.sqrt(D)
    if mask is not None:
        s = s.masked_fill(~mask.reshape(-1, 1, Lq, Lk), -math.inf)
    lse = torch.logsumexp(s, dim=-1)
    return torch.where(torch.isneginf(lse), math.inf, lse)


def flash_attention(
    q: torch.Tensor,  # (B, Lq, Hq, D)
    k: torch.Tensor,  # (B, Lk, Hkv, D)
    v: torch.Tensor,
    segment_ids: Optional[torch.Tensor] = None,  # (B, L) int32
) -> torch.Tensor:
    """Causal (optionally packed) attention, scale 1/sqrt(D); returns
    (B, Lq, Hq, D) in q.dtype. Differentiable in q, k and v."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, segment_ids)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttnFn.apply(q, k, v, segment_ids)
    return flash_attention_fwd(q, k, v, segment_ids, with_lse=False)[0]


flash_attention.launches = 0


class FlashAttnFn(torch.autograd.Function):
    """K2 forward (keeping the row log-sum-exp), K2-bwd backward."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids):
        out, lse = flash_attention_fwd(q, k, v, segment_ids, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, seg = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, seg)
        return dq, dk, dv, None


def flash_attention_bwd(q, k, v, out, dout, lse, segment_ids=None):
    """K2-bwd: (dq, dk, dv) of flash_attention given the output cotangent,
    the forward's output and its row log-sum-exp (B, Hq, L) f32. A CPU tensor
    takes the plain version."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, dout, segment_ids)
    _check(q, k, v, segment_ids)
    out = _launch_bwd(q, k, v, out, dout, lse, segment_ids, causal=True)
    flash_attention_bwd.launches += 1
    return out


flash_attention_bwd.launches = 0


def cross_attention_bwd(q, k, v, out, dout, lse):
    """K2-bwd's non-causal mode: (dq, dk, dv) of non-causal GQA attention of
    q (B, Lq, Hq, D) over k, v (B, Lk, Hkv, D), Lq and Lk any, given the
    output cotangent, the forward's output and its row log-sum-exp (B, Hq,
    Lq) f32 (+inf for a row that saw no key). An empty side (Lq or Lk 0)
    launches nothing and gives zeros. A CPU tensor takes the plain version."""
    if q.device.type == "cpu":
        return cross_attention_bwd_plain(q, k, v, out, dout)
    _check(q, k, v, None)
    if q.shape[1] == 0 or k.shape[1] == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    out = _launch_bwd(q, k, v, out, dout, lse, None, causal=False)
    cross_attention_bwd.launches += 1
    return out


cross_attention_bwd.launches = 0


def cross_attention_bwd_plain(q, k, v, out, dout, lse=None, mask=None):
    """The non-causal mode's plain version, in f32, from the forward's output
    as the bundled TPU kernels take it: P = softmax(Q K^T / sqrt(D)), delta
    = rowsum(dO * out), dS = P (dO V^T - delta); dq = dS K / sqrt(D), dk =
    dS^T Q / sqrt(D) and dv = P^T dO, each summed over its GQA group. Returns
    them in the inputs' dtypes. Given the row log-sum-exp `lse` (B, Hq, Lq),
    P = exp(Q K^T / sqrt(D) - lse), as the kernel forms it: then these keys
    may be a part of the keys that `out` and `lse` were taken over. `mask`
    (B or 1, Lq, Lk) bool, True = attend."""
    B, Lq, Hq, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    rep, scale = Hq // Hkv, 1.0 / math.sqrt(D)
    qf, dof = q.float(), dout.float()
    kr, vr = (t.float().repeat_interleave(rep, 2) for t in (k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kr) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None], -math.inf)
    p = torch.softmax(logits, dim=-1) if lse is None else torch.exp(logits - lse[..., None])
    delta = (dof * out.float()).sum(-1).transpose(1, 2)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vr) - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf).reshape(B, Lk, Hkv, rep, D).sum(3) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof).reshape(B, Lk, Hkv, rep, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _launch_bwd(q, k, v, out, dout, lse, segment_ids, causal: bool):
    """tv_flash_bwd on checked CUDA tensors, in either mode."""
    B, Lq, Hq, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    dout = dout.contiguous()
    for name, t in (("out", out), ("dout", dout)):
        if not (t.dtype == torch.bfloat16 and t.shape == q.shape and t.is_contiguous()):
            raise ValueError(f"flash_attention_bwd kernel: {name} must be contiguous bf16 "
                             f"like q")
    if not (lse.dtype == torch.float32 and lse.shape == (B, Hq, Lq) and lse.is_contiguous()):
        raise ValueError("flash_attention_bwd kernel: lse must be contiguous f32 (B, Hq, Lq)")
    if causal and Lq != Lk:
        raise ValueError(f"flash_attention_bwd kernel: the causal mode takes Lq == Lk, got "
                         f"{Lq}, {Lk}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # the row log-sum-exp times log2(e) and rowsum(dO * O), rows padded to 4
    lse2, delta = torch.empty(2, B, Hq, -(-Lq // 4) * 4, dtype=torch.float32,
                              device=q.device).unbind(0)
    seg_pad = tile_ids = None
    if segment_ids is not None:
        seg_pad, tile_ids = pad_key_ids(segment_ids), tile_segment_ids(segment_ids)
    p = _cuda.ptr
    err = _cuda.lib().tv_flash_bwd(
        p(q), p(k), p(v), p(out), p(dout), p(lse), p(segment_ids), p(seg_pad), p(tile_ids),
        p(lse2), p(delta), p(dq), p(dk), p(dv), B, Lq, Lk, Hq, Hkv, D, gqa_pack(Hq, Hkv),
        int(causal), *FLASH_BWD_TILE, 1.0 / math.sqrt(D), _cuda.stream_of(q))
    _cuda.check(err, "tv_flash_bwd")
    return dq, dk, dv


def tile_segment_ids(segment_ids: torch.Tensor) -> torch.Tensor:
    """(B, ceil(L / 64), 2) int32: the least and the greatest segment id of
    each tile of 64 tokens, K2-bwd's query tile FLASH_BWD_TILE[1] (the last
    tile padded with the row's last id; positions past L are masked by
    position). K2-bwd skips the segment compare for a tile pair that carries
    one id on both sides, and skips the pair outright where the two id ranges
    are disjoint."""
    B, L = segment_ids.shape
    tile = FLASH_BWD_TILE[1]
    pad = -L % tile
    x = torch.cat([segment_ids, segment_ids[:, -1:].expand(B, pad)], 1).view(B, -1, tile)
    return torch.stack([x.amin(-1), x.amax(-1)], -1).to(torch.int32).contiguous()


def flash_attention_bwd_plain(q, k, v, dout, segment_ids=None):
    """K2-bwd's plain version: autograd through flash_attention_plain."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention_plain(*leaves, segment_ids)
        return torch.autograd.grad(out, leaves, dout)


def _check(q, k, v, segment_ids):
    B, Lq, Hq, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not (t.device == dev and t.dtype == torch.bfloat16 and t.is_contiguous()
                and t.data_ptr() % 16 == 0):
            raise ValueError(f"flash_attention kernel: {name} must be contiguous, "
                             f"16-byte aligned bf16 on {dev}")
    if k.shape != (B, Lk, Hkv, D) or v.shape != k.shape:
        raise ValueError("flash_attention kernel: k/v shape")
    if D != 128 or Hq % Hkv:
        raise ValueError(f"flash_attention kernel: takes head dim 128 and Hq % Hkv == 0, "
                         f"got D={D}, Hq={Hq}, Hkv={Hkv}")
    if segment_ids is not None and not (
            Lq == Lk and segment_ids.device == dev and segment_ids.dtype == torch.int32
            and segment_ids.shape == (B, Lq) and segment_ids.is_contiguous()):
        raise ValueError("flash_attention kernel: segment_ids must be contiguous "
                         "int32 (B, L) with Lq == Lk")


def flash_attention_fwd(q, k, v, segment_ids, with_lse: bool, tile=FLASH_TILE):
    """K2 on CUDA tensors at `tile` = (query (row, head) pairs a block, keys
    a tile) of FLASH_TILES -> (out, the row log-sum-exp (B, Hq, L) f32 that
    K2-bwd takes, or None)."""
    if tuple(tile) not in FLASH_TILES:
        raise ValueError(f"flash_attention kernel: tile {tile} is not one of {FLASH_TILES}")
    _check(q, k, v, segment_ids)
    B, Lq, Hq, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    if with_lse and Lq != Lk:
        raise ValueError("flash_attention kernel: the backward takes Lq == Lk")
    out = torch.empty_like(q)
    lse = (torch.empty(B, Hq, Lq, dtype=torch.float32, device=q.device)
           if with_lse else None)
    seg_kv = None if segment_ids is None else pad_key_ids(segment_ids)
    p = _cuda.ptr
    err = _cuda.lib().tv_flash_fwd(
        p(q), p(k), p(v), p(segment_ids), p(seg_kv), p(out), p(lse), B, Lq, Lk, Hq, Hkv, D,
        gqa_pack(Hq, Hkv), tile[0], tile[1], 1.0 / math.sqrt(D), _cuda.stream_of(q))
    _cuda.check(err, "tv_flash_fwd")
    flash_attention.launches += 1
    return out, lse

