"""K2 and K2-bwd: causal flash attention, forward and backward, as hand-written
CUDA kernels.

Counterpart of timeviper_tpu/ops/flash_pallas.py:flash_attention, which runs
the attention layers of the Nemotron-H prefill and training step through
JAX's bundled Pallas TPU kernel (whose VJP is two more kernels, dkv and dq).
The forward lives in csrc/flash_fwd.cu (the causal mode of
csrc/attn_sm90.cuh, K9's tile) and, under autograd, also writes the row
log-sum-exp; the backward lives in csrc/flash_bwd.cu. The plain version is
ops/attention.py:attention under a causal, segment-equality mask,
differentiated by autograd; `flash_lse_plain` is the plain row log-sum-exp.

`flash_attention` is the entry point: a CPU tensor takes the plain version; a
CUDA tensor launches the kernels or raises. Under autograd the CUDA path is
`FlashAttnFn`, whose backward is `flash_attention_bwd` (K2-bwd's wrapper).
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


def flash_attention_plain(q, k, v, segment_ids=None):
    """The plain version: dense causal (and segment) mask, f32 softmax."""
    mask = make_attention_mask(q.shape[1], k.shape[1], causal=True,
                               q_segment_ids=segment_ids,
                               kv_segment_ids=segment_ids, device=q.device)
    return attention(q, k, v, mask)


def flash_lse_plain(q, k, segment_ids=None):
    """The row log-sum-exp (B, Hq, Lq) f32 of the masked logits scaled by
    1/sqrt(D), as K2 writes it for K2-bwd: m + log(l), +inf for a row that
    sees no key."""
    _, Lq, Hq, D = q.shape
    Lk = k.shape[1]
    mask = make_attention_mask(Lq, Lk, causal=True, q_segment_ids=segment_ids,
                               kv_segment_ids=segment_ids, device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.repeat_interleave(Hq // k.shape[2], 2).float()) / math.sqrt(D)
    lse = torch.logsumexp(s.masked_fill(~mask.reshape(-1, 1, Lq, Lk), -math.inf), dim=-1)
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
    B, L, Hq, D = q.shape
    Hkv = k.shape[2]
    _check(q, k, v, segment_ids)
    dout = dout.contiguous()
    for name, t in (("out", out), ("dout", dout)):
        if not (t.dtype == torch.bfloat16 and t.shape == q.shape and t.is_contiguous()):
            raise ValueError(f"flash_attention_bwd kernel: {name} must be contiguous bf16 "
                             f"like q")
    if not (lse.dtype == torch.float32 and lse.shape == (B, Hq, L) and lse.is_contiguous()):
        raise ValueError("flash_attention_bwd kernel: lse must be contiguous f32 (B, Hq, L)")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(B, Hq, L, dtype=torch.float32, device=q.device)
    p = _cuda.ptr
    err = _cuda.lib().tv_flash_bwd(
        p(q), p(k), p(v), p(out), p(dout), p(lse), p(segment_ids), p(delta), p(dq), p(dk),
        p(dv), B, L, Hq, Hkv, D, 1.0 / math.sqrt(D), _cuda.stream_of(q))
    _cuda.check(err, "tv_flash_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


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

