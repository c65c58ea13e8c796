"""K2: causal flash-attention forward as a hand-written CUDA kernel.

Counterpart of timeviper_tpu/ops/flash_pallas.py:flash_attention, which runs
the attention layers of the Nemotron-H prefill. The kernel lives in
csrc/flash_fwd.cu; its plain version is ops/attention.py:attention under a
causal, segment-equality mask. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from timeviper_tpu_torch.ops import _cuda
from timeviper_tpu_torch.ops.attention import attention, make_attention_mask


def flash_attention_plain(q, k, v, segment_ids=None):
    """The plain version: dense causal (and segment) mask, f32 softmax."""
    mask = make_attention_mask(q.shape[1], k.shape[1], causal=True,
                               q_segment_ids=segment_ids,
                               kv_segment_ids=segment_ids, device=q.device)
    return attention(q, k, v, mask)


def flash_attention(
    q: torch.Tensor,  # (B, Lq, Hq, D)
    k: torch.Tensor,  # (B, Lk, Hkv, D)
    v: torch.Tensor,
    segment_ids: Optional[torch.Tensor] = None,  # (B, L) int32
) -> torch.Tensor:
    """Causal (optionally packed) attention, scale 1/sqrt(D); returns
    (B, Lq, Hq, D) in q.dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, segment_ids)
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
    out = torch.empty_like(q)
    p = _cuda.ptr
    err = _cuda.lib().tv_flash_fwd(
        p(q), p(k), p(v), p(segment_ids), p(out), B, Lq, Lk, Hq, Hkv, D,
        1.0 / math.sqrt(D), _cuda.stream_of(q))
    _cuda.check(err, "tv_flash_fwd")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
