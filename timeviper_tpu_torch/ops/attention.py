"""Attention in plain PyTorch (counterpart of timeviper_tpu/ops/attention.py).

`attention` is the plain version of the two attention kernels (K2 in
ops/flash_attention.py, K3 in ops/vit_attention.py) and the decode attention.
GQA is written into the einsum: query head h reads KV head h // (Hq/Hkv), with
no repeat of the KV heads. `cross_attention` (TransV, models/pdrop.py) takes
`attention` on a CPU tensor and K9 (ops/block_attention.py) on a CUDA one.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from timeviper_tpu_torch.ops.block_attention import block_attn_lse

NEG_INF = torch.finfo(torch.float32).min


def make_attention_mask(
    q_len: int,
    kv_len: int,
    *,
    causal: bool = True,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    device=None,
) -> Optional[torch.Tensor]:
    """Boolean (B or 1, q_len, kv_len) mask, True = attend; None if nothing
    constrains attention."""
    masks = []
    if causal:
        qp = torch.arange(q_len, device=device)[None, :, None]
        kp = torch.arange(kv_len, device=device)[None, None, :]
        masks.append(qp >= kp)
    if q_segment_ids is not None and kv_segment_ids is not None:
        masks.append(q_segment_ids[:, :, None] == kv_segment_ids[:, None, :])
    if not masks:
        return None
    out = masks[0]
    for m in masks[1:]:
        out = out & m
    return out


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Softmax attention with GQA, scale 1/sqrt(D). q (B, Lq, Hq, D); k, v
    (B, Lk, Hkv, D); mask broadcastable to (B, Lq, Lk), True = attend. Softmax
    in float32; returns (B, Lq, Hq, D) in q.dtype."""
    B, Lq, Hq, D = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Lq, Hkv, rep, D).float()
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg, k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs.to(v.dtype).float(), v.float())
    return out.reshape(B, Lq, Hq, D).to(q.dtype)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal GQA attention of q (B, Lq, Hq, D) over k, v (B, Lk, Hkv, D)
    (timeviper_tpu/ops/attention.py:128, without its `kv_valid`, which no
    caller passes). A CPU tensor takes `attention`; a CUDA tensor K9's
    non-causal mode, its row statistics dropped, or raises. All-zero keys and
    values give exactly 0 on both."""
    if q.device.type == "cpu":
        return attention(q, k, v)
    return block_attn_lse(q, k, v, causal=False)[0]
