"""K3: whole-frame ViT attention from the fused qkv layout, as a hand-written
CUDA kernel.

Counterpart of timeviper_tpu/ops/vit_attention.py:vit_attention_qkv and its
dispatcher encoder_attention_qkv, which every SigLIP layer calls. The kernel
lives in csrc/vit_attn_qkv.cu and `vit_attention_qkv` launches it; its plain
version splits the heads and runs ops/attention.py:attention, as the JAX
dispatcher does off the TPU. `encoder_attention_qkv`, the encoder's entry
point, gives a CPU tensor to the plain version and a CUDA tensor to the
kernel, which launches or raises.
"""

from __future__ import annotations

import torch

from timeviper_tpu_torch.ops import _cuda
from timeviper_tpu_torch.ops.attention import attention


def vit_attention_qkv_plain(qkv: torch.Tensor, num_heads: int, head_dim: int) -> torch.Tensor:
    """(B, T, 3*H*hd) with columns ordered (3, H, hd) -> (B, T, H*hd)."""
    B, T, _ = qkv.shape
    q, k, v = qkv.reshape(B, T, 3, num_heads, head_dim).unbind(2)
    return attention(q, k, v).reshape(B, T, num_heads * head_dim)


def vit_attention_qkv(qkv: torch.Tensor, num_heads: int, head_dim: int) -> torch.Tensor:
    """The kernel: exact non-causal attention read straight from the fused
    qkv buffer of a CUDA tensor."""
    B, T, D3 = qkv.shape
    if not (qkv.is_cuda and qkv.dtype == torch.bfloat16 and qkv.is_contiguous() and qkv.data_ptr() % 16 == 0):
        raise ValueError("vit_attention_qkv kernel: qkv must be a contiguous, "
                         "16-byte aligned bf16 CUDA tensor")
    if D3 != 3 * num_heads * head_dim:
        raise ValueError(f"vit_attention_qkv kernel: width {D3} != 3*{num_heads}*{head_dim}")
    if head_dim not in (64, 72):
        raise ValueError(f"vit_attention_qkv kernel: takes head dim 64 or 72, got {head_dim}")
    out = torch.empty(B, T, num_heads * head_dim, dtype=qkv.dtype, device=qkv.device)
    err = _cuda.lib().tv_vit_attn_qkv(
        qkv.data_ptr(), out.data_ptr(), B, T, num_heads, head_dim,
        head_dim ** -0.5, _cuda.stream_of(qkv))
    _cuda.check(err, "tv_vit_attn_qkv")
    vit_attention_qkv.launches += 1
    return out


vit_attention_qkv.launches = 0


def encoder_attention_qkv(qkv: torch.Tensor, num_heads: int, head_dim: int) -> torch.Tensor:
    """(B, T, 3*H*hd) -> (B, T, H*hd): the plain version for a CPU tensor,
    the kernel for a CUDA tensor."""
    if qkv.device.type == "cpu":
        return vit_attention_qkv_plain(qkv, num_heads, head_dim)
    return vit_attention_qkv(qkv, num_heads, head_dim)
