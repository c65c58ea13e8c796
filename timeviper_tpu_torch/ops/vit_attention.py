"""K3 and K6: non-causal encoder attention as hand-written CUDA kernels.

K3, whole-frame ViT attention from the fused qkv layout, is the counterpart
of timeviper_tpu/ops/vit_attention.py:vit_attention_qkv and its dispatcher
encoder_attention_qkv, which every SigLIP and DINOv2 layer calls. The kernel
lives in csrc/vit_attn_qkv.cu and `vit_attention_qkv` launches it at any T
and frame count, head dims 72 and 64; its plain version splits the heads
and runs ops/attention.py:attention, as the JAX dispatcher does off the TPU.

K6, whole-clip attention over separate (B, T, H, hd) q, k and v, is the
counterpart of vit_attention and its dispatcher encoder_attention, which
every InternVideo2 layer calls (1025-token clips, hd 88). The kernel lives
in csrc/vit_attn.cu and `vit_attention` launches it at any T: it streams the
keys, so the JAX dispatcher's other TPU branches (the oracle below T = 256,
the padded flash fallback above 1280) have no counterpart here. It reads q,
k and v through their strides, so v may be a column slice of the fused qkv
projection.

The dispatchers `encoder_attention_qkv` and `encoder_attention` give a CPU
tensor to the plain version and a CUDA tensor to the kernel, which launches
or raises.
"""

from __future__ import annotations

import torch

from timeviper_tpu_torch.ops import _cuda
from timeviper_tpu_torch.ops.attention import attention

VIT_ATTN_HEAD_DIMS = (88,)  # instantiated in csrc/vit_attn.cu
VIT_QKV_HEAD_DIMS = (64, 72)  # instantiated in csrc/vit_attn_qkv.cu
# query rows a block of those kernels (three consumer warpgroups of 64), which
# tv_vit_attn and tv_vit_attn_qkv check: a clip's 1,025 rows take 6 blocks a
# head, a frame's 729 or 734 rows 4
VIT_ATTN_BLOCK_ROWS = 192
VIT_QKV_BLOCK_ROWS = 192


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
    if head_dim not in VIT_QKV_HEAD_DIMS:
        raise ValueError(f"vit_attention_qkv kernel: takes head dim {VIT_QKV_HEAD_DIMS}, "
                         f"got {head_dim}")
    out = torch.empty(B, T, num_heads * head_dim, dtype=qkv.dtype, device=qkv.device)
    err = _cuda.lib().tv_vit_attn_qkv(
        qkv.data_ptr(), out.data_ptr(), B, T, num_heads, head_dim, VIT_QKV_BLOCK_ROWS,
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


def vit_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, T, H, hd) each -> (B, T, H, hd): ops/attention.py:attention with no
    mask, as the JAX dispatcher runs off the TPU."""
    return attention(q, k, v)


def _check_operand(name: str, x: torch.Tensor, shape) -> None:
    """A bf16 CUDA tensor of `shape` whose head dim is contiguous, heads
    packed side by side, with a 16-byte aligned base and row and batch
    strides of whole 16-byte vectors."""
    if not (x.is_cuda and x.dtype == torch.bfloat16):
        raise ValueError(f"vit_attention kernel: {name} must be a bf16 CUDA tensor")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"vit_attention kernel: {name} has shape {tuple(x.shape)}, "
                         f"want {tuple(shape)}")
    bs, rs, hs, ds = x.stride()
    hd = shape[3]
    if ds != 1 or hs != hd:
        raise ValueError(f"vit_attention kernel: {name} must keep heads side by side "
                         f"in its rows (strides {x.stride()})")
    if x.data_ptr() % 16 or rs % 8 or bs % 8 or hd % 8:
        raise ValueError(f"vit_attention kernel: {name} needs a 16-byte aligned base and "
                         f"row, batch and head offsets of whole 8-element vectors "
                         f"(strides {x.stride()})")


def vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel: exact non-causal attention over (B, T, H, hd) CUDA
    tensors read through their strides; returns a contiguous (B, T, H, hd)."""
    B, T, H, hd = q.shape
    if hd not in VIT_ATTN_HEAD_DIMS:
        raise ValueError(f"vit_attention kernel: takes head dim {VIT_ATTN_HEAD_DIMS}, got {hd}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, (B, T, H, hd))
    out = torch.empty(B, T, H, hd, dtype=q.dtype, device=q.device)
    err = _cuda.lib().tv_vit_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, H, hd,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        VIT_ATTN_BLOCK_ROWS, hd ** -0.5, _cuda.stream_of(q))
    _cuda.check(err, "tv_vit_attn")
    vit_attention.launches += 1
    return out


vit_attention.launches = 0


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, T, H, hd) -> (B, T, H, hd): the plain version for a CPU tensor,
    the kernel for a CUDA tensor."""
    if q.device.type == "cpu":
        return vit_attention_plain(q, k, v)
    return vit_attention(q, k, v)
