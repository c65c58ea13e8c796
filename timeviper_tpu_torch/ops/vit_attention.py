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

Both kernels have an LSE variant (`lse=True`) that also returns each row's
log-sum-exp (B, H, T) f32, and both have one backward, the hand-written
csrc/vit_attn_bwd.cu (`vit_attention_bwd`, `vit_attention_qkv_bwd`), which
replaces no TPU kernel: the JAX package differentiates its jnp oracle
(timeviper_tpu/ops/vit_attention.py:318-336). Under autograd on the card
(grad enabled and an input requiring it) the dispatchers take `VitAttnQKVFn`
and `VitAttnFn`: the kernel's LSE variant forward, the backward kernel
backward. Its plain versions (`vit_attention_bwd_plain`,
`vit_attention_qkv_bwd_plain`) compute the same formulas in f32 from the
forward's output and LSE.

The dispatchers `encoder_attention_qkv` and `encoder_attention` give a CPU
tensor to the plain version (under autograd, differentiated as it stands,
as JAX differentiates its oracle) and a CUDA tensor to the kernel, which
launches or raises.
"""

from __future__ import annotations

import math

import torch

from timeviper_tpu_torch.ops import _cuda
from timeviper_tpu_torch.ops.attention import attention
from timeviper_tpu_torch.ops.flash_attention import flash_lse_plain

VIT_ATTN_HEAD_DIMS = (88,)  # instantiated in csrc/vit_attn.cu
VIT_QKV_HEAD_DIMS = (64, 72)  # instantiated in csrc/vit_attn_qkv.cu
# query rows a block of those kernels (three consumer warpgroups of 64), which
# tv_vit_attn and tv_vit_attn_qkv check: a clip's 1,025 rows take 6 blocks a
# head, a frame's 729 or 734 rows 4
VIT_ATTN_BLOCK_ROWS = 192
VIT_QKV_BLOCK_ROWS = 192
VIT_BWD_HEAD_DIMS = (64, 72, 88)  # instantiated in csrc/vit_attn_bwd.cu
# (keys a dkv block, query rows a dq block) of the backward, which
# tv_vit_attn_bwd checks
VIT_BWD_TILE = (128, 128)
# frames a chunk of the plain backward: its (chunk, H, T, T) f32 tensors
PLAIN_BWD_CHUNK = 8


def vit_attention_qkv_plain(qkv: torch.Tensor, num_heads: int, head_dim: int) -> torch.Tensor:
    """(B, T, 3*H*hd) with columns ordered (3, H, hd) -> (B, T, H*hd)."""
    B, T, _ = qkv.shape
    q, k, v = qkv.reshape(B, T, 3, num_heads, head_dim).unbind(2)
    return attention(q, k, v).reshape(B, T, num_heads * head_dim)


def vit_attention_qkv_lse_plain(qkv: torch.Tensor, num_heads: int, head_dim: int):
    """The plain version with the row log-sum-exp (B, H, T) f32 of the
    scaled logits, as the LSE variant writes it."""
    B, T, _ = qkv.shape
    q, k, _ = qkv.reshape(B, T, 3, num_heads, head_dim).unbind(2)
    return (vit_attention_qkv_plain(qkv, num_heads, head_dim),
            flash_lse_plain(q, k, causal=False))


def vit_attention_qkv(qkv: torch.Tensor, num_heads: int, head_dim: int, lse: bool = False):
    """The kernel: exact non-causal attention read straight from the fused
    qkv buffer of a CUDA tensor. `lse`: also return the row log-sum-exp
    (B, H, T) f32 (the LSE variant)."""
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
    row_lse = (torch.empty(B, num_heads, T, dtype=torch.float32, device=qkv.device)
               if lse else None)
    err = _cuda.lib().tv_vit_attn_qkv(
        qkv.data_ptr(), out.data_ptr(), _cuda.ptr(row_lse), B, T, num_heads, head_dim,
        VIT_QKV_BLOCK_ROWS, head_dim ** -0.5, _cuda.stream_of(qkv))
    _cuda.check(err, "tv_vit_attn_qkv")
    vit_attention_qkv.launches += 1
    return (out, row_lse) if lse else out


vit_attention_qkv.launches = 0


def encoder_attention_qkv(qkv: torch.Tensor, num_heads: int, head_dim: int) -> torch.Tensor:
    """(B, T, 3*H*hd) -> (B, T, H*hd): the plain version for a CPU tensor,
    the kernel for a CUDA tensor."""
    if qkv.device.type == "cpu":
        return vit_attention_qkv_plain(qkv, num_heads, head_dim)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return VitAttnQKVFn.apply(qkv, num_heads, head_dim)
    return vit_attention_qkv(qkv, num_heads, head_dim)


def vit_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, T, H, hd) each -> (B, T, H, hd): ops/attention.py:attention with no
    mask, as the JAX dispatcher runs off the TPU."""
    return attention(q, k, v)


def _check_operand(name: str, x: torch.Tensor, shape, kernel: str = "vit_attention") -> None:
    """A bf16 CUDA tensor of `shape` whose head dim is contiguous, heads
    packed side by side, with a 16-byte aligned base and row and batch
    strides of whole 16-byte vectors."""
    if not (x.is_cuda and x.dtype == torch.bfloat16):
        raise ValueError(f"{kernel} kernel: {name} must be a bf16 CUDA tensor")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{kernel} kernel: {name} has shape {tuple(x.shape)}, "
                         f"want {tuple(shape)}")
    bs, rs, hs, ds = x.stride()
    hd = shape[3]
    if ds != 1 or hs != hd:
        raise ValueError(f"{kernel} kernel: {name} must keep heads side by side "
                         f"in its rows (strides {x.stride()})")
    if x.data_ptr() % 16 or rs % 8 or bs % 8 or hd % 8:
        raise ValueError(f"{kernel} kernel: {name} needs a 16-byte aligned base and "
                         f"row, batch and head offsets of whole 8-element vectors "
                         f"(strides {x.stride()})")


def vit_attention_lse_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The plain version with the row log-sum-exp (B, H, T) f32."""
    return vit_attention_plain(q, k, v), flash_lse_plain(q, k, causal=False)


def vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: bool = False):
    """The kernel: exact non-causal attention over (B, T, H, hd) CUDA
    tensors read through their strides; returns a contiguous (B, T, H, hd)
    and, with `lse`, the row log-sum-exp (B, H, T) f32 (the LSE variant)."""
    B, T, H, hd = q.shape
    if hd not in VIT_ATTN_HEAD_DIMS:
        raise ValueError(f"vit_attention kernel: takes head dim {VIT_ATTN_HEAD_DIMS}, got {hd}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, (B, T, H, hd))
    out = torch.empty(B, T, H, hd, dtype=q.dtype, device=q.device)
    row_lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device) if lse else None
    err = _cuda.lib().tv_vit_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _cuda.ptr(row_lse), B, T, H,
        hd, q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        VIT_ATTN_BLOCK_ROWS, hd ** -0.5, _cuda.stream_of(q))
    _cuda.check(err, "tv_vit_attn")
    vit_attention.launches += 1
    return (out, row_lse) if lse else out


vit_attention.launches = 0


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, T, H, hd) -> (B, T, H, hd): the plain version for a CPU tensor,
    the kernel for a CUDA tensor."""
    if q.device.type == "cpu":
        return vit_attention_plain(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return VitAttnFn.apply(q, k, v)
    return vit_attention(q, k, v)


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------


def vit_attention_bwd_plain(q, k, v, out, dout, lse=None):
    """The backward's plain version in f32 over (B, T, H, hd) tensors, from
    the forward's output: P = exp(Q K^T / sqrt(hd) - lse) (softmax when no
    LSE is given), D = rowsum(dO * out), dS = P (dO V^T - D); dq = dS K /
    sqrt(hd), dk = dS^T Q / sqrt(hd), dv = P^T dO. Runs PLAIN_BWD_CHUNK
    frames at a time; returns (dq, dk, dv) contiguous in the inputs' dtype."""
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    grads = [torch.empty(q.shape, dtype=x.dtype, device=x.device) for x in (q, k, v)]
    for b0 in range(0, q.shape[0], PLAIN_BWD_CHUNK):
        sl = slice(b0, b0 + PLAIN_BWD_CHUNK)
        qf, kf, vf, dof = (x[sl].float() for x in (q, k, v, dout))
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
        p = (torch.exp(s - lse[sl, :, :, None]) if lse is not None
             else torch.softmax(s, dim=-1))
        del s
        delta = (dof * out[sl].float()).sum(-1).transpose(1, 2)
        ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta[..., None])
        grads[0][sl] = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
        grads[1][sl] = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
        grads[2][sl] = torch.einsum("bhqk,bqhd->bkhd", p, dof)
        del p, ds
    return tuple(grads)


def vit_attention_qkv_bwd_plain(qkv, out, dout, num_heads: int, head_dim: int, lse=None):
    """The fused layout's plain backward: (B, T, 3*H*hd) qkv, out and dout
    (B, T, H*hd) -> dqkv (B, T, 3*H*hd)."""
    B, T, _ = qkv.shape
    q, k, v = qkv.reshape(B, T, 3, num_heads, head_dim).unbind(2)
    shape = (B, T, num_heads, head_dim)
    grads = vit_attention_bwd_plain(q, k, v, out.reshape(shape), dout.reshape(shape), lse)
    return torch.stack(grads, dim=2).reshape(qkv.shape)


def vit_attention_bwd(q, k, v, out, dout, lse, grads=None):
    """The backward kernel (csrc/vit_attn_bwd.cu): (dq, dk, dv) of exact
    non-causal attention over (B, T, H, hd) CUDA tensors read through their
    strides, given the forward's output, its row log-sum-exp (B, H, T) f32
    and the output cotangent. `grads`: three (B, T, H, hd) views with one
    set of strides to write into (the fused qkv gradient's column bands);
    else three fresh contiguous tensors."""
    B, T, H, hd = q.shape
    if hd not in VIT_BWD_HEAD_DIMS:
        raise ValueError(f"vit_attention_bwd kernel: takes head dim {VIT_BWD_HEAD_DIMS}, "
                         f"got {hd}")
    shape = (B, T, H, hd)
    dout = dout.contiguous()
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)):
        _check_operand(name, x, shape, "vit_attention_bwd")
    for name, x in (("out", out), ("dout", dout)):
        if not x.is_contiguous():
            raise ValueError(f"vit_attention_bwd kernel: {name} must be contiguous")
    if not (lse.dtype == torch.float32 and lse.shape == (B, H, T) and lse.is_contiguous()
            and lse.device == q.device):
        raise ValueError("vit_attention_bwd kernel: lse must be contiguous f32 (B, H, T)")
    if grads is None:
        grads = tuple(torch.empty(shape, dtype=q.dtype, device=q.device) for _ in range(3))
    for name, x in zip(("dq", "dk", "dv"), grads):
        _check_operand(name, x, shape, "vit_attention_bwd")
    if len({x.stride() for x in grads}) != 1:
        raise ValueError("vit_attention_bwd kernel: dq, dk and dv must share their strides")
    # the row log-sum-exp times log2(e) and rowsum(dO * O), rows padded to 4
    lse2, delta = torch.empty(2, B, H, -(-T // 4) * 4, dtype=torch.float32,
                              device=q.device).unbind(0)
    p = _cuda.ptr
    err = _cuda.lib().tv_vit_attn_bwd(
        p(q), p(k), p(v), p(out), p(dout), p(lse), p(lse2), p(delta), *(p(x) for x in grads),
        B, T, H, hd, q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), grads[0].stride(0), grads[0].stride(1), *VIT_BWD_TILE, hd ** -0.5,
        _cuda.stream_of(q))
    _cuda.check(err, "tv_vit_attn_bwd")
    vit_attention_bwd.launches += 1
    return tuple(grads)


vit_attention_bwd.launches = 0


def vit_attention_qkv_bwd(qkv, out, dout, num_heads: int, head_dim: int, lse):
    """The backward kernel for the fused layout: dqkv (B, T, 3*H*hd), its
    q, k and v column bands written in place."""
    B, T, _ = qkv.shape
    shape = (B, T, num_heads, head_dim)
    dqkv = torch.empty_like(qkv)
    q, k, v = qkv.reshape(B, T, 3, num_heads, head_dim).unbind(2)
    vit_attention_bwd(q, k, v, out.reshape(shape), dout.reshape(shape), lse,
                      grads=dqkv.reshape(B, T, 3, num_heads, head_dim).unbind(2))
    return dqkv


class VitAttnQKVFn(torch.autograd.Function):
    """K3 with its LSE forward, the backward kernel backward."""

    @staticmethod
    def forward(ctx, qkv, num_heads, head_dim):
        out, lse = vit_attention_qkv(qkv, num_heads, head_dim, lse=True)
        ctx.save_for_backward(qkv, out, lse)
        ctx.heads = (num_heads, head_dim)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        return vit_attention_qkv_bwd(qkv, out, dout, *ctx.heads, lse), None, None


class VitAttnFn(torch.autograd.Function):
    """K6 with its LSE forward, the backward kernel backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = vit_attention(q, k, v, lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return vit_attention_bwd(q, k, v, out, dout, lse)
