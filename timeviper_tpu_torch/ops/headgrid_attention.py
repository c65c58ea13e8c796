"""K10a: head-grid ViT attention at head dim 128, as a hand-written CUDA
kernel (csrc/headgrid_attn.cu: csrc/attn_sm90.cuh with the TPU kernel's
softmax without a row max, `hpp` heads walked in turn by one block).

Counterpart of scripts/microbench_vit_attn.py:headgrid_attention (the
pallas_call of _headgrid_kernel), which probes SigLIP's attention (729
tokens, 16 heads of 72) with every head zero-padded to 128 columns, `hpp`
heads a program, no row max, and `do_exp=False` for the two products
without the softmax. Only the ViT attention microbenchmark
(bench/microbench_vit_attn.py) runs it; the model's attention is K3
(ops/vit_attention.py).

`headgrid_attention_plain` is the TPU kernel's formula in torch;
`headgrid_attention` gives a CPU tensor to it and launches the kernel on a
CUDA tensor (or raises). `pad_heads` lays a (B, T, 3 * H * hd) qkv buffer out
at 128 columns a head, as the script's pad_heads does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from timeviper_tpu_torch.ops import _cuda

HD = 128  # the padded head dim the kernel takes
HPP = (1, 2, 4)  # heads a program, instantiated in csrc/headgrid_attn.cu
# (query rows a block, keys a tile) built in csrc/headgrid_attn.cu, which
# refuses another
HEADGRID_TILE = (192, 64)


def pad_heads(qkv: torch.Tensor, num_heads: int, head_dim: int, hd_new: int = HD
              ) -> torch.Tensor:
    """(B, T, 3 * H * hd) -> (B, T, 3 * H * hd_new), each head's columns
    zero-padded at its end."""
    B, T, _ = qkv.shape
    x = qkv.reshape(B, T, 3, num_heads, head_dim)
    return F.pad(x, (0, hd_new - head_dim)).reshape(B, T, 3 * num_heads * hd_new)


def headgrid_attention_plain(qkv: torch.Tensor, num_heads: int, scale: float,
                             do_exp: bool = True) -> torch.Tensor:
    """(B, T, 3 * H * 128) -> (B, T, H * 128) in qkv's dtype: q times the
    scale rounded to qkv's dtype; s = q k^T in f32; p = exp(min(s, 75)) (no
    row max), or 0.01 s without do_exp, rounded to qkv's dtype; o = (p v) /
    max(sum of p, 1e-30) (the sum is 1 without do_exp). The TPU kernel's
    mask of the keys past `t_valid` keeps all T keys at its one caller, so
    there is none here."""
    B, T, _ = qkv.shape
    q, k, v = qkv.reshape(B, T, 3, num_heads, HD).unbind(2)
    q = q * torch.tensor(scale, dtype=qkv.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if do_exp:
        p = torch.exp(torch.clamp(s, max=75.0)).to(qkv.dtype).float()
        l = p.sum(-1, keepdim=True)
    else:
        p = (s * 0.01).to(qkv.dtype).float()
        l = torch.ones_like(s[..., :1])
    o = torch.einsum("bhqk,bkhd->bhqd", p, v.float()) * (1.0 / torch.clamp(l, min=1e-30))
    return o.transpose(1, 2).reshape(B, T, num_heads * HD).to(qkv.dtype)


def headgrid_attention(qkv: torch.Tensor, num_heads: int, hpp: int, scale: float,
                       do_exp: bool = True) -> torch.Tensor:
    """The plain version for a CPU tensor; the kernel, `hpp` heads a block,
    for a CUDA tensor."""
    if qkv.device.type == "cpu":
        return headgrid_attention_plain(qkv, num_heads, scale, do_exp)
    B, T, width = qkv.shape
    if not (qkv.is_cuda and qkv.dtype == torch.bfloat16 and qkv.is_contiguous()
            and qkv.data_ptr() % 16 == 0):
        raise ValueError("headgrid_attention kernel: qkv must be a contiguous, 16-byte "
                         "aligned bf16 CUDA tensor")
    if width != 3 * num_heads * HD:
        raise ValueError(f"headgrid_attention kernel: width {width} != 3*{num_heads}*{HD}")
    if hpp not in HPP or num_heads % hpp:
        raise ValueError(f"headgrid_attention kernel: hpp {hpp} must be one of {HPP} and "
                         f"divide {num_heads} heads")
    out = torch.empty(B, T, num_heads * HD, dtype=qkv.dtype, device=qkv.device)
    err = _cuda.lib().tv_headgrid_attn(
        qkv.data_ptr(), out.data_ptr(), B, T, num_heads, hpp, int(do_exp), *HEADGRID_TILE,
        scale, _cuda.stream_of(qkv))
    _cuda.check(err, "tv_headgrid_attn")
    headgrid_attention.launches += 1
    return out


headgrid_attention.launches = 0
