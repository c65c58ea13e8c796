"""The backward that csrc/flash_bwd.cu (K2-bwd) computes, written out in f32
as its two kernels run it, against jax.vjp of the JAX package's
flash_attention (off the TPU its jnp oracle, as the package's own tests run
it), and the per-tile segment ids by which the kernels skip work.

The recompute is test-local and follows the kernels step by step:

- delta = rowsum(dO * O), O the forward's output;
- P = exp(s * scale - LSE) under the causal and segment mask, the LSE from
  ops/flash_attention.py:flash_lse_plain (K2's row log-sum-exp);
- dS = P * (dP - delta), dP = dO V^T;
- dV = P^T dO and dK = dS^T Q summed over the GQA group's query heads (the
  dK/dV kernel's loop over the group), dQ = dS K;
- the scale applied to dQ and dK at the end.

At L 200 with GQA 4:1 and 2:1, a -1 left pad and two segments (boundaries
inside 64-token tiles), f32 on both sides: 1e-5. Then tile_segment_ids
(each 64-token tile's least and greatest id) against a loop over the
tiles, and the rule the kernels take from it: a tile pair with one id on
both sides keeps every pair of the segment mask, and a pair whose id
ranges are disjoint keeps none.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, packed_seq, rng, t

from timeviper_tpu.ops.flash_pallas import flash_attention as jax_flash_attention
from timeviper_tpu_torch.ops.flash_attention import (
    flash_attention_plain,
    flash_lse_plain,
    tile_segment_ids,
)


def bwd_as_the_kernels_run_it(q, k, v, out, dout, lse, seg):
    """(dq, dk, dv) from the forward's output and row log-sum-exp."""
    B, L, Hq, D = q.shape
    Hkv = k.shape[2]
    rep, scale = Hq // Hkv, 1.0 / math.sqrt(D)
    kr, vr = k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)
    pos = torch.arange(L)
    keep = (pos[None, :] <= pos[:, None])[None, None]  # (1, 1, q, k)
    if seg is not None:
        keep = keep & (seg[:, None, :, None] == seg[:, None, None, :])
    delta = (dout * out).sum(-1).transpose(1, 2)  # (B, Hq, L)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr)
    p = torch.where(keep, torch.exp(s * scale - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout, vr)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q).reshape(B, L, Hkv, rep, D).sum(3) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout).reshape(B, L, Hkv, rep, D).sum(3)
    return dq, dk, dv


@pytest.mark.parametrize("Hq,Hkv", [(8, 2), (4, 2)])
def test_the_kernels_backward_matches_jax_vjp(Hq, Hkv):
    r = rng(31)
    B, L, D = 2, 200, 128
    q, k, v, dout = (r.standard_normal((B, L, h, D), np.float32) for h in (Hq, Hkv, Hkv, Hq))
    seg = packed_seq(B, L, 13, 100)
    tq, tk, tv, tseg = t(q), t(k), t(v), t(seg)
    out = flash_attention_plain(tq, tk, tv, tseg)
    lse = flash_lse_plain(tq, tk, tseg)
    got = bwd_as_the_kernels_run_it(tq, tk, tv, out, t(dout), lse, tseg)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c, segment_ids=jnp.asarray(seg)),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, w in zip(got, vjp(jnp.asarray(dout))):
        np.testing.assert_allclose(n(g), n(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("L,pad,cut", [(1, 0, 1), (63, 5, 40), (64, 0, 64), (65, 64, 64),
                                       (200, 13, 100), (256, 64, 128)])
def test_tile_segment_ids_give_each_tiles_id_range(L, pad, cut):
    seg = packed_seq(2, L, pad, cut)
    seg[1, : L // 3] = 7  # another layout in the second row
    got = n(tile_segment_ids(t(seg))).astype(np.int64)
    assert got.shape == (2, (L + 63) // 64, 2)
    for b in range(2):
        for i in range((L + 63) // 64):
            ids = seg[b, 64 * i:64 * (i + 1)]
            assert tuple(got[b, i]) == (ids.min(), ids.max())


def test_a_tile_pair_keeps_all_of_the_segment_mask_or_none_as_the_ranges_say():
    seg = packed_seq(1, 320, 100, 200)[0]  # tiles of -1, {-1, 0}, 0, {0, 1}, 1
    seg[300] = 3  # a tile with a gap in its range
    ranges = n(tile_segment_ids(t(seg[None])))[0].astype(np.int64)
    same = seg[:, None] == seg[None, :]
    kinds = set()
    for a in range(5):
        for c in range(5):
            block = same[64 * a:64 * (a + 1), 64 * c:64 * (c + 1)]
            (lo_a, hi_a), (lo_c, hi_c) = ranges[a], ranges[c]
            if lo_a == hi_a == lo_c == hi_c:
                assert block.all()
                kinds.add("one id")
            elif hi_a < lo_c or hi_c < lo_a:
                assert not block.any()
                kinds.add("apart")
    assert kinds == {"one id", "apart"}
