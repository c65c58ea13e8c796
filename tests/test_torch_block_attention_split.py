"""K9's split-key plan (ops/block_attention.py:block_attn_plan) and the plain
split-and-merge that the kernel's two launches compute: the plain version on
each split's key range, then merge_parts, the plain counterpart of
csrc/block_attn.cu:attn_merge_kernel.

The plan must cover every key exactly once in tile-aligned pieces and depend
on the shapes alone (never on the card). The plain split-and-merge is held
against the JAX package's parallel/seq_parallel.py:_block_attn_lse (its dense
branch on the CPU) in f32 to 1e-5, the tolerance of
tests/test_torch_block_attention.py: both are f32 sums in other orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, rng, t

from timeviper_tpu.parallel.seq_parallel import _block_attn_lse
from timeviper_tpu_torch.ops.block_attention import (
    ATTN_BKV,
    block_attn_lse_plain,
    block_attn_plan,
    fold_segments,
    merge_parts,
)

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = [  # (B, Lq, Lk, Hq, Hkv, causal): the 9B's paths, then small ones
    (1, 4096, 12288, 32, 8, False), (1, 256, 16384, 32, 8, False),
    (1, 12, 16384, 32, 8, False), (1, 40, 16384, 32, 8, False),
    (1, 300, 16384, 32, 8, False), (1, 4096, 4096, 32, 8, True),
    (2, 70, 225, 8, 2, False), (1, 1, 5000, 4, 4, False), (3, 5, 1100, 4, 2, False),
    (1, 12, 0, 32, 8, False), (1, 7, 4100, 6, 3, False), (1, 12, 12, 32, 8, True),
]


def split_ranges(Lk, n_split, split_tiles):
    """The key rows [begin, end) that each split of a plan walks, as the
    kernel's blocks take them (csrc/attn_sm90.cuh: kv_begin, kv_end)."""
    step = split_tiles * ATTN_BKV
    return [(s * step, min(Lk, (s + 1) * step)) for s in range(n_split)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_every_key_once_in_whole_tiles(shape):
    B, Lq, Lk, Hq, Hkv, causal = shape
    pack, n_split, split_tiles = block_attn_plan(*shape)
    assert (Hq // Hkv) % pack == 0 and 64 % pack == 0
    assert n_split == 1 or not causal
    ranges = split_ranges(Lk, n_split, split_tiles)
    assert len(ranges) == n_split
    assert ranges[0][0] == 0 and ranges[-1][1] == Lk
    for (a, e), (a2, _) in zip(ranges, ranges[1:]):
        assert e == a2  # contiguous: no key twice, none left out
    for a, e in ranges:
        assert a % ATTN_BKV == 0 and e - a <= split_tiles * ATTN_BKV
        assert e > a or Lk == 0  # no split walks no key


def test_plan_depends_only_on_the_shapes(monkeypatch):
    """The same shapes give the same plan, with no card to ask: a plan that
    read the card's SM count would give other bits on another card."""
    def refuse(*args, **kwargs):
        raise AssertionError("the plan asked the device")

    for name in ("device_count", "get_device_properties", "is_available", "current_device"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    plans = [block_attn_plan(*s) for s in SHAPES]
    assert plans == [block_attn_plan(*s) for s in SHAPES]
    # the 9B's paths: a clip's prefix part and the causal part never split,
    # short questions against a 16k prefix do
    assert plans[0] == (4, 1, 96) and plans[5][1] == 1
    assert plans[1] == (4, 4, 32) and plans[2] == (4, 32, 4)
    assert all(isinstance(x, int) for p in plans for x in p)


def block_attn_split_plain(q, k, v, **kw):
    """The plain version run as the kernel runs it: on each split of
    block_attn_plan's key ranges (the valid masks folded into segment ids
    first, as the wrapper folds them), then merged by merge_parts."""
    B, Lq, Hq, _ = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    _, n_split, split_tiles = block_attn_plan(B, Lq, Lk, Hq, Hkv)
    sq, sk = fold_segments(B, Lq, Lk, device=q.device, **kw)
    parts = [block_attn_lse_plain(q, k[:, a:e], v[:, a:e], seg_q=sq,
                                  seg_kv=None if sk is None else sk[:, a:e])
             for a, e in split_ranges(Lk, n_split, split_tiles)]
    return merge_parts(parts)


def _inputs(B, Lq, Lk, Hq, Hkv, D=16, seed=0):
    r = rng(seed)
    return tuple(r.standard_normal(s, np.float32)
                 for s in ((B, Lq, Hq, D), (B, Lk, Hkv, D), (B, Lk, Hkv, D)))


def _check(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), **TOL)


@pytest.mark.parametrize("Hkv", [4, 1])  # GQA groups of 1 and 4
def test_split_and_merge_matches_jax(Hkv):
    """Lk 4,100 (a ragged last tile) in 7 splits of 640 keys, with segments:
    row 0 sees only keys in the first split (every other split is empty for
    it), row 1 none at all, row 2 a segment that crosses the split boundary
    at 640, rows 3-4 the rest."""
    B, Lq, Lk, Hq = 2, 5, 4100, 4
    _, n_split, _ = block_attn_plan(B, Lq, Lk, Hq, Hkv)
    assert n_split > 2
    q, k, v = _inputs(B, Lq, Lk, Hq, Hkv)
    seg_kv = np.zeros((B, Lk), np.int32)
    seg_kv[:, :100] = 1
    seg_kv[:, 600:700] = 2
    seg_q = np.tile(np.array([1, 9, 2, 0, 0], np.int32), (B, 1))
    kw = dict(seg_q=seg_q, seg_kv=seg_kv)
    got = block_attn_split_plain(t(q), t(k), t(v), **{a: t(b) for a, b in kw.items()})
    want = _block_attn_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                           **{a: jnp.asarray(b) for a, b in kw.items()})
    _check(got, want)
    o, l, m = got
    assert (n(l)[:, :, 1] == 0).all() and np.isneginf(n(m)[:, :, 1]).all()
    assert (n(o)[:, 1] == 0).all() and np.isfinite(n(o)).all()
    # unmasked, and through the valid masks, against the unsplit plain version
    for kw in ({}, dict(valid_kv=t(np.arange(Lk) % 7 != 3),
                        valid_q=t(np.arange(Lq) % 5 != 1))):
        _check(block_attn_split_plain(t(q), t(k), t(v), **kw),
               block_attn_lse_plain(t(q), t(k), t(v), **kw))


def test_merge_of_two_parts_is_the_whole_block():
    """Two parts, as the continuation merges its prefix and suffix parts
    (models/prefix_cache.py:attention_suffix), row 0 seeing keys in the
    first part only, merge to the plain version over all keys."""
    q, k, v = _inputs(1, 6, 300, 4, 2, seed=3)
    seg_kv = np.zeros((1, 300), np.int32)
    seg_kv[:, :150] = 1  # row 0 sees only the first part's keys
    seg_q = np.array([[1, 0, 0, 0, 0, 0]], np.int32)
    parts = [block_attn_lse_plain(t(q), t(k[:, a:e]), t(v[:, a:e]), seg_q=t(seg_q),
                                  seg_kv=t(seg_kv[:, a:e])) for a, e in ((0, 128), (128, 300))]
    _check(merge_parts(parts),
           block_attn_lse_plain(t(q), t(k), t(v), seg_q=t(seg_q), seg_kv=t(seg_kv)))
