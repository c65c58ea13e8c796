"""K9's plain version (ops/block_attention.py:block_attn_lse_plain, reached
through block_attn_lse on a CPU tensor) against the JAX package's
parallel/seq_parallel.py:_block_attn_lse, which takes its dense branch on the
CPU. Same numpy inputs, f32; both are dense f32 sums in other orders, so
o, l and m agree to 1e-5. GQA (4 query heads on 2 KV heads) throughout.

`valid_q` is folded into the segment ids as the TPU branch folds it
(seq_parallel.py:229-240), which the dense JAX branch does not read: the case
holds every row against the dense branch given those folded ids, and the
valid rows against the dense branch given `valid_kv` itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import n, rng, t

from timeviper_tpu.parallel.seq_parallel import _block_attn_lse
from timeviper_tpu_torch.ops.block_attention import block_attn_lse

TOL = dict(rtol=1e-5, atol=1e-5)
B, Hq, Hkv, D = 2, 4, 2, 16


def _qkv(Lq, Lk, seed=0):
    r = rng(seed)
    return tuple(r.standard_normal(s, np.float32)
                 for s in ((B, Lq, Hq, D), (B, Lk, Hkv, D), (B, Lk, Hkv, D)))


def _segments(L, cuts):
    return np.tile(np.searchsorted(cuts, np.arange(L), side="right").astype(np.int32), (B, 1))


def _check(got, want, rows=slice(None)):
    (o, l, m), (wo, wl, wm) = got, want
    np.testing.assert_allclose(n(o)[:, rows], n(wo)[:, rows], **TOL)
    np.testing.assert_allclose(n(l)[..., rows], n(wl)[..., rows], **TOL)
    np.testing.assert_allclose(n(m)[..., rows], n(wm)[..., rows], **TOL)


@pytest.mark.parametrize("case", ["causal", "rectangular", "segments", "valid", "masked row"])
def test_block_attention_matches_jax(case):
    causal = case == "causal"
    Lq, Lk = (24, 24) if causal else (8, 40)
    q, k, v = _qkv(Lq, Lk)
    kw = {}
    if case == "segments":
        kw = dict(seg_q=_segments(Lq, [3, 6]), seg_kv=_segments(Lk, [10, 25]))
    if case == "masked row":  # query segment 7 has no key
        seg_q = _segments(Lq, [5])
        seg_q[:, 2] = 7
        kw = dict(seg_q=seg_q, seg_kv=_segments(Lk, [30]))
    if case == "valid":
        valid_kv, valid_q = np.arange(Lk) % 7 != 3, np.arange(Lq) % 5 != 1
        got = block_attn_lse(t(q), t(k), t(v), valid_kv=t(valid_kv), valid_q=t(valid_q))
        folded = dict(seg_q=np.where(valid_q, 0, -1)[None].repeat(B, 0).astype(np.int32),
                      seg_kv=np.where(valid_kv, 0, -1)[None].repeat(B, 0).astype(np.int32))
        _check(got, _block_attn_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=False, **{a: jnp.asarray(b) for a, b in folded.items()}))
        _check(got, _block_attn_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                                    valid_kv=jnp.asarray(valid_kv)), rows=valid_q)
        return
    got = block_attn_lse(t(q), t(k), t(v), causal=causal, **{a: t(b) for a, b in kw.items()})
    want = _block_attn_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                           **{a: jnp.asarray(b) for a, b in kw.items()})
    _check(got, want)
    if case == "masked row":
        o, l, m = got
        assert (n(l)[:, :, 2] == 0).all() and np.isneginf(n(m)[:, :, 2]).all()
        assert (n(o)[:, 2] == 0).all() and np.isfinite(n(o)).all()
        # an empty block: every row sees no key
        o, l, m = block_attn_lse(t(q), t(k[:, :0]), t(v[:, :0]))
        assert (n(o) == 0).all() and (n(l) == 0).all() and np.isneginf(n(m)).all()
