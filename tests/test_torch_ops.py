"""Plain ops of the PyTorch port against their JAX counterparts, on the CPU:
norms, causal conv, the plain SSD scan and decode step, attention masks,
ToMe and sampling. Inputs come from numpy with a seed; both sides compute in
float32, so the JAX tests' own tolerances apply."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, packed_seq, rng, t

from timeviper_tpu.ops import attention as j_attn
from timeviper_tpu.ops import conv as j_conv
from timeviper_tpu.ops import norms as j_norms
from timeviper_tpu.ops import ssd as j_ssd
from timeviper_tpu.ops import tome as j_tome
from timeviper_tpu_torch.ops import attention as t_attn
from timeviper_tpu_torch.ops import conv as t_conv
from timeviper_tpu_torch.ops import norms as t_norms
from timeviper_tpu_torch.ops import ssd as t_ssd
from timeviper_tpu_torch.ops import tome as t_tome
from timeviper_tpu_torch.ops.sampling import SamplingParams, sample_token

TOL = dict(rtol=1e-5, atol=1e-5)  # f32 elementwise chains (tests/test_ops_conv_norms.py)


def test_rms_norm_matches_jax():
    r = rng(0)
    x, w = r.standard_normal((3, 5, 64), np.float32), r.standard_normal(64, np.float32)
    np.testing.assert_allclose(n(t_norms.rms_norm(t(x), t(w), 1e-5)),
                               n(j_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)), **TOL)


@pytest.mark.parametrize("group_size", [16, 64])
def test_gated_rms_norm_matches_jax(group_size):
    r = rng(1)
    x, z = r.standard_normal((2, 7, 64), np.float32), r.standard_normal((2, 7, 64), np.float32)
    w = r.standard_normal(64, np.float32)
    got = t_norms.gated_rms_norm(t(x), t(z), t(w), 1e-5, group_size)
    want = j_norms.gated_rms_norm(jnp.asarray(x), jnp.asarray(z), jnp.asarray(w), 1e-5,
                                  group_size, impl="reshape")
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_bf16_norms_round_once():
    """bf16: the port rounds once, the JAX package twice; one bf16 ulp apart."""
    r = rng(2)
    x = r.standard_normal((4, 64), np.float32)
    w = r.standard_normal(64, np.float32)
    got = t_norms.rms_norm(t(x).bfloat16(), t(w))
    exact = t_norms.rms_norm(t(x).bfloat16().float(), t(w))
    np.testing.assert_allclose(n(got), n(exact), rtol=2 ** -8, atol=1e-6)
    want = j_norms.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w))
    np.testing.assert_allclose(n(got), n(want.astype(jnp.float32)), rtol=2 ** -6, atol=2e-2)


@pytest.mark.parametrize("packed", [False, True])
def test_causal_conv1d_matches_jax(packed):
    r = rng(3)
    B, L, C, K = 2, 19, 12, 4
    x = r.standard_normal((B, L, C), np.float32)
    w, b = r.standard_normal((C, K), np.float32), r.standard_normal(C, np.float32)
    seq = packed_seq(B, L, 3, 10) if packed else None
    got = t_conv.causal_conv1d(t(x), t(w), t(b), "silu", None if seq is None else t(seq))
    want = j_conv.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), "silu",
                                None if seq is None else jnp.asarray(seq))
    np.testing.assert_allclose(n(got), n(want), **TOL)


@pytest.mark.parametrize("L", [2, 9])
def test_conv_state_and_update_match_jax(L):
    r = rng(4)
    B, C, K = 2, 6, 4
    x = r.standard_normal((B, L, C), np.float32)
    st_t, st_j = t_conv.init_conv_state(t(x), K), j_conv.init_conv_state(jnp.asarray(x), K)
    np.testing.assert_array_equal(n(st_t), n(st_j))
    new = r.standard_normal((B, C), np.float32)
    w, b = r.standard_normal((C, K), np.float32), r.standard_normal(C, np.float32)
    yt, st2_t = t_conv.causal_conv1d_update(t(new), st_t, t(w), t(b))
    yj, st2_j = j_conv.causal_conv1d_update(jnp.asarray(new), st_j, jnp.asarray(w),
                                            jnp.asarray(b))
    np.testing.assert_allclose(n(yt), n(yj), **TOL)
    np.testing.assert_array_equal(n(st2_t), n(st2_j))


def _ssd_inputs(seed, B=2, L=40, H=8, P=16, G=2, N=32):
    r = rng(seed)
    return dict(
        x=r.standard_normal((B, L, H, P), np.float32),
        dt=r.standard_normal((B, L, H), np.float32) * 0.5,
        A=-np.exp(r.standard_normal(H).astype(np.float32)),
        B_=r.standard_normal((B, L, G, N), np.float32),
        C=r.standard_normal((B, L, G, N), np.float32),
        D=r.standard_normal(H).astype(np.float32),
        dt_bias=(r.standard_normal(H) * 0.1).astype(np.float32),
    )


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked_matches_jax(packed, with_init):
    """The plain scan (sequential chunk walk) against the JAX chunked scan
    (associative scan); tolerance of tests/test_ops_ssd_pallas.py."""
    a = _ssd_inputs(5)
    kw = dict(chunk_size=16, dt_limit=(0.0, float("inf")))
    if packed:
        kw["seq_idx"] = packed_seq(2, 40, 5, 23)
    if with_init:
        kw["initial_state"] = rng(6).standard_normal((2, 8, 16, 32), np.float32)
    yt, st = t_ssd.ssd_chunked(**{k: t(v) if isinstance(v, np.ndarray) else v
                                  for k, v in {**a, **kw}.items()})
    arrays = {k: jnp.asarray(v) for k, v in {**a, **kw}.items() if isinstance(v, np.ndarray)}
    yj, sj = jax.jit(functools.partial(j_ssd.ssd_chunked, chunk_size=16))(**arrays)
    np.testing.assert_allclose(n(yt), n(yj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(n(st), n(sj), rtol=1e-4, atol=1e-4)


def test_ssd_dt_limit_and_update_step_match_jax():
    r = rng(7)
    B, H, P, G, N = 2, 8, 4, 2, 6
    state = r.standard_normal((B, H, P, N), np.float32)
    x, dt = r.standard_normal((B, H, P), np.float32), r.standard_normal((B, H), np.float32)
    A = -np.exp(r.standard_normal(H).astype(np.float32))
    Bm, Cm = r.standard_normal((B, G, N), np.float32), r.standard_normal((B, G, N), np.float32)
    D, dtb = r.standard_normal(H).astype(np.float32), r.standard_normal(H).astype(np.float32)
    lim = (0.05, 0.8)
    yt, st = t_ssd.ssd_update_step(t(state), t(x), t(dt), t(A), t(Bm), t(Cm), t(D), t(dtb), lim)
    yj, sj = j_ssd.ssd_update_step(*(jnp.asarray(v) for v in (state, x, dt, A, Bm, Cm, D, dtb)),
                                   True, lim)
    np.testing.assert_allclose(n(yt), n(yj), **TOL)
    np.testing.assert_allclose(n(st), n(sj), **TOL)
    np.testing.assert_allclose(n(t_ssd._process_dt(t(dt), t(dtb), lim)),
                               n(j_ssd._process_dt(jnp.asarray(dt), jnp.asarray(dtb), True, lim)),
                               **TOL)


def test_attention_mask_and_gqa_match_jax():
    r = rng(8)
    B, L, Hq, Hkv, D = 2, 11, 4, 2, 8
    q = r.standard_normal((B, L, Hq, D), np.float32)
    k, v = r.standard_normal((B, L, Hkv, D), np.float32), r.standard_normal((B, L, Hkv, D), np.float32)
    seg = packed_seq(B, L, 2, 6)
    mt = t_attn.make_attention_mask(L, L, causal=True, q_segment_ids=t(seg),
                                    kv_segment_ids=t(seg))
    mj = j_attn.make_attention_mask(L, L, causal=True, q_segment_ids=jnp.asarray(seg),
                                    kv_segment_ids=jnp.asarray(seg))
    np.testing.assert_array_equal(n(mt), n(mj))
    got = t_attn.attention(t(q), t(k), t(v), mt)
    want = j_attn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mj)
    np.testing.assert_allclose(n(got), n(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("T,target", [(9, 2), (16, 16), (27, 4), (729, 16)])
def test_merge_schedule_matches_jax(T, target):
    assert t_tome.merge_schedule(T, target) == j_tome.merge_schedule(T, target)


@pytest.mark.parametrize("token_order", ["raw", "descending"])
def test_tome_merge_matches_jax(token_order):
    """Random f32 tokens: cosine scores are separated far beyond f32 rounding,
    so no merge flips at a near-tie."""
    x = rng(9).standard_normal((3, 37, 32), np.float32)
    got = t_tome.tome_merge(t(x), 5, num_attention_heads=4, token_order=token_order)
    merge = jax.jit(j_tome.tome_merge, static_argnums=(1, 2, 3))
    want = merge(jnp.asarray(x), 5, 4, token_order)
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_sampling_greedy_and_seeded_temperature():
    logits = torch.from_numpy(rng(10).standard_normal((2, 50), np.float32))
    assert sample_token(logits, None).tolist() == logits.argmax(-1).tolist()
    p = SamplingParams(temperature=0.7)
    draw = [sample_token(logits, torch.Generator().manual_seed(3), p).tolist() for _ in range(2)]
    assert draw[0] == draw[1]  # the explicit generator makes it reproducible
