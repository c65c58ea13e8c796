"""ToMe's merge decisions in the port against the JAX package at SigLIP's
frame shape (729 tokens of 1152), on seeded features and on the same
features moved by one bf16 ulp.

A merge round is run in each package by its own `_bipartite_merge_round`,
twice: on the features (what `tome_merge` does), and on a membership matrix
(token i of the frame is row i of the identity) with the same metric and
unit sizes, which carries which input tokens each output token holds. The
two packages must give the same final memberships, in the same output
order, on both inputs, and on Gaussian features group the same tokens in
every round. The features
come in two kinds: independent Gaussian rows, and rows that share one large
common component, as a random-weight tower's outputs do, where the sources'
best scores crowd into 1e-3 and some tie exactly. The two packages' f32
scores differ by up to ~5e-7 (their reductions round differently), so the
first round may group a tying source differently; the final output stays
the same.

What one bf16 ulp does: it changes the membership of 32 of the 32 output
tokens of the two frames on Gaussian features and 19 of 32 on the crowded
ones, in both packages alike. ToMe re-decides under one ulp of its input,
and so does the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rng

from timeviper_tpu.ops import tome as jax_tome
from timeviper_tpu_torch.ops import tome as torch_tome

T, C, HEADS, TARGET, FRAMES = 729, 1152, 16, 16, 2


def _features(kind: str, seed: int) -> np.ndarray:
    r = rng(seed)
    x = r.standard_normal((FRAMES, T, C)).astype(np.float32)
    if kind == "common":
        x = 8.0 * r.standard_normal((1, 1, C)).astype(np.float32) + 0.5 * x
    return x


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()


def _from_bits(bits: np.ndarray) -> np.ndarray:
    return torch.from_numpy(bits).view(torch.bfloat16).float().numpy()


def _one_ulp(x: np.ndarray, seed: int) -> np.ndarray:
    """x rounded to bf16, every element moved one bf16 ulp up or down."""
    bits = _bf16_bits(x).astype(np.int32)
    step = rng(seed).choice(np.array([-1, 1], np.int32), size=bits.shape)
    return _from_bits((bits + step).astype(np.int16))


@jax.jit
def _jax_rounds(xf):
    B = xf.shape[0]
    size = jnp.ones((B, T, 1), jnp.float32)
    memb = jnp.broadcast_to(jnp.eye(T, dtype=jnp.float32), (B, T, T))
    out = []
    for r in jax_tome.merge_schedule(T, TARGET):
        p = xf.shape[1]
        metric = xf.reshape(B, p, HEADS, C // HEADS).mean(axis=2)
        xw, size_new = jax_tome._bipartite_merge_round(xf, size, metric, r)
        memb, _ = jax_tome._bipartite_merge_round(memb, jnp.ones_like(size), metric, r)
        size = size_new
        xf = xw / size
        out.append(memb)
    return out, xf


def _jax_merges(x: np.ndarray):
    """Memberships after each round, and the merged features, as the JAX
    tome_merge runs its rounds (jitted, as the JAX encode runs it)."""
    out, xf = _jax_rounds(jnp.asarray(x))
    return [np.asarray(m) for m in out], np.asarray(xf)


def _torch_merges(x: np.ndarray):
    """The same through the port's round function (which takes size-weighted
    values)."""
    xf = torch.from_numpy(x)
    B = x.shape[0]
    size = torch.ones(B, T, 1)
    memb = torch.eye(T).expand(B, T, T).contiguous()
    out = []
    for r in torch_tome.merge_schedule(T, TARGET):
        p = xf.shape[1]
        metric = xf.reshape(B, p, HEADS, C // HEADS).mean(dim=2)
        xw, size_new = torch_tome._bipartite_merge_round(xf * size, size, metric, r)
        memb, _ = torch_tome._bipartite_merge_round(memb, torch.ones_like(size), metric, r)
        size = size_new
        xf = xw / size
        out.append(memb.numpy())
    return out, xf.numpy()


def _groups(memb: np.ndarray):
    """Per frame, the set of input-token groups a round's outputs hold."""
    return [sorted(tuple(np.flatnonzero(row)) for row in frame) for frame in memb]


@pytest.fixture(scope="module")
def merges():
    cases = {}
    for kind in ("gaussian", "common"):
        clean = _from_bits(_bf16_bits(_features(kind, 0)))
        for name, x in (("clean", clean), ("one ulp", _one_ulp(clean, 1))):
            cases[kind, name] = (_jax_merges(x), _torch_merges(x), x)
    return cases


@pytest.mark.parametrize("kind", ["gaussian", "common"])
@pytest.mark.parametrize("name", ["clean", "one ulp"])
def test_port_tome_merges_as_jax_does(merges, kind, name):
    (jm, jx), (tm, tx), x = merges[kind, name]
    assert len(jm) == len(tm) == len(torch_tome.merge_schedule(T, TARGET))
    if kind == "gaussian":
        for i, (a, b) in enumerate(zip(jm, tm)):
            assert _groups(a) == _groups(b), f"round {i}"
    np.testing.assert_array_equal(jm[-1], tm[-1])
    # the rounds above are tome_merge's own, in each package
    np.testing.assert_array_equal(
        jx, np.asarray(jax.jit(jax_tome.tome_merge, static_argnums=1)(jnp.asarray(x), TARGET)))
    np.testing.assert_array_equal(torch_tome.tome_merge(torch.from_numpy(x), TARGET).numpy(), tx)
    np.testing.assert_allclose(tx, jx, rtol=1e-5, atol=1e-5)


def moved_tokens(merges, kind):
    """Output tokens whose membership one bf16 ulp of input noise changes,
    per package: {package: (moved, total)}."""
    res = {}
    for pkg in (0, 1):
        a = merges[kind, "clean"][pkg][0][-1]
        b = merges[kind, "one ulp"][pkg][0][-1]
        res[pkg] = (int((a != b).any(-1).sum()), a.shape[0] * a.shape[1])
    return res


@pytest.mark.parametrize("kind", ["gaussian", "common"])
def test_one_ulp_moves_the_same_tokens_in_both_packages(merges, kind):
    moved = moved_tokens(merges, kind)
    assert moved[0] == moved[1]
    assert moved[0][0] > 0
