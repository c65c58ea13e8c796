"""models/prefix_cache.py against the JAX package's, on the tiny 6-layer
config of tests/test_prefix_cache.py (`M-M*M-`, chunk 16), f32, batch 2.

* `nano_forward_continue` on a left-padded prefix cache made by the JAX
  prefill, with an 11-token suffix: the port runs the real rows only; JAX
  gets the suffix padded to a 16-row bucket (its trailing pads are inert)
  and unpadded. The last real row's logits and the whole updated cache
  (Mamba conv windows and SSM states, the K/V rows written so far, length,
  valid_from) agree to 1e-4 of the largest magnitude, the band the JAX
  test allows its own continuation. Two questions leave the input cache
  bitwise as it was.
* `attention_suffix` (two K9 blocks merged by their row statistics) against
  both JAX branches, the online-softmax scan and `_attention_suffix_flash`
  called directly, with a filled and an empty prefix: 1e-5 (dense f32 on
  both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, rng, t

from timeviper_tpu.config import NanoConfig
from timeviper_tpu.models import nano as jax_nano
from timeviper_tpu.models import prefix_cache as jax_pc
from timeviper_tpu_torch.models.nano import NanoModel
from timeviper_tpu_torch.models.prefix_cache import attention_suffix, nano_forward_continue
from timeviper_tpu_torch.params import nano_state_dict

CFG = NanoConfig(vocab_size=256, hidden_size=32, intermediate_size=64, num_hidden_layers=6,
                 hybrid_override_pattern="M-M*M-", num_attention_heads=2, head_dim=16,
                 num_key_value_heads=1, ssm_state_size=16, mamba_num_heads=4, mamba_n_groups=2,
                 mamba_head_dim=8, chunk_size=16)


def _close(got, want, tol, what):
    got, want = n(got), n(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err < tol, (what, err)


def _to_port(cache):
    """A JAX cache pytree -> the port's layout (tensors, host integers)."""
    layers = [{k: ({kk: t(vv) for kk, vv in v.items()} if isinstance(v, dict) else t(v))
               for k, v in lc.items()} for lc in cache["layers"]]
    return {"layers": layers, "length": int(cache["length"]),
            "valid_from": int(cache["valid_from"])}


def _flat(cache):
    """(name, tensor) of every state in the cache, in name order (a JAX
    pytree from jit has its dict keys sorted)."""
    for i, lc in enumerate(cache["layers"]):
        for k, v in sorted(lc.items()):
            for kk, vv in (sorted(v.items()) if isinstance(v, dict) else [("", v)]):
                yield f"layer {i} {k} {kk}", vv


B, P, PAD, S, M = 2, 40, 5, 11, 80


@pytest.fixture(scope="module")
def prefix():
    """JAX weights and the port's copy; a left-padded prefix cache from the
    JAX prefill; the suffix embeddings."""
    params = jax.jit(jax_nano.init_nano_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), CFG, jnp.float32)
    model = NanoModel(CFG, torch.float32)
    model.load_state_dict(nano_state_dict(params, CFG))
    r = rng(0)
    embeds = r.standard_normal((B, P, CFG.hidden_size), np.float32)
    suffix = r.standard_normal((B, S, CFG.hidden_size), np.float32)
    seq = np.where(np.arange(P) < PAD, -1, 0)[None].repeat(B, 0).astype(np.int32)
    fill = jax.jit(lambda p, e, s: jax_nano.nano_forward(
        p, CFG, inputs_embeds=e, seq_idx=s, fill_cache=True, cache_max_len=M,
        valid_from=PAD)["cache"])
    return params, model, fill(params, jnp.asarray(embeds), jnp.asarray(seq)), suffix


def test_continuation_matches_jax(prefix):
    params, model, pre, suffix = prefix
    cache = _to_port(pre)
    before = [v.clone() for _, v in _flat(cache)]
    got_logits, got = nano_forward_continue(model, CFG, t(suffix), cache)
    for bucket in (S, 16):  # JAX's suffix unpadded, then padded to its bucket
        want_logits, want = jax.jit(jax_pc.nano_forward_continue, static_argnums=(1,))(
            params, CFG, jnp.asarray(np.pad(suffix, ((0, 0), (0, bucket - S), (0, 0)))), pre,
            jnp.asarray(S, jnp.int32))
        _close(got_logits, want_logits, 1e-4, "last logits")
        assert got["length"] == int(want["length"]) == P + S
        assert got["valid_from"] == int(want["valid_from"]) == PAD
        for (name, g), (_, w) in zip(_flat(got), _flat(want)):
            if name.split()[2] in ("k", "v"):  # the rows written so far
                g, w = g[:, :P + S], w[:, :P + S]
            _close(g, w, 1e-4, f"{name}, JAX bucket {bucket}")

    # a second question on the same prefix, then the first again
    other, _ = nano_forward_continue(model, CFG, t(suffix[:, ::-1].copy()), cache)
    again, _ = nano_forward_continue(model, CFG, t(suffix), cache)
    assert not torch.equal(other, got_logits) and torch.equal(again, got_logits)
    assert all(torch.equal(b, a) for b, (_, a) in zip(before, _flat(cache)))


@pytest.mark.parametrize("length,valid_from", [(37, 5), (5, 5)])
def test_attention_suffix_matches_both_jax_branches(length, valid_from):
    B, S, M, Hq, Hkv, hd = 2, 9, 64, 4, 2, 16
    r = rng(1)
    q = r.standard_normal((B, S, Hq, hd), np.float32)
    k, v = (r.standard_normal((B, M, Hkv, hd), np.float32) for _ in range(2))
    got = n(attention_suffix(t(q), t(k), t(v), length, valid_from))
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    jl, jvf = jnp.asarray(length, jnp.int32), jnp.asarray(valid_from, jnp.int32)
    scan = jax.jit(jax_pc.attention_suffix, static_argnames="kv_chunk")(
        jq, jk, jv, jl, jvf, kv_chunk=16)
    flash = jax.jit(jax_pc._attention_suffix_flash, static_argnums=(5, 6))(
        jq, jk, jv, jl, jvf, None, hd ** -0.5)
    np.testing.assert_allclose(got, n(scan), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, n(flash), rtol=1e-5, atol=1e-5)
