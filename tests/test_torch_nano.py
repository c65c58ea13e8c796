"""models/nano.py (Nemotron-H backbone: prefill with cache fill, then decode
steps) against the JAX package at tiny_nano_config (6 layers, `M-M*M-`,
chunk 16), f32.

Parametrised over n_groups 2 and 8 (the second is the geometry of
tests/test_reference_parity_decode.py) and over a packed row whose -1 left
pad and segment boundary fall inside chunks. Tolerance 1e-3 on logits after
six layers: the band the chunked and sequential SSD orderings leave
(.claude/skills/verify/SKILL.md); both sides here run the chunked algorithm
and agree far closer.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, packed_seq, rng, t

from timeviper_tpu.config import tiny_nano_config
from timeviper_tpu.models import nano as jax_nano
from timeviper_tpu_torch.models.nano import NanoModel, nano_decode_step, nano_forward
from timeviper_tpu_torch.params import nano_state_dict

TOL = dict(rtol=1e-3, atol=1e-3)


def _models(cfg):
    params = jax.jit(jax_nano.init_nano_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), cfg, jnp.float32)
    model = NanoModel(cfg, torch.float32)
    model.load_state_dict(nano_state_dict(params, cfg))
    return params, model


@pytest.mark.parametrize("n_groups", [2, 8])
@pytest.mark.parametrize("packed", [False, True])
def test_prefill_and_decode_match_jax(n_groups, packed):
    cfg = tiny_nano_config(mamba_n_groups=n_groups)
    params, model = _models(cfg)
    B, L, pad = 2, 40, 5
    ids = rng(0).integers(0, cfg.vocab_size, (B, L))
    seq = packed_seq(B, L, pad, 23) if packed else None
    cap = L + 4
    jfwd = jax.jit(functools.partial(jax_nano.nano_forward, cfg=cfg, fill_cache=True,
                                     cache_max_len=cap, valid_from=pad if packed else 0))
    out_j = jfwd(params, input_ids=jnp.asarray(ids),
                 seq_idx=None if seq is None else jnp.asarray(seq))
    out_t = nano_forward(model, cfg, input_ids=t(ids), seq_idx=None if seq is None else t(seq),
                         fill_cache=True, cache_max_len=cap, valid_from=pad if packed else 0)
    np.testing.assert_allclose(n(out_t["logits"]), n(out_j["logits"]), **TOL)
    cache_j, cache_t = out_j["cache"], out_t["cache"]
    for lt, lj in zip(cache_t["layers"], cache_j["layers"]):
        if "ssm_state" in lj:
            np.testing.assert_allclose(n(lt["ssm_state"]), n(lj["ssm_state"]), **TOL)
            np.testing.assert_allclose(n(lt["conv_state"]["x"]), n(lj["conv_state"]["x"]), **TOL)
        if "k" in lj:
            np.testing.assert_allclose(n(lt["k"]), n(lj["k"]), **TOL)

    jstep = jax.jit(functools.partial(jax_nano.nano_decode_step, cfg=cfg))
    tok = np.asarray(out_j["logits"])[:, -1].argmax(-1)[:, None]
    for _ in range(3):
        lj, cache_j = jstep(params, input_ids=jnp.asarray(tok), cache=cache_j)
        lt, cache_t = nano_decode_step(model, cfg, t(tok), cache_t)
        np.testing.assert_allclose(n(lt), n(lj), **TOL)
        tok = np.asarray(lj).argmax(-1)[:, None]
    assert cache_t["length"] == L + 3


def test_logits_to_keep_matches_jax():
    cfg = tiny_nano_config()
    params, model = _models(cfg)
    B, L = 2, 24
    ids = rng(1).integers(0, cfg.vocab_size, (B, L))
    out_j = jax.jit(functools.partial(jax_nano.nano_forward, cfg=cfg, logits_to_keep=2))(
        params, input_ids=jnp.asarray(ids))
    out_t = nano_forward(model, cfg, input_ids=t(ids), logits_to_keep=2)
    assert out_t["logits"].shape == (B, 2, cfg.vocab_size)
    np.testing.assert_allclose(n(out_t["logits"]), n(out_j["logits"]), **TOL)
    # a remat policy changes what the backward keeps, not the forward
    # (tests/test_torch_remat_policies.py holds the gradients)
    out_r = nano_forward(model, cfg, input_ids=t(ids), remat="dots")
    out_0 = nano_forward(model, cfg, input_ids=t(ids))
    np.testing.assert_array_equal(n(out_r["logits"]), n(out_0["logits"]))
    with pytest.raises(ValueError):  # no such policy
        nano_forward(model, cfg, input_ids=t(ids), remat="everything")
