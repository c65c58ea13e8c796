"""The Qwen2 backbone of the port (models/qwen2.py, ops/rope.py, the qwen2
registry entries and the weights bridge) against the JAX package on
tiny_qwen2_config, float32 on the CPU, inputs from a numpy seed.

Tolerances: inv_freq bitwise (the jitted JAX value, an XLA constant); cos and
sin 1e-5 absolute at positions up to 81,920 (the same float32 angles, two
libraries' cos and sin); apply_rope 1e-6; the forward's logits, hidden states
and K/V cache 1e-4 (f32 sums in other orders over 4 layers); the decode's
logits 1e-4. The JAX side is jitted and shared in a module fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, packed_seq, rng, t

from timeviper_tpu.config import tiny_qwen2_config
from timeviper_tpu.models import qwen2 as jq
from timeviper_tpu.ops import rope as jrope
from timeviper_tpu_torch.models.qwen2 import (
    Qwen2Model,
    build_positions,
    compute_logits,
    qwen2_decode_step,
    qwen2_forward,
)
from timeviper_tpu_torch.ops import rope as trope
from timeviper_tpu_torch.params import qwen2_state_dict

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    """{tied: (cfg, JAX params, port model)} for untied and tied embeddings.
    The JAX init draws every weight but lm_head from the same keys either
    way, so the tied tree is the untied one without lm_head."""
    untied = jax.jit(jq.init_qwen2_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(3), tiny_qwen2_config(), jnp.float32)
    out = {}
    for tied in (False, True):
        cfg = tiny_qwen2_config(tie_word_embeddings=tied)
        params = {k: v for k, v in untied.items() if not (tied and k == "lm_head")}
        model = Qwen2Model(cfg, torch.float32, device="cpu")
        model.load_state_dict(qwen2_state_dict(params))
        out[tied] = (cfg, params, model)
    return out


@pytest.mark.parametrize("head_dim,theta", [(128, 1e6), (16, 1e6), (128, 1e4), (72, 5e5)])
def test_inv_freq_is_bitwise_the_jitted_jax_one(head_dim, theta):
    want = np.asarray(jax.jit(jrope.rope_frequencies, static_argnums=(0, 1))(head_dim, theta))
    got = trope.rope_frequencies(head_dim, theta).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_cos_sin_up_to_81920_and_apply_rope():
    pos = np.concatenate([np.arange(0, 81921, 37), [32767, 32768, 81919, 81920]])
    pos = pos.astype(np.int32)[None]
    want_c, want_s = jax.jit(jrope.rope_cos_sin, static_argnums=(1, 2))(jnp.asarray(pos), 128,
                                                                         1e6)
    got_c, got_s = trope.rope_cos_sin(t(pos), 128, 1e6)
    np.testing.assert_allclose(n(got_c), n(want_c), rtol=0, atol=1e-5)
    np.testing.assert_allclose(n(got_s), n(want_s), rtol=0, atol=1e-5)
    x = rng(0).standard_normal((1, pos.shape[1], 2, 128)).astype(np.float32)
    want = jrope.apply_rope(jnp.asarray(x), want_c, want_s)
    np.testing.assert_allclose(n(trope.apply_rope(t(x), got_c, got_s)), n(want), rtol=0,
                               atol=1e-6)


def test_positions_restart_at_each_segment():
    seq = packed_seq(1, 10, 3, 6)
    got = build_positions(t(seq), 1, 10, "cpu")
    assert got.tolist() == [[0, 1, 2, 0, 1, 2, 0, 1, 2, 3]]
    assert build_positions(None, 2, 3, "cpu").tolist() == [[0, 1, 2]] * 2


@pytest.mark.parametrize("tied", [False, True])
def test_forward_with_a_left_pad_and_two_segments_matches_jax(models, tied):
    """B 2, L 24: row 0 a left pad of 3 and a packed boundary at 12, row 1 a
    pad of 5 and a boundary at 17; logits of every row, the hidden states and
    the filled cache."""
    cfg, params, model = models[tied]
    B, L, M = 2, 24, 32
    seq = np.concatenate([packed_seq(1, L, 3, 12), packed_seq(1, L, 5, 17)])
    emb = rng(1).standard_normal((B, L, cfg.hidden_size)).astype(np.float32)

    @jax.jit
    def ref(p, e, s):
        return jq.qwen2_forward(p, cfg, inputs_embeds=e, seq_idx=s, fill_cache=True,
                                cache_max_len=M)

    want = ref(params, jnp.asarray(emb), jnp.asarray(seq))
    with torch.no_grad():
        got = qwen2_forward(model, cfg, inputs_embeds=t(emb), seq_idx=t(seq), fill_cache=True,
                            cache_max_len=M)
    np.testing.assert_allclose(n(got["logits"]), n(want["logits"]), **TOL)
    np.testing.assert_allclose(n(got["hidden_states"]), n(want["hidden_states"]), **TOL)
    assert got["cache"]["length"] == L
    for i, (g, w) in enumerate(zip(got["cache"]["layers"], want["cache"]["layers"])):
        for key in ("k", "v"):
            np.testing.assert_allclose(n(g[key]), n(w[key]), err_msg=f"layer {i} {key}", **TOL)
    assert (model.lm_head is None) == tied


def test_decode_after_fill_cache_matches_jax(models):
    """A prefill left-padded by 5 rows (valid_from 5), then three decode
    steps: the token rotates at length - valid_from."""
    cfg, params, model = models[False]
    L, pad, M = 16, 5, 24
    ids = rng(2).integers(3, cfg.vocab_size, (1, L)).astype(np.int32)
    seq = packed_seq(1, L, pad, L)

    @jax.jit
    def prefill(p, i, s):
        return jq.qwen2_forward(p, cfg, input_ids=i, seq_idx=s, fill_cache=True,
                                cache_max_len=M, valid_from=pad)["cache"]

    @jax.jit
    def step(p, tok, c):
        return jq.qwen2_decode_step(p, cfg, tok, c)

    jcache = prefill(params, jnp.asarray(ids), jnp.asarray(seq))
    with torch.no_grad():
        tcache = qwen2_forward(model, cfg, input_ids=t(ids).long(), seq_idx=t(seq),
                               fill_cache=True, cache_max_len=M, valid_from=pad)["cache"]
        assert tcache["valid_from"] == pad
        for tok in (7, 11, 13):
            want, jcache = step(params, jnp.asarray([[tok]], jnp.int32), jcache)
            got, tcache = qwen2_decode_step(model, cfg, torch.tensor([[tok]]), tcache)
            np.testing.assert_allclose(n(got), n(want), err_msg=f"token {tok}", **TOL)
    assert tcache["length"] == int(jcache["length"]) == L + 3


def test_decode_with_one_length_per_row_matches_the_shared_length(models):
    """The engine's form: (B,) lengths and valid_from (rows of 12 and 9
    tokens, pads of 2 and 4) give, row by row, the shared-length step's
    logits and K/V."""
    cfg, _, model = models[True]
    M = 20
    rows = ((12, 2), (9, 4))  # (length, left pad)
    ids = torch.from_numpy(rng(3).integers(3, cfg.vocab_size, (1, 12)))
    with torch.no_grad():
        caches = [qwen2_forward(model, cfg, input_ids=ids[:, :L],
                                seq_idx=t(packed_seq(1, L, vf, L)), fill_cache=True,
                                cache_max_len=M, valid_from=vf)["cache"] for L, vf in rows]
        tok = torch.tensor([[9], [10]])
        want = [qwen2_decode_step(model, cfg, tok[b:b + 1], _copied(c))
                for b, c in enumerate(caches)]
        batched = {"layers": [{key: torch.cat([c["layers"][i][key] for c in caches])
                               for key in ("k", "v")} for i in range(cfg.num_hidden_layers)],
                   "length": torch.tensor([12, 9]), "valid_from": torch.tensor([2, 4])}
        got, new = qwen2_decode_step(model, cfg, tok, batched)
    for b, (L, _) in enumerate(rows):
        np.testing.assert_allclose(n(got[b]), n(want[b][0][0]), rtol=1e-5, atol=1e-5)
        for i in range(cfg.num_hidden_layers):
            np.testing.assert_allclose(n(new["layers"][i]["k"][b, :L + 1]),
                                       n(want[b][1]["layers"][i]["k"][0, :L + 1]), atol=1e-5)
    assert new["length"].tolist() == [13, 10]


def _copied(cache):
    """The cache with its K/V buffers copied (the decode writes in place)."""
    return {**cache, "layers": [{k: v.clone() for k, v in lc.items()}
                                for lc in cache["layers"]]}


@pytest.mark.parametrize("tied", [False, True])
def test_bridge_fills_every_weight(models, tied):
    """Every port weight comes from the JAX tree, the q/k/v biases too; a
    tied tree has no lm_head and the logits come from the embeddings."""
    cfg, params, model = models[tied]
    sd = qwen2_state_dict(params)
    assert set(sd) == set(model.state_dict())
    assert ("lm_head.weight" in sd) != tied
    assert {f"layers.0.self_attn.{p}_proj.bias" for p in "qkv"} <= set(sd)
    assert "layers.0.self_attn.o_proj.bias" not in sd
    for key, val in model.state_dict().items():
        np.testing.assert_array_equal(val.numpy(), sd[key].numpy(), err_msg=key)
    h = rng(4).standard_normal((3, cfg.hidden_size)).astype(np.float32)
    want = jq.compute_logits(params, jnp.asarray(h))
    np.testing.assert_allclose(n(compute_logits(model, t(h))), n(want), rtol=1e-5, atol=1e-5)


def test_qwen2_entry_points_raise_without_a_card():
    """No fallback: without a device the qwen2 model, its weights and its
    cache go to the card, and a machine without one raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from timeviper_tpu_torch.config import VLMConfig, tiny_vit_config
    from timeviper_tpu_torch.config import tiny_qwen2_config as port_tiny_qwen2
    from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch, init_cache, init_vlm_params

    arch = VLMArch(vlm=VLMConfig(arch_specifier="tome_mlp-2"), vision=tiny_vit_config(),
                   llm=port_tiny_qwen2(), llm_family="qwen2")
    for make in (lambda: TimeViperVLM(arch, torch.float32), lambda: init_cache(arch, 1, 8),
                 lambda: init_vlm_params(arch, torch.Generator().manual_seed(0))):
        with pytest.raises(RuntimeError):
            make()
    cache = init_cache(arch, 2, 8, torch.float32, device="cpu")
    assert len(cache["layers"]) == 4 and cache["layers"][3]["k"].shape == (2, 8, 2, 16)
