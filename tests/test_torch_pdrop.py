"""models/pdrop.py and the pdrop paths of models/nano.py against the JAX
package, on a tiny f32 Nano (`M-M*M-`, attention at layer 3; `M-*M-*` for
the decode after an attention layer that precedes the stage), weights made
by the JAX init and bridged.

* The drop counts and the config check: an "attn" stage on a layer
  that is not attention refuses up front here (ValueError), in the JAX
  package only inside the forward (KeyError).
* "uni" keep indices equal to jnp.linspace's, eager and jitted, over a
  sweep up to 163,840 visual tokens.
* "attn" ranking with tied visual rows (identical frames): the same keep
  set as jax.lax.top_k.
* One stage against both JAX branches (the static one, packed samples too,
  and the traced one), "uni" and "attn", alpha 0.7 / 1.3 so that TransV is
  no no-op, with labels and seq_idx; `merge_dropped_cached`; the merge
  modules' bridge.
* `nano_forward` with `fill_cache` (per-layer kv_len, ca_kv) and the decode
  steps after it.

Tolerance 1e-4 of the largest magnitude (tests/test_torch_prefix_cache.py's);
keep sets, labels and segment ids exactly equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, rng, t

from timeviper_tpu import config as jcfg
from timeviper_tpu.models import nano as jax_nano
from timeviper_tpu.models import pdrop as jax_pdrop
from timeviper_tpu_torch import config as tcfg
from timeviper_tpu_torch.models import pdrop
from timeviper_tpu_torch.models.nano import NanoModel, nano_decode_step, nano_forward
from timeviper_tpu_torch.params import merge_state_dict, nano_state_dict

TOL = 1e-4
ATTN_LAYER = 3  # tiny_nano_config's pattern "M-M*M-"


def _close(got, want, what, tol=TOL):
    got, want = n(got), n(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err < tol, (what, err)


def _configs(pdrop_type, **kw):
    over = dict(use_pdrop=True, pdrop_type=pdrop_type, merge_module="CrossAttention", **kw)
    return jcfg.tiny_nano_config(**over), tcfg.tiny_nano_config(**over)


@functools.lru_cache(maxsize=None)
def _init_params(base):
    return jax.jit(jax_nano.init_nano_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), base, jnp.float32)


def _models(jc, tc, alphas):
    """JAX nano params and merge list (alpha per stage) and their port
    copies. The init draws no weight for the pdrop fields, so the params
    are those of the config without them, compiled once."""
    params = _init_params(dataclasses.replace(jc, use_pdrop=False, pdrop_type=None,
                                              merge_module="no_merge"))
    merge = jax_pdrop.init_merge_modules(jax.random.PRNGKey(1), jc, jnp.float32)
    merge = [dict(m, alpha=jnp.asarray(a, jnp.float32)) for m, a in zip(merge, alphas)]
    model = NanoModel(tc, torch.float32)
    model.load_state_dict(nano_state_dict(params, jc))
    mods = pdrop.init_merge_modules(tc, torch.float32, "cpu")
    mods.load_state_dict(merge_state_dict(merge))
    return params, merge, model, mods


def test_drop_counts_and_the_attn_layer_check():
    """The DSL itself is held equal in tests/test_torch_config.py."""
    nine = dict(use_pdrop=True, pdrop_type="uni_14_0.8-attn_18_0.6",
                merge_module="CrossAttention")
    tc, jc = tcfg.NanoConfig(**nine), jcfg.NanoConfig(**nine)
    for nv in (0, 1, 64, 1024, 4096, 16384, 160000):
        assert pdrop.pdrop_drop_counts(tc, nv) == jax_pdrop.pdrop_drop_counts(jc, nv)
    assert pdrop.pdrop_drop_counts(tc, 4096) == [820, 819]  # 4,096 -> 3,276 -> 2,457
    assert tcfg.NanoConfig().pdrop_stages == ()

    # an attn stage off the attention layers: the 9B example of docs/USAGE.md
    # (attn_21) and the tiny config's layer 2
    with pytest.raises(ValueError, match="not an attention layer"):
        tcfg.NanoConfig(use_pdrop=True, pdrop_type="uni_14_0.8-attn_21_0.6")
    with pytest.raises(ValueError, match="not an attention layer"):
        tcfg.tiny_nano_config(use_pdrop=True, pdrop_type="attn_2_0.5")
    jc = jcfg.tiny_nano_config(use_pdrop=True, pdrop_type="attn_2_0.5")
    params = jax.eval_shape(lambda: jax_nano.init_nano_params(jax.random.PRNGKey(0), jc,
                                                              jnp.float32))
    spec = jax_pdrop.make_pdrop_spec([(2, 8, 4)], jc.pdrop_stages, [13])
    with pytest.raises(KeyError):
        jax.eval_shape(lambda p: jax_nano.nano_forward(
            p, jc, inputs_embeds=jnp.zeros((1, 14, jc.hidden_size)), pdrop_spec=spec), params)


def test_uni_keep_indices_equal_jnp_linspace_up_to_160k():
    """Eager at every point (where IEEE float32 division already parts from
    XLA's from 4,096 tokens on), jitted at the largest counts."""
    for cur in (1, 2, 17, 729, 4096, 7372, 16384, 65536, 160000, 163840):
        for ratio in (1.0, 0.8, 0.6, 0.48, 0.25):
            keep = min(int(cur * ratio), cur)
            want = np.asarray(jnp.asarray(jnp.linspace(0, cur - 1, keep), jnp.int32))
            got = pdrop.uni_keep_indices(cur, keep)
            np.testing.assert_array_equal(got, want, err_msg=f"{cur} x {ratio}")
            if cur >= 160000 and ratio in (0.8, 0.6):
                jit = np.asarray(jax.jit(
                    lambda: jnp.asarray(jnp.linspace(0, cur - 1, keep), jnp.int32))())
                np.testing.assert_array_equal(got, jit, err_msg=f"{cur} x {ratio} (jit)")
    # the 9B stages at 256 frames: 4,096 -> 3,276 kept (uni)
    assert len(pdrop.uni_keep_indices(4096, int(4096 * 0.8))) == 3276


def test_attn_ranking_with_tied_rows_keeps_the_lower_index():
    jc, tc = _configs(f"attn_{ATTN_LAYER}_0.5")
    params, merge, model, mods = _models(jc, tc, [0.7])
    r = rng(3)
    vs, nv, ts = 3, 12, 5
    L = vs + nv + ts
    h = r.standard_normal((1, L, jc.hidden_size)).astype(np.float32)
    # four frames of three tokens, frames 1 and 3 copies of frame 0: tied scores
    for f in (1, 3):
        h[0, vs + 3 * f:vs + 3 * f + 3] = h[0, vs:vs + 3]
    spec_j = jax_pdrop.make_pdrop_spec([(vs, nv, ts)], jc.pdrop_stages, [L - 1])
    spec_t = pdrop.make_pdrop_spec([(vs, nv, ts)], tc.pdrop_stages, [L - 1])
    mixer = params["layers"][ATTN_LAYER]["mixer"]
    scores = jax_pdrop._rank_scores_attn(jnp.asarray(h[0]), mixer, jc, L - 1, vs, nv)
    want = np.sort(np.asarray(jax.lax.top_k(scores, 6)[1]))
    got = pdrop._keep_indices(tc.pdrop_stages[0], spec_t.samples[0], t(h[0]), None, 6,
                              cfg=tc, attn_mixer=model.layers[ATTN_LAYER].mixer)
    assert len(set(np.asarray(scores).round(6).tolist())) < nv  # the ties are there
    np.testing.assert_array_equal(got.numpy(), want)
    _close(pdrop._rank_scores_attn(t(h[0]), model.layers[ATTN_LAYER].mixer, tc, L - 1, vs, nv),
           scores, "scores")
    hj = jax_pdrop.apply_pdrop_stage(jnp.asarray(h), None, None, spec_j, jc.pdrop_stages[0], 0,
                                     cfg=jc, attn_params=mixer, merge_params=merge)[0]
    ht = pdrop.apply_pdrop_stage(t(h), None, None, spec_t, tc.pdrop_stages[0], 0, cfg=tc,
                                 attn_mixer=model.layers[ATTN_LAYER].mixer, merge=mods)[0]
    _close(ht, hj, "hidden after the stage")


@pytest.mark.parametrize("ptype,alpha", [("uni_{}_0.5", 0.7), ("attn_{}_0.5", 1.3),
                                         ("attn_{}_0.25", 0.7)])
def test_stage_matches_both_jax_branches(ptype, alpha):
    jc, tc = _configs(ptype.format(ATTN_LAYER))
    params, merge, model, mods = _models(jc, tc, [alpha])
    stage_j, stage_t = jc.pdrop_stages[0], tc.pdrop_stages[0]
    mixer_j, mixer_t = params["layers"][ATTN_LAYER]["mixer"], model.layers[ATTN_LAYER].mixer
    r = rng(4)
    # one sample after a left pad of 2 (the Generator's layout), labels on the
    # last 3 rows
    vs, nv, ts = 5, 8, 4
    L = vs + nv + ts
    h = r.standard_normal((1, L, jc.hidden_size)).astype(np.float32)
    labels = np.asarray([[-100] * (L - 3) + [7, 8, 2]], np.int32)
    seq = np.asarray([[-1, -1] + [0] * (L - 2)], np.int32)
    spec_t = pdrop.make_pdrop_spec([(vs, nv, ts)], tc.pdrop_stages, [L - 1])
    got = pdrop.apply_pdrop_stage(t(h), t(labels), t(seq), spec_t, stage_t, 0, cfg=tc,
                                  attn_mixer=mixer_t, merge=mods)
    spec_s = jax_pdrop.make_pdrop_spec([(vs, nv, ts)], jc.pdrop_stages, [L - 1])
    spec_d = jax_pdrop.PdropSpec(
        samples=(jax_pdrop.PdropSampleSpec(jnp.asarray(vs, jnp.int32), nv, -1,
                                           jnp.asarray(L - 1, jnp.int32)),),
        orig_num_vision=(nv,), ratios=spec_s.ratios)
    for branch, spec in (("static", spec_s), ("traced", spec_d)):
        want = jax_pdrop.apply_pdrop_stage(
            jnp.asarray(h), jnp.asarray(labels), jnp.asarray(seq), spec, stage_j, 0, cfg=jc,
            attn_params=mixer_j, merge_params=merge, return_ca_kv=True)
        _close(got[0], want[0], f"{branch}: hidden")
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]), err_msg=branch)
        if branch == "traced":  # the static branch numbers segments by sample
            np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        assert got[3].samples[0].num_vision == want[3].samples[0].num_vision
        assert got[3].samples[0].query_pos == int(want[3].samples[0].query_pos)
        for key in ("k", "v"):
            _close(got[4][key], want[4][key], f"{branch}: ca_kv {key}")
    # the suffix changed (TransV is live), the prefix and kept rows did not
    keep = got[3].samples[0].num_vision
    assert not np.allclose(n(got[0])[0, vs + keep:], h[0, vs + nv:])

    # packed: two samples, labels from the answer spans (training query)
    layouts = [(2, 6, 5), (3, 8, 4)]
    L2 = sum(map(sum, layouts))
    h2 = r.standard_normal((1, L2, jc.hidden_size)).astype(np.float32)
    lab2 = np.full((1, L2), -100, np.int32)
    lab2[0, 10:13] = [4, 5, 6]
    lab2[0, L2 - 2:] = [9, 2]
    seq2 = np.repeat([0, 1], [13, 15])[None].astype(np.int32)
    want = jax_pdrop.apply_pdrop_stage(
        jnp.asarray(h2), jnp.asarray(lab2), jnp.asarray(seq2),
        jax_pdrop.make_pdrop_spec(layouts, jc.pdrop_stages), stage_j, 0, cfg=jc,
        attn_params=mixer_j, merge_params=merge)
    got = pdrop.apply_pdrop_stage(t(h2), t(lab2), t(seq2),
                                  pdrop.make_pdrop_spec(layouts, tc.pdrop_stages), stage_t, 0,
                                  cfg=tc, attn_mixer=mixer_t, merge=mods)
    _close(got[0], want[0], "packed: hidden")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert [s.num_vision for s in got[3].samples] == [s.num_vision for s in want[3].samples]


def test_merge_dropped_cached_and_the_bridge():
    jc, tc = _configs(f"uni_1_0.5-attn_{ATTN_LAYER}_0.25")
    params, merge, model, mods = _models(jc, tc, [0.7, 1.3])
    assert set(mods.state_dict()) == {
        f"{i}.{leaf}" for i in (0, 1) for leaf in
        ["alpha"] + [f"cross_attn.{p}_proj.weight" for p in "qkvo"]}
    for i in (0, 1):
        got = mods.stage(i).cross_attn.q_proj.weight
        np.testing.assert_array_equal(got.detach().numpy(),
                                      np.asarray(merge[i]["cross_attn"]["q_proj"]["kernel"]).T)
        assert mods.stage(i).alpha.dtype == torch.float32
    r = rng(5)
    hid = r.standard_normal((2, 3, jc.hidden_size)).astype(np.float32)
    Hkv, hd = jc.num_key_value_heads, jc.head_dim
    kv = {k: r.standard_normal((7, Hkv, hd)).astype(np.float32) for k in "kv"}
    want = jax_pdrop.merge_dropped_cached(jnp.asarray(hid), {k: jnp.asarray(v) for k, v in
                                                             kv.items()}, merge[1], jc)
    got = pdrop.merge_dropped_cached(t(hid), {k: t(v) for k, v in kv.items()}, mods.stage(1), tc)
    _close(got, want, "shared ca_kv, B 2")
    # one ca_kv per row (the engine's slots), a zero row exactly inert
    per_row = {k: np.stack([v, np.zeros_like(v)]) for k, v in kv.items()}
    got = pdrop.merge_dropped_cached(t(hid), {k: t(v) for k, v in per_row.items()},
                                     mods.stage(1), tc)
    _close(got[:1], want[:1], "per-row ca_kv")
    np.testing.assert_array_equal(got[1].detach().numpy(), hid[1])


def _jax_fill(params, cfg, emb, spec, merge, M):
    return jax.jit(lambda p, e, mg: jax_nano.nano_forward(
        p, cfg, inputs_embeds=e, pdrop_spec=spec, pdrop_params=mg, fill_cache=True,
        cache_max_len=M, logits_to_keep=1))(params, jnp.asarray(emb), merge)


def test_nano_forward_fill_cache_and_decode():
    """Two stages (uni before the attention layer, attn at it), TransV on
    both: logits, every cache entry, kv_len and ca_kv, then three decode
    steps with the merge modules."""
    jc, tc = _configs(f"uni_1_0.5-attn_{ATTN_LAYER}_0.25")
    params, merge, model, mods = _models(jc, tc, [0.7, 1.3])
    vs, nv, ts, M = 4, 16, 6, 40
    L = vs + nv + ts
    emb = rng(6).standard_normal((1, L, jc.hidden_size)).astype(np.float32)
    spec_j = jax_pdrop.make_pdrop_spec([(vs, nv, ts)], jc.pdrop_stages, [L - 1])
    want = _jax_fill(params, jc, emb, spec_j, merge, M)
    got = nano_forward(model, tc, inputs_embeds=t(emb), fill_cache=True, cache_max_len=M,
                       logits_to_keep=1, pdrop_spec=pdrop.make_pdrop_spec(
                           [(vs, nv, ts)], tc.pdrop_stages, [L - 1]), pdrop_params=mods)
    _close(got["logits"], want["logits"], "logits")
    gc, wc = got["cache"], want["cache"]
    assert gc["length"] == int(wc["length"]) == vs + 4 + ts
    assert gc["layers"][ATTN_LAYER]["kv_len"] == int(wc["layers"][ATTN_LAYER]["kv_len"])
    for i, (gl, wl) in enumerate(zip(gc["layers"], wc["layers"])):
        for key in ("k", "v", "ssm_state"):
            if key in gl:
                _close(gl[key], wl[key], f"layer {i} {key}")
    for si in (0, 1):
        for key in ("k", "v"):
            _close(gc["ca_kv"][si][key], wc["ca_kv"][si][key], f"ca_kv {si} {key}")
    step = jax.jit(lambda p, tok, c, mg: jax_nano.nano_decode_step(p, jc, tok, c,
                                                                   pdrop_params=mg))
    for tok in (7, 11, 13):
        wl, wc = step(params, jnp.asarray([[tok]], jnp.int32), wc, merge)
        gl, gc = nano_decode_step(model, tc, torch.tensor([[tok]]), gc, pdrop_params=mods)
        _close(gl, wl, f"decode logits after {tok}")
    assert gc["layers"][ATTN_LAYER]["kv_len"] == int(wc["layers"][ATTN_LAYER]["kv_len"])


def test_decode_after_an_attention_layer_before_the_stage():
    """`M-*M-*`, stage at layer 4: layer 2's cache holds the pre-drop rows
    and writes at its own kv_len (JAX tests/test_pdrop.py:413); the port's
    decode against JAX's, and both against teacher forcing, with (B,)
    lengths as the engine gives them."""
    kw = dict(num_hidden_layers=6, hybrid_override_pattern="M-*M-*")
    jc, tc = _configs("uni_4_0.5", **kw)
    params, merge, model, mods = _models(jc, tc, [0.7])
    L0, NV, VS = 24, 8, 4
    emb = rng(7).standard_normal((1, L0, jc.hidden_size)).astype(np.float32)
    spec_j = jax_pdrop.make_pdrop_spec([(VS, NV, L0 - VS - NV)], jc.pdrop_stages, [L0 - 1])
    wc = _jax_fill(params, jc, emb, spec_j, merge, 40)["cache"]
    gc = nano_forward(model, tc, inputs_embeds=t(emb), fill_cache=True, cache_max_len=40,
                      pdrop_spec=pdrop.make_pdrop_spec([(VS, NV, L0 - VS - NV)],
                                                       tc.pdrop_stages, [L0 - 1]),
                      pdrop_params=mods)["cache"]
    assert [gc["layers"][i]["kv_len"] for i in (2, 5)] == [L0, L0 - NV // 2]
    assert [int(wc["layers"][i]["kv_len"]) for i in (2, 5)] == [L0, L0 - NV // 2]
    rows = {i: {k: v.clone() for k, v in lc.items() if k in ("k", "v")}
            for i, lc in enumerate(gc["layers"]) if "k" in lc}
    step = jax.jit(lambda p, tok, c, mg: jax_nano.nano_decode_step(p, jc, tok, c,
                                                                   pdrop_params=mg))
    # the (B,) form of the engine, on a copy of the cache
    gb = {**gc, "length": torch.tensor([gc["length"]]), "valid_from": torch.tensor([0]),
          "layers": [dict(lc, **{k: v.clone() for k, v in lc.items() if k in ("k", "v")},
                          kv_len=torch.tensor([lc["kv_len"]])) if "kv_len" in lc else lc
                     for lc in gc["layers"]]}
    for tok in (7, 11, 13):
        wl, wc = step(params, jnp.asarray([[tok]], jnp.int32), wc, merge)
        gl, gc = nano_decode_step(model, tc, torch.tensor([[tok]]), gc, pdrop_params=mods)
        bl, gb = nano_decode_step(model, tc, torch.tensor([[tok]]), gb, pdrop_params=mods)
        _close(gl, wl, f"decode after {tok}")
        _close(bl, wl, f"decode after {tok}, per-row lengths")
    assert [gc["layers"][i]["kv_len"] for i in (2, 5)] == [L0 + 3, L0 - NV // 2 + 3]
    assert gb["layers"][2]["kv_len"].tolist() == [L0 + 3]
    # the pre-drop rows of layer 2 are still there; the new rows follow them
    np.testing.assert_array_equal(n(gc["layers"][2]["k"][:, :L0]), n(rows[2]["k"][:, :L0]))
    _close(gc["layers"][2]["k"][:, :L0 + 3], wc["layers"][2]["k"][:, :L0 + 3], "layer 2 k")


def test_the_model_owns_its_merge_modules():
    """TimeViperVLM makes TransV modules for a "CrossAttention" pdrop config
    only, as the JAX init does (vlm.py:135-137); init_vlm_params draws them
    last, so every other weight is the same config's without them, and
    alpha starts at 0."""
    from timeviper_tpu_torch.config import VLMConfig, tiny_vit_config
    from timeviper_tpu_torch.models.vlm import VLMArch, init_vlm_params

    def make(**llm):
        arch = VLMArch(vlm=VLMConfig(arch_specifier="tome_mlp-2"), vision=tiny_vit_config(),
                       llm=tcfg.tiny_nano_config(**llm))
        return init_vlm_params(arch, torch.Generator().manual_seed(0), torch.float32, "cpu")

    plain = make()
    with_merge = make(use_pdrop=True, pdrop_type=f"uni_1_0.5-attn_{ATTN_LAYER}_0.25",
                      merge_module="CrossAttention")
    no_merge = make(use_pdrop=True, pdrop_type="uni_1_0.5")
    assert plain.merge_modules is None and no_merge.merge_modules is None
    assert sorted(with_merge.merge_modules) == ["0", "1"]
    assert all(m.alpha.item() == 0.0 for m in with_merge.merge_modules.values())
    mine = with_merge.state_dict()
    for k, v in plain.state_dict().items():
        assert torch.equal(mine[k], v), k
    assert set(mine) - set(plain.state_dict()) == {
        k for k in mine if k.startswith("merge_modules.")}
