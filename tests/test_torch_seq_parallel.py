"""The port's sequence-parallel pieces and backbone prefill
(timeviper_tpu_torch/parallel/seq_parallel.py) against the JAX package's, on
a 2-device `seq` mesh: JAX under shard_map on the conftest's virtual CPU
devices (jitted once per function), the port in one 2-rank gloo spawn for
the module (tests/torch_seq_ranks.py, whose ranks never import JAX) that
runs while JAX computes. f32 throughout.

* `_halo_conv` with a segment start exactly on the seam and one inside a
  span, without segments, and `_compact_conv` over a kept subset: 1e-5.
* `ssd_seq_sharded` without and with packed `seq_idx` (a start on the seam,
  one inside a span) and with a dt mask: y and the global final state to
  2e-4 of their largest magnitude (tests/test_seq_parallel_generate.py's
  cache tolerance).
* ring and gathered attention with a 5-row left pad, and with a fully
  masked block (tests/test_seq_parallel_ring.py:69): the valid rows to 2e-5
  (that file's tolerance).
* `nano_prefill_seq_parallel` on a 6-layer Nano `M-M*M-` with pdrop stages
  "uni_1_0.5-attn_3_0.25" and TransV (alpha 0.7): logits-only (the ring)
  with packed segments, `fill_cache` with a left pad longer than a span,
  and pdrop with TransV (a `kv_valid` cache), against JAX's and against the
  port's one-device `nano_forward` (pdrop: the compacting forward on the
  real rows), logits and caches to 2e-4 (test_seq_parallel_generate.py);
  two rows on a (data 2, seq 1) mesh against `nano_forward`;
  the fused conv (K5's plain version) against the one-device fused
  forward; then four `nano_decode_step`s and a 5-token prefix continuation
  on the `kv_valid` cache against JAX's to 5e-4
  (tests/test_seq_parallel_pdrop.py's decode tolerance).
"""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_seq_ranks as ranks
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from torch_parity import n, rng, t

from timeviper_tpu.config import VLMConfig, tiny_nano_config, tiny_vit_config
from timeviper_tpu.models import nano as jax_nano
from timeviper_tpu.models import prefix_cache as jax_pc
from timeviper_tpu.models import vlm as jax_vlm
from timeviper_tpu.parallel import seq_parallel as jsp
from timeviper_tpu.parallel.sharding import make_mesh as jax_mesh
from timeviper_tpu_torch import config as tcfg
from timeviper_tpu_torch.models.nano import nano_decode_step, nano_forward
from timeviper_tpu_torch.models.pdrop import make_pdrop_spec
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch
from timeviper_tpu_torch.params import from_jax_numpy

PDROP = dict(use_pdrop=True, pdrop_type="uni_1_0.5-attn_3_0.25", merge_module="CrossAttention")
ALPHA = 0.7
SEQ_SPEC = P(None, "seq")


def _close(got, want, tol, what):
    got, want = n(got), n(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err <= tol, (what, err)


def _halves(outs, key):
    """The two ranks' spans of a sharded output, joined along the row axis."""
    return torch.cat([o[key] for o in outs], dim=1)


# ---------------------------------------------------------------------------
# The pieces
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """One 2-rank spawn for the module: the ranks start up while the parent
    makes the inputs, and run the pieces and the prefill cases while the
    parent computes JAX's references."""
    folder = str(tmp_path_factory.mktemp("seq_parallel"))
    with ranks.running(ranks.pieces_and_prefill, folder) as got:
        conv, ssd, att = _piece_inputs()
        arch, jarch, params, model = _model()
        emb, cases = _cases()
        ranks.save_inputs(folder, chunk=16, **conv, **ssd, **att, arch=arch,
                          state=model.state_dict(), cases=cases)
        want_pieces = _jax_pieces(conv, ssd, att)
        want_prefill = _jax_refs(params, jarch, emb, cases)
    return (conv, ssd, att, got, want_pieces), (emb, cases, got, want_prefill)


@pytest.fixture(scope="module")
def pieces(spawned):
    return spawned[0]


@pytest.fixture(scope="module")
def prefill(spawned):
    return spawned[1]


def _piece_inputs():
    r = rng(0)
    f32 = np.float32
    # conv: B 2, L 16 over 2 spans of 8, 6 channels
    conv_x = r.standard_normal((2, 16, 6), f32)
    conv_seq = np.array([[0] * 8 + [1] * 8, [0] * 5 + [1] * 6 + [2] * 5], np.int32)
    conv_keep = r.random(16) > 0.4
    conv_keep[:2] = True
    # ssd: B 2, L 64 over spans of 32, chunks of 16
    B, L, H, Pd, G, N = 2, 64, 4, 8, 2, 16
    ssd = dict(x=r.standard_normal((B, L, H, Pd), f32), dt=r.standard_normal((B, L, H), f32),
               A=-np.exp(r.standard_normal(H).astype(f32)), B=r.standard_normal((B, L, G, N), f32),
               C=r.standard_normal((B, L, G, N), f32), D=r.standard_normal(H).astype(f32),
               dt_bias=r.standard_normal(H).astype(f32) - 1.0,
               ssd_seq=np.array([[0] * 32 + [1] * 32, [0] * 20 + [1] * 44], np.int32),
               ssd_mask=r.random((B, L)) > 0.3)
    # attention: B 1, L 32 over spans of 16
    La = 32
    att = dict(q=r.standard_normal((1, La, 4, 16), f32), k=r.standard_normal((1, La, 2, 16), f32),
               v=r.standard_normal((1, La, 2, 16), f32), valid_pad=np.arange(La) >= 5)
    dead = np.ones(La, bool)
    dead[:16] = False  # rank 0's block wholly masked
    dead[20:23] = False
    att["valid_dead"] = dead
    conv = dict(conv_x=conv_x, conv_w=r.standard_normal((6, 4), f32) * 0.5,
                conv_b=r.standard_normal(6).astype(f32) * 0.1, conv_seq=conv_seq,
                conv_keep=conv_keep)
    return conv, ssd, att


def _jax_pieces(conv, ssd, att):
    mesh = jax_mesh(data=1, seq=2)
    ccfg = SimpleNamespace(mamba_d_conv=4, mamba_hidden_act="silu")
    cp = {"weight": jnp.asarray(conv["conv_w"]), "bias": jnp.asarray(conv["conv_b"])}

    def local(cx, cseq, ckeep, x, dt, B_, C, sseq, smask, q, k, v):
        kw = dict(axis_name="seq", chunk_size=16, D=jnp.asarray(ssd["D"]),
                  dt_bias=jnp.asarray(ssd["dt_bias"]), return_final_state=True)
        A = jnp.asarray(ssd["A"])
        out = {"halo_conv": jsp._halo_conv(cx, cp, ccfg, "seq", seq_idx=cseq),
               "halo_conv_plain": jsp._halo_conv(cx, cp, ccfg, "seq"),
               "compact_conv": jsp._compact_conv(cx, cp, ccfg, "seq", ckeep)}
        out["ssd"], out["ssd_state"] = jsp.ssd_seq_sharded(x, dt, A, B_, C, **kw)
        out["ssd_seq"], out["ssd_seq_state"] = jsp.ssd_seq_sharded(x, dt, A, B_, C, seq_idx=sseq,
                                                                   **kw)
        out["ssd_masked"], out["ssd_masked_state"] = jsp.ssd_seq_sharded(x, dt, A, B_, C,
                                                                         dt_mask=smask, **kw)
        for tag in ("pad", "dead"):
            valid = jnp.asarray(att["valid_" + tag])
            out["ring_" + tag] = jsp.attention_seq_ring(q, k, v, axis_name="seq", n_shards=2,
                                                        valid_g=valid)
            out["gathered_" + tag] = jsp.attention_seq_sharded(q, k, v, axis_name="seq",
                                                               kv_valid=valid)
        return out

    out_specs = {k: (P() if k.endswith("_state") else SEQ_SPEC)
                 for k in ("halo_conv", "halo_conv_plain", "compact_conv", "ssd", "ssd_state",
                           "ssd_seq", "ssd_seq_state", "ssd_masked", "ssd_masked_state",
                           "ring_pad", "gathered_pad", "ring_dead", "gathered_dead")}
    in_specs = (SEQ_SPEC, SEQ_SPEC, P("seq")) + (SEQ_SPEC,) * 9
    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                           check_rep=False))
    return fn(conv["conv_x"], conv["conv_seq"], conv["conv_keep"], ssd["x"], ssd["dt"],
              ssd["B"], ssd["C"], ssd["ssd_seq"], ssd["ssd_mask"], att["q"], att["k"], att["v"])


def test_conv_ssd_and_attention_pieces_match_jax(pieces):
    conv, ssd, att, got, want = pieces
    for key in ("halo_conv", "halo_conv_plain"):
        _close(_halves(got, key), want[key], 1e-5, key)
    keep = conv["conv_keep"]
    _close(_halves(got, "compact_conv")[:, keep], np.asarray(want["compact_conv"])[:, keep],
           1e-5, "compact_conv")
    for key in ("ssd", "ssd_seq", "ssd_masked"):
        _close(_halves(got, key), want[key], 2e-4, key)
        for r in range(2):  # the global final state, the same on both ranks
            _close(got[r][key + "_state"], want[key + "_state"], 2e-4, key + "_state")
    for tag in ("pad", "dead"):
        valid = att["valid_" + tag]
        for key in ("ring_", "gathered_"):
            out = n(_halves(got, key + tag))[:, valid]
            assert np.isfinite(out).all()
            _close(out, np.asarray(want[key + tag])[:, valid], 2e-5, key + tag)


# ---------------------------------------------------------------------------
# The backbone's prefill
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _model():
    vlm = VLMConfig(arch_specifier="tome_mlp-2")
    jllm, tllm = tiny_nano_config(**PDROP), tcfg.tiny_nano_config(**PDROP)
    arch = VLMArch(vlm=vlm, vision=tiny_vit_config(), llm=tllm)
    jarch = jax_vlm.VLMArch(vlm=vlm, vision=arch.vision, llm=jllm, llm_family="nano")
    params = jax.jit(lambda key: jax_vlm.init_vlm_params(key, jarch, jnp.float32))(
        jax.random.PRNGKey(0))
    params["merge_modules"] = [dict(m, alpha=jnp.asarray(ALPHA, jnp.float32))
                               for m in params["merge_modules"]]
    model = TimeViperVLM(arch, torch.float32, device="cpu")
    model.load_state_dict(from_jax_numpy(params, arch))
    return arch, jarch, params, model.eval()


# the pdrop layout: 3 rows of text, 16 visual rows, 5 rows of text, after a
# left pad of 40 (the bucket of 64 rows, spans of 32)
L, PAD, VS, NV, TS = 64, 40, 3, 16, 5
CACHE_LEN = L + 12
SUFFIX = [7, 8, 9, 10, 11]
STEPS = 4


def _cases():
    r = rng(1)
    emb = r.standard_normal((1, L, 64), np.float32)
    emb[:, :PAD] = 5.0  # pad rows hold garbage that must not leak
    packed = np.array([[0] * 32 + [1] * 20 + [2] * 12], np.int32)  # a start on the seam
    return emb, {
        "ring": dict(embeds=emb, seq_idx=packed, logits_to_keep=4),
        # two rows over a (data 2, seq 1) mesh: a row a rank
        "data": dict(embeds=np.concatenate([emb, emb[:, ::-1]]), valid_from=PAD,
                     logits_to_keep=2, data_mesh=True),
        "cache": dict(embeds=emb, valid_from=PAD, fill_cache=True, cache_max_len=CACHE_LEN),
        "fused": dict(embeds=emb, valid_from=PAD, fill_cache=True, cache_max_len=CACHE_LEN,
                      fused_conv=True, chunk=128),
        "pdrop": dict(embeds=emb, valid_from=PAD, fill_cache=True, cache_max_len=CACHE_LEN,
                      use_pdrop=True, pdrop_vision_start=PAD + VS, pdrop_num_vision=NV,
                      pdrop_query_pos=L - 1, merge=True,
                      decode=dict(suffix=SUFFIX, steps=STEPS)),
    }


def _jax_prefill(params, cfg, emb, **kw):
    mesh = jax_mesh(data=1, seq=2)
    seq = kw.pop("seq_idx", None)
    fn = jax.jit(lambda p, e, s: jsp.nano_prefill_seq_parallel(
        p["llm_backbone"], cfg, e, mesh, seq_idx=s, cache_dtype=jnp.float32,
        merge_params=p["merge_modules"] if kw.get("use_pdrop") else None, **kw))
    return fn(params, emb, None if seq is None else jnp.asarray(seq))


def _jax_refs(params, jarch, emb, cases):
    """JAX's sharded prefills of the ring, cache and pdrop cases, then four
    decode steps and a prefix question on the pdrop case's kv_valid cache."""
    def kw(name, *drop):
        return {k: v for k, v in cases[name].items() if k not in ("embeds",) + drop}

    want = {"ring": _jax_prefill(params, jarch.llm, emb, **kw("ring"))}
    logits, cache = _jax_prefill(params, jarch.llm, emb, **kw("cache"))
    want["cache"] = (logits, jax.tree_util.tree_map(np.asarray, cache))
    logits, cache = _jax_prefill(params, jarch.llm, emb, **kw("pdrop", "merge", "decode"))
    want["pdrop"] = (logits, jax.tree_util.tree_map(np.asarray, cache))
    mp = params["merge_modules"]
    step = jax.jit(lambda p, tok, c: jax_nano.nano_decode_step(
        p["llm_backbone"], jarch.llm, tok, c, pdrop_params=mp))
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    jcache, steps = cache, []
    for _ in range(STEPS):
        lg, jcache = step(params, tok, jcache)
        steps.append(lg)
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
    want["pdrop_steps"] = np.stack(steps)
    cont = jax.jit(lambda p, e, c: jax_pc.nano_forward_continue(
        p["llm_backbone"], jarch.llm, e, c, jnp.asarray(len(SUFFIX), jnp.int32),
        pdrop_params=mp))
    embeds = params["llm_backbone"]["embeddings"][jnp.asarray(SUFFIX)][None]
    q, qcache = cont(params, embeds, cache)
    want["pdrop_question"] = (q, np.asarray(qcache["kv_valid"]))
    return want


def _check_cache(got, want, pad_got, pad_want, rows, what, tol=2e-4):
    """Mamba states and the K/V of `rows` real rows, a cache against another
    whose rows start at another pad."""
    for idx, (g, w) in enumerate(zip(got["layers"], want["layers"])):
        if "ssm_state" in g:
            _close(g["ssm_state"], w["ssm_state"], tol, f"{what} ssm {idx}")
            for r in "xBC":
                _close(g["conv_state"][r], w["conv_state"][r], tol, f"{what} conv {idx}")
        if "k" in g:
            for kv in "kv":
                _close(n(g[kv])[:, pad_got:pad_got + rows], n(w[kv])[:, pad_want:pad_want + rows],
                       tol, f"{what} {kv} {idx}")


def test_logits_only_ring_prefill_matches_jax_and_one_device(prefill):
    emb, cases, got, refs = prefill
    arch, jarch, params, model = _model()
    want = refs["ring"]
    with torch.no_grad():
        one = nano_forward(model.llm_backbone, arch.llm, inputs_embeds=t(emb),
                           seq_idx=t(cases["ring"]["seq_idx"]), logits_to_keep=4)["logits"]
    for r in range(2):
        _close(got[r]["ring"], want, 2e-4, "ring vs JAX")
        _close(got[r]["ring"], one, 2e-4, "ring vs nano_forward")


def test_data_axis_prefill_matches_one_device(prefill):
    """A (data 2, seq 1) mesh splits two rows over the ranks and gathers
    their logits on both."""
    emb, cases, got, _ = prefill
    arch, _, _, model = _model()
    rows = cases["data"]["embeds"]
    with torch.no_grad():
        one = nano_forward(model.llm_backbone, arch.llm, inputs_embeds=t(rows[:, PAD:].copy()),
                           logits_to_keep=2)["logits"]
    for r in range(2):
        _close(got[r]["data"], one, 2e-4, "data axis vs nano_forward")


def test_fill_cache_prefill_matches_jax_and_one_device(prefill):
    emb, cases, got, refs = prefill
    arch, jarch, params, model = _model()
    logits, jc = refs["cache"]
    with torch.no_grad():
        one = nano_forward(model.llm_backbone, arch.llm, inputs_embeds=t(emb[:, PAD:]),
                           fill_cache=True, cache_max_len=CACHE_LEN, logits_to_keep=1)
    for r in range(2):
        g_logits, g_cache = got[r]["cache"]
        assert g_cache["length"] == L and g_cache["valid_from"] == PAD
        _close(g_logits[:, -1], logits[:, -1], 2e-4, "first logits vs JAX")
        _close(g_logits[:, -1], one["logits"][:, -1], 2e-4, "first logits vs nano_forward")
        _check_cache(g_cache, jc, 0, 0, L, "vs JAX")
        _check_cache(g_cache, one["cache"], PAD, 0, L - PAD, "vs nano_forward")
    # the fused conv (K5's plain version here) against the one-device fused forward
    c128 = dataclasses.replace(arch.llm, chunk_size=128)
    with torch.no_grad():
        fused = nano_forward(model.llm_backbone, c128, inputs_embeds=t(emb[:, PAD:]),
                             fill_cache=True, cache_max_len=CACHE_LEN, logits_to_keep=1,
                             fused_conv=True)
    g_logits, g_cache = got[1]["fused"]
    _close(g_logits[:, -1], fused["logits"][:, -1], 2e-4, "fused first logits")
    _check_cache(g_cache, fused["cache"], PAD, 0, L - PAD, "fused")


def test_pdrop_transv_prefill_decode_and_question_match_jax(prefill):
    emb, cases, got, refs = prefill
    arch, jarch, params, model = _model()
    logits, jc = refs["pdrop"]
    # the port's compacting one-device pdrop forward on the real rows
    spec = make_pdrop_spec([(VS, NV, TS)], arch.llm.pdrop_stages, [L - PAD - 1])
    with torch.no_grad():
        one = nano_forward(model.llm_backbone, arch.llm, inputs_embeds=t(emb[:, PAD:]),
                           fill_cache=True, cache_max_len=CACHE_LEN, logits_to_keep=1,
                           pdrop_spec=spec, pdrop_params=model.merge_modules)
    g_logits, g_cache = got[0]["pdrop"]
    for r in range(2):
        _close(got[r]["pdrop"][0][:, -1], logits[:, -1], 2e-4, "pdrop first logits vs JAX")
    _close(g_logits[:, -1], one["logits"][:, -1], 2e-4, "pdrop first logits vs nano_forward")
    assert np.array_equal(n(g_cache["kv_valid"]), jc["kv_valid"])
    for idx, lc in enumerate(g_cache["layers"]):
        if "kv_valid" in lc:
            assert np.array_equal(n(lc["kv_valid"]), jc["layers"][idx]["kv_valid"])
        if "ssm_state" in lc:
            _close(lc["ssm_state"], jc["layers"][idx]["ssm_state"], 2e-4, f"ssm {idx}")
            _close(lc["ssm_state"], one["cache"]["layers"][idx]["ssm_state"], 2e-4,
                   f"ssm {idx} vs nano_forward")
    for si, ca in enumerate(g_cache["ca_kv"]):
        for kv in "kv":
            _close(ca[kv], jc["ca_kv"][si][kv], 2e-4, f"ca_kv {si} {kv}")

    # four decode steps and a prefix question on the kv_valid cache
    for r in range(2):
        _close(got[r]["pdrop_steps"], refs["pdrop_steps"], 5e-4, "kv_valid decode steps")
    want_q, want_q_kv_valid = refs["pdrop_question"]
    _close(got[0]["pdrop_question"], want_q, 5e-4, "kv_valid prefix question")
    assert np.array_equal(n(got[0]["pdrop_question_kv_valid"]), want_q_kv_valid)
    # the decode steps against the port's compacting cache, which
    # decodes the same tokens
    with torch.no_grad():
        c1, tok1, steps1 = one["cache"], one["logits"][:, -1].argmax(-1)[:, None], []
        for _ in range(STEPS):
            lg, c1 = nano_decode_step(model.llm_backbone, arch.llm, tok1, c1,
                                      pdrop_params=model.merge_modules)
            steps1.append(lg)
            tok1 = lg.argmax(-1)[:, None]
    _close(got[0]["pdrop_steps"], torch.stack(steps1), 5e-4, "kv_valid decode vs compacting")
