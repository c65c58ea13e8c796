"""The Qwen2 backbone through the port's entry points, against the JAX
package's: a tiny VLM (tiny SigLIP, `tome_mlp-2`) over tiny_qwen2_config,
JAX-initialised weights bridged with from_jax_numpy, f32 on the CPU, greedy.

* Generator.generate, text and video: the JAX Generator's tokens, and the
  first logits against its bucketed prefill.
* qwen2_forward_continue against JAX's (the setup of
  tests/test_prefix_cache.py:195: a 48-row prefix, 11 suffix rows, JAX's
  padded to 16 with non-zero pads), the K/V rows it writes and a decode step
  after it; then prefill_prefix and generate(prefix=) on a left-padded
  prefix against generate() of the whole prompt.
* pdrop and TransV (the setup of tests/test_pdrop.py:380, tanh(alpha)
  nonzero): the decode after a stage at layer 1 against a teacher-forced
  JAX pdrop forward; a stage at layer 0, where no layer holds pre-drop rows,
  against JAX's qwen2_decode_step; Generator.generate(use_pdrop=True) with
  an "attn" stage (biased q/k projections, no RoPE) against the JAX
  Generator's.
* ServingEngine (the setup of tests/test_serving.py:228): batched text
  prompts, a chunked prompt, a video request and a question on a prefix,
  each with the offline Generator's tokens; an engine too small for a
  request rejects that request; pdrop_frames is refused on qwen2.

Tolerance: 1e-4 of the largest magnitude; tokens exactly equal. The JAX
side is jitted and shared in module fixtures.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, rng, t

from timeviper_tpu.config import VLMConfig, tiny_qwen2_config, tiny_vit_config
from timeviper_tpu.models import generate as jax_gen
from timeviper_tpu.models import pdrop as jax_pdrop
from timeviper_tpu.models import prefix_cache as jax_pc
from timeviper_tpu.models import qwen2 as jq
from timeviper_tpu.models import vlm as jax_vlm
from timeviper_tpu_torch import config as tcfg
from timeviper_tpu_torch.models.generate import Generator
from timeviper_tpu_torch.models.pdrop import MergeModules, make_pdrop_spec
from timeviper_tpu_torch.models.prefix_cache import qwen2_forward_continue
from timeviper_tpu_torch.models.qwen2 import Qwen2Model, qwen2_decode_step, qwen2_forward
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch
from timeviper_tpu_torch.params import from_jax_numpy, merge_state_dict, qwen2_state_dict
from timeviper_tpu_torch.serving import Request, ServingEngine

IMG = 500
KW = dict(terminator_ids=[-2], pad_token_id=0, max_new_tokens=5)


def _close(got, want, what, tol=1e-4):
    got, want = n(got), n(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err < tol, (what, err)


def _sharpen(llm, layer: int) -> None:
    """Give layer `layer`'s q projection (JAX tree, in place) a kernel 30
    times the init's and a random bias: the "attn" ranking's softmax is then
    far from flat, so its top-k is not decided by float32 noise (with the
    init's weights every score is 1/L to 1e-7)."""
    qp = llm["layers"][layer]["self_attn"]["q_proj"]
    qp["kernel"] = qp["kernel"] * 30.0
    qp["bias"] = jnp.asarray(rng(7).standard_normal(qp["bias"].shape).astype(np.float32))


def _merge_modules(cfg, seed=1):
    """TransV modules of `cfg` in the JAX layout (init_merge_modules'),
    drawn with numpy: kernels N(0, 0.02), biases N(0, 0.02) (the init's are
    zero), alpha 0.5 (the init's 0 makes TransV a no-op)."""
    r = rng(seed)
    d, q, kv = (cfg.hidden_size, cfg.num_attention_heads * cfg.head_dim,
                cfg.num_key_value_heads * cfg.head_dim)

    def lin(din, dout):
        return {"kernel": jnp.asarray(r.normal(0, 0.02, (din, dout)), jnp.float32),
                "bias": jnp.asarray(r.normal(0, 0.02, dout), jnp.float32)}

    return [{"cross_attn": {"q_proj": lin(d, q), "k_proj": lin(d, kv), "v_proj": lin(d, kv),
                            "o_proj": lin(q, d)},
             "alpha": jnp.asarray(0.5, jnp.float32)} for _ in cfg.pdrop_stages]


def _vlm(params, **llm_kw):
    """(port arch, JAX arch, port model) over the JAX VLM tree `params`."""
    vlm = VLMConfig(arch_specifier="tome_mlp-2", llm_backbone_id="qwen2.5-7b-instruct")
    arch = VLMArch(vlm=vlm, vision=tiny_vit_config(), llm=tcfg.tiny_qwen2_config(**llm_kw),
                   llm_family="qwen2")
    jarch = jax_vlm.VLMArch(vlm=vlm, vision=arch.vision, llm=tiny_qwen2_config(**llm_kw),
                            llm_family="qwen2")
    model = TimeViperVLM(arch, torch.float32, device="cpu")
    model.load_state_dict(from_jax_numpy(params, arch))
    return arch, jarch, model


@pytest.fixture(scope="module")
def plain():
    vlm = VLMConfig(arch_specifier="tome_mlp-2", llm_backbone_id="qwen2.5-7b-instruct")
    jarch = jax_vlm.VLMArch(vlm=vlm, vision=tiny_vit_config(), llm=tiny_qwen2_config(),
                            llm_family="qwen2")
    params = jax.jit(jax_vlm.init_vlm_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jarch, jnp.float32)
    arch, jarch, model = _vlm(params)
    return arch, jarch, params, model, jax_gen.Generator(params, jarch, cache_dtype=jnp.float32,
                                                         **KW)


def _video(n_frames, seed=1):
    pixels = rng(seed).random((n_frames, 28, 28, 3), np.float32) if n_frames else None
    return [5, 6] + [IMG] * n_frames + [9, 10, 11], pixels


@pytest.mark.parametrize("n_frames", [0, 3])
def test_generate_matches_jax(plain, n_frames):
    arch, _, params, model, jg = plain
    ids, pixels = _video(n_frames)
    want = jg.generate(ids, pixels=pixels, image_token_id=IMG)
    tg = Generator(model, arch, **KW)
    got = tg.generate(ids, pixels=pixels, image_token_id=IMG)
    assert got.token_ids.tolist() == want.token_ids.tolist()
    assert got.num_generated == 5
    plan, bucket, pad, ids_arr, gidx, seq = jg._plan_prompt(ids, IMG)
    visual = (jg.encode_frames(pixels) if n_frames
              else jnp.zeros((0, arch.llm.hidden_size), jnp.float32))
    first, _ = jg._get_prefill(bucket, bucket + 5)(
        params, jnp.asarray(ids_arr), jnp.asarray(gidx), jnp.asarray(seq), visual, pad)
    _close(got.first_logits, first, "first logits")


def test_continuation_matches_jax_and_a_decode_after_it(plain):
    _, _, params, model, _ = plain
    llm, cfg, tcfg_ = params["llm_backbone"], tiny_qwen2_config(), model.arch.llm
    P, S, S_bucket, M = 48, 11, 16, 96
    emb = rng(5).standard_normal((1, P + S, cfg.hidden_size)).astype(np.float32)

    @jax.jit
    def ref(p, e, suffix):
        pre = jq.qwen2_forward(p, cfg, inputs_embeds=e, fill_cache=True, cache_max_len=M)
        logits, cache = jax_pc.qwen2_forward_continue(p, cfg, suffix, pre["cache"],
                                                      jnp.asarray(S, jnp.int32))
        return logits, cache, jq.qwen2_decode_step(p, cfg, jnp.asarray([[7]]), cache)[0]

    suffix = np.pad(emb[:, P:], ((0, 0), (0, S_bucket - S), (0, 0)), constant_values=1.5)
    want, jcache, want_step = ref(llm, jnp.asarray(emb[:, :P]), jnp.asarray(suffix))
    lm = model.llm_backbone
    with torch.no_grad():
        pre = qwen2_forward(lm, tcfg_, inputs_embeds=t(emb[:, :P]), fill_cache=True,
                            cache_max_len=M)["cache"]
        k0 = pre["layers"][0]["k"].clone()
        got, cache = qwen2_forward_continue(lm, tcfg_, t(emb[:, P:]), pre)
        step, _ = qwen2_decode_step(lm, tcfg_, torch.tensor([[7]]), cache)
    assert torch.equal(pre["layers"][0]["k"], k0)  # the input cache is left untouched
    _close(got, want, "last logits")
    assert cache["length"] == int(jcache["length"]) == P + S
    for i, (g, w) in enumerate(zip(cache["layers"], jcache["layers"])):
        for key in ("k", "v"):
            _close(g[key][:, :P + S], w[key][:, :P + S], f"layer {i} {key}")
    _close(step, want_step, "decode after the continuation")


def test_questions_on_a_left_padded_prefix(plain):
    """The prefix bucket's left pad makes valid_from > 0: the question rows
    rotate at (length - valid_from) + i, as in the whole prompt."""
    arch, _, _, model, _ = plain
    ids, pixels = _video(3, seed=2)
    prefix, question = ids[:-3], [12, 13, 14, 15]
    tg = Generator(model, arch, **KW)
    state = tg.prefill_prefix(prefix, pixels=pixels, image_token_id=IMG, suffix_budget=16)
    assert state.pad > 0 and state.suffix_budget == 16
    got = tg.generate(question, prefix=state)
    want = tg.generate(prefix + question, pixels=pixels, image_token_id=IMG)
    assert got.token_ids.tolist() == want.token_ids.tolist()
    _close(got.first_logits, want.first_logits, "first logits")
    with pytest.raises(ValueError, match="suffix_budget"):
        tg.generate(list(range(20, 40)), prefix=state)


def _transv_setup(plain, pdrop_type):
    """tests/test_pdrop.py:380's backbone config and merge modules (the
    weights of the `plain` VLM's backbone), and the port's copies."""
    cfg = tiny_qwen2_config(use_pdrop=True, pdrop_type=pdrop_type,
                            merge_module="CrossAttention")
    merge = _merge_modules(cfg)
    params = jax.tree_util.tree_map(lambda x: x, plain[2]["llm_backbone"])
    tc = tcfg.tiny_qwen2_config(use_pdrop=True, pdrop_type=pdrop_type,
                                merge_module="CrossAttention")
    model = Qwen2Model(tc, torch.float32, device="cpu")
    model.load_state_dict(qwen2_state_dict(params))
    mm = MergeModules(tc, torch.float32, "cpu")
    mm.load_state_dict(merge_state_dict(merge))
    return cfg, params, merge, tc, model, mm


def test_transv_decode_after_a_stage_at_layer_1_matches_teacher_forcing(plain):
    """uni_1_0.5 over (2, 8, 6): layer 0 holds the 16 pre-drop rows, layers
    1-3 the 12 kept. The prefill and three decode steps against one JAX
    pdrop forward of the prompt and the three tokens (they extend the text
    suffix; the stage is causal row by row, so its rows 11-14 are the
    teacher-forced logits of each step)."""
    cfg, params, merge, tc, model, mm = _transv_setup(plain, "uni_1_0.5")
    emb = rng(4).standard_normal((1, 16, cfg.hidden_size)).astype(np.float32)
    toks = [3, 9, 14]

    @jax.jit
    def forced(p, mp, e):
        spec = jax_pdrop.make_pdrop_spec([(2, 8, e.shape[1] - 10)], cfg.pdrop_stages)
        return jq.qwen2_forward(p, cfg, inputs_embeds=e, pdrop_spec=spec,
                                pdrop_params=mp)["logits"][0]

    seq = np.concatenate([emb, np.asarray(params["embeddings"])[toks][None]], axis=1)
    want = forced(params, merge, jnp.asarray(seq))[11:]
    with torch.no_grad():
        out = qwen2_forward(model, tc, inputs_embeds=t(emb), fill_cache=True, cache_max_len=32,
                            pdrop_spec=make_pdrop_spec([(2, 8, 6)], tc.pdrop_stages),
                            pdrop_params=mm)
        _close(out["logits"][:, -1], want[0], "prefill")
        cache = out["cache"]
        assert [lc["kv_len"] for lc in cache["layers"]] == [16, 12, 12, 12]
        assert cache["ca_kv"][0]["k"].shape[0] == 4
        plain_step, _ = qwen2_decode_step(model, tc, torch.tensor([[toks[0]]]), {
            **cache, "layers": [dict(lc, k=lc["k"].clone(), v=lc["v"].clone())
                                for lc in cache["layers"]]})
        for i, tok in enumerate(toks):
            got, cache = qwen2_decode_step(model, tc, torch.tensor([[tok]]), cache,
                                           pdrop_params=mm)
            _close(got[0], want[i + 1], f"step {i}")
            if i == 0:
                assert not np.allclose(n(got), n(plain_step))  # the merge has effect
    assert "ca_kv" in cache and [lc["kv_len"] for lc in cache["layers"]] == [19, 15, 15, 15]


def test_transv_decode_after_a_stage_at_layer_0_matches_jax_decode(plain):
    """attn_0_0.5: every layer holds the kept rows, so the JAX decode step
    and the port's agree (the ranking's q/k projections carry biases and no
    RoPE; the keep sets are compared too)."""
    cfg, params, merge, tc, model, mm = _transv_setup(plain, "attn_0_0.5")
    emb = rng(6).standard_normal((1, 16, cfg.hidden_size)).astype(np.float32)
    _sharpen(params, 0)
    model.load_state_dict(qwen2_state_dict(params))

    @jax.jit
    def ref(p, mp, e):
        spec = jax_pdrop.make_pdrop_spec([(2, 8, 6)], cfg.pdrop_stages, [15])
        out = jq.qwen2_forward(p, cfg, inputs_embeds=e, pdrop_spec=spec, pdrop_params=mp,
                               fill_cache=True, cache_max_len=32)
        logits, c = [out["logits"][:, -1]], out["cache"]
        for tok in (3, 9):
            lg, c = jq.qwen2_decode_step(p, cfg, jnp.asarray([[tok]]), c, pdrop_params=mp)
            logits.append(lg)
        return logits, out["cache"]["ca_kv"][0]["k"]

    want, want_dropped = ref(params, merge, jnp.asarray(emb))
    with torch.no_grad():
        out = qwen2_forward(model, tc, inputs_embeds=t(emb), fill_cache=True, cache_max_len=32,
                            pdrop_spec=make_pdrop_spec([(2, 8, 6)], tc.pdrop_stages, [15]),
                            pdrop_params=mm)
        got, cache = [out["logits"][:, -1]], out["cache"]
        _close(cache["ca_kv"][0]["k"], want_dropped, "the dropped tokens' K (the keep set)")
        for tok in (3, 9):
            lg, cache = qwen2_decode_step(model, tc, torch.tensor([[tok]]), cache,
                                          pdrop_params=mm)
            got.append(lg)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"step {i}")


def test_generate_with_pdrop_matches_jax(plain):
    """An attn stage at layer 0 with TransV (alpha 0.5), 8 frames: the JAX
    Generator's tokens and first logits."""
    kw = dict(use_pdrop=True, pdrop_type="attn_0_0.5", merge_module="CrossAttention")
    params = jax.tree_util.tree_map(lambda x: x, plain[2])
    params["merge_modules"] = _merge_modules(tiny_qwen2_config(**kw))
    _sharpen(params["llm_backbone"], 0)
    arch, jarch, model = _vlm(params, **kw)
    ids, pixels = _video(8, seed=3)
    jg = jax_gen.Generator(params, jarch, cache_dtype=jnp.float32, **KW)
    want = jg.generate(ids, pixels=pixels, image_token_id=IMG, use_pdrop=True)
    tg = Generator(model, arch, **KW)
    got = tg.generate(ids, pixels=pixels, image_token_id=IMG, use_pdrop=True)
    assert got.token_ids.tolist() == want.token_ids.tolist()
    plan, bucket, pad, ids_arr, gidx, seq = jg._plan_prompt(ids, IMG)
    first, _ = jg._get_prefill_pdrop(bucket, bucket + 5, plan.num_visual)(
        params, jnp.asarray(ids_arr), jnp.asarray(gidx), jnp.asarray(seq),
        jg.encode_frames(pixels), pad, jnp.asarray(pad + plan.sample_layouts[0][0], jnp.int32),
        jnp.asarray(bucket - 1, jnp.int32))
    _close(got.first_logits, first, "first logits")
    plain = tg.generate(ids, pixels=pixels, image_token_id=IMG)
    assert not np.allclose(n(plain.first_logits), n(got.first_logits))


def test_engine_matches_the_offline_generator(plain):
    """tests/test_serving.py:228's arch and prompts (batched in one bucket),
    a 40-token prompt in chunks of 16, a 3-frame video and two questions on
    a prefix, in 2 slots: each request the offline Generator's tokens."""
    arch, _, _, model, _ = plain
    kw = dict(terminator_ids=[2], max_new_tokens=4)
    prompts = [[5 + i, 6, 7, 8] for i in range(3)]
    video_ids, pixels = _video(3, seed=4)
    long_ids = rng(8).integers(3, 400, 40).tolist()
    bad = ServingEngine(model, arch, num_slots=2, max_len=128, steps_per_sync=2,
                        cache_dtype=torch.float32, **kw)
    rejected = bad.run([Request(request_id=0, input_ids=prompts[0], max_new_tokens=4)])[0]
    assert rejected.done and "exceeds engine max_len" in rejected.error
    assert rejected.output_ids == []
    eng = ServingEngine(model, arch, num_slots=2, max_len=256, steps_per_sync=2,
                        prefill_chunk_tokens=16, cache_dtype=torch.float32, **kw)
    state = eng.prefill_prefix(video_ids[:-3], pixels=pixels, image_token_id=IMG,
                               suffix_budget=16)
    reqs = [Request(request_id=i, input_ids=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    reqs += [Request(request_id=3, input_ids=long_ids, max_new_tokens=4),
             Request(request_id=4, input_ids=video_ids, pixels=pixels, image_token_id=IMG,
                     max_new_tokens=4)]
    reqs += [Request(request_id=5 + i, input_ids=q, prefix=state, max_new_tokens=4)
             for i, q in enumerate(([12, 13, 14], [15, 16]))]
    out = eng.run(reqs)
    gen = Generator(model, arch, **kw)
    for r in out:
        assert r.done and r.error is None, (r.request_id, r.error)
        if r.prefix is not None:
            want = gen.generate(r.input_ids, prefix=state)
        else:
            want = gen.generate(r.input_ids, pixels=r.pixels, image_token_id=IMG)
        assert r.output_ids == want.token_ids.tolist(), r.request_id
        _close(r.first_logits, want.first_logits, f"request {r.request_id}")
    with pytest.raises(ValueError, match="nano family only"):
        ServingEngine(model, arch, num_slots=2, max_len=256, pdrop_frames=2,
                      cache_dtype=torch.float32, **kw)
