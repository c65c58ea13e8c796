"""pdrop through the port's entry points against the JAX package's, on a
tiny VLM (tiny SigLIP, `tome_mlp-2`: 2 tokens a frame) over a 6-layer Nano
`M-*M-*` (attention at layers 2 and 5: one before the stages, as on the
9B) with the stages "uni_3_0.5-attn_5_0.25" and TransV, alpha 0.7 and 1.3;
JAX-initialised weights bridged with from_jax_numpy, f32, greedy.

* Generator.generate(use_pdrop=True): the same tokens, and the first logits
  against the JAX bucketed pdrop prefill (`_get_prefill_pdrop`).
* prefill_prefix(use_pdrop=True) and a question on it: the same tokens.
* nano_forward_longctx with the stages at a length that stops dividing the
  chunk (JAX tests/test_longctx.py:42), against JAX's and the port's
  nano_forward.
* ServingEngine(pdrop_frames=...) with a text-only request sharing the
  slots (JAX tests/test_serving.py:272): the same tokens as the JAX engine,
  and the pdrop request's as the offline pdrop Generator's.
* W8A8 int8 (both int8 switches on, every linear quantized, the merge
  modules' too, calibrated in both packages): Generator.generate(use_pdrop=
  True) gives the JAX Generator's tokens.

Tolerance 1e-4 of the largest magnitude; tokens exactly equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_int8_generate import jit_in_order
from torch_parity import n, rng, t

from timeviper_tpu.config import VLMConfig, tiny_nano_config, tiny_vit_config
from timeviper_tpu.models import generate as jax_gen
from timeviper_tpu.models import longctx as jax_longctx
from timeviper_tpu.models import nano as jax_nano
from timeviper_tpu.models import pdrop as jax_pdrop
from timeviper_tpu.models import vit as jax_vit
from timeviper_tpu.models import vlm as jax_vlm
from timeviper_tpu.serving import Request as JaxRequest
from timeviper_tpu.serving import ServingEngine as JaxEngine
from timeviper_tpu.train import quantize as jax_quant
from timeviper_tpu_torch import config as tcfg
from timeviper_tpu_torch.models import pdrop
from timeviper_tpu_torch.models.generate import Generator
from timeviper_tpu_torch.models.longctx import nano_forward_longctx
from timeviper_tpu_torch.models.nano import nano_forward
from timeviper_tpu_torch.models.vit import vit_forward
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch
from timeviper_tpu_torch.params import from_jax_numpy
from timeviper_tpu_torch.serving import Request, ServingEngine
from timeviper_tpu_torch.train.quantize import calibrate_act_scales, quantize_params_int8

IMG = 500
PDROP = dict(num_hidden_layers=6, hybrid_override_pattern="M-*M-*", use_pdrop=True,
             pdrop_type="uni_3_0.5-attn_5_0.25", merge_module="CrossAttention")
ALPHAS = (0.7, 1.3)
FRAMES = 8  # 16 visual tokens -> 8 -> 4
KW = dict(terminator_ids=[-2], pad_token_id=0, max_new_tokens=5)


def _close(got, want, what, tol=1e-4):
    got, want = n(got), n(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err < tol, (what, err)


@functools.lru_cache(maxsize=None)
def _setup():
    vlm = VLMConfig(arch_specifier="tome_mlp-2")
    jllm, tllm = tiny_nano_config(**PDROP), tcfg.tiny_nano_config(**PDROP)
    arch = VLMArch(vlm=vlm, vision=tiny_vit_config(), llm=tllm)
    jarch = jax_vlm.VLMArch(vlm=vlm, vision=arch.vision, llm=jllm, llm_family="nano")
    # jitted, its dicts in the init's order (the JAX calibration pairs scales
    # by dict order)
    params = jit_in_order(lambda key: jax_vlm.init_vlm_params(key, jarch, jnp.float32),
                          jax.random.PRNGKey(0))
    params["merge_modules"] = [dict(m, alpha=jnp.asarray(a, jnp.float32))
                               for m, a in zip(params["merge_modules"], ALPHAS)]
    model = TimeViperVLM(arch, torch.float32, device="cpu")
    model.load_state_dict(from_jax_numpy(params, arch))
    return arch, jarch, params, model


def _video(seed=1):
    r = rng(seed)
    pixels = r.random((FRAMES, 28, 28, 3), np.float32)
    return [5, 6] + [IMG] * FRAMES + [9, 10, 11], pixels


def test_generate_with_pdrop_matches_jax():
    arch, jarch, params, model = _setup()
    ids, pixels = _video()
    jg = jax_gen.Generator(params, jarch, cache_dtype=jnp.float32, **KW)
    tg = Generator(model, arch, **KW)
    want = jg.generate(ids, pixels=pixels, image_token_id=IMG, use_pdrop=True)
    got = tg.generate(ids, pixels=pixels, image_token_id=IMG, use_pdrop=True)
    assert got.token_ids.tolist() == want.token_ids.tolist()
    assert len(got.token_ids) == 5
    plain = tg.generate(ids, pixels=pixels, image_token_id=IMG)
    assert not np.allclose(n(plain.first_logits), n(got.first_logits))

    plan, bucket, pad, ids_arr, gidx, seq = jg._plan_prompt(ids, IMG)
    vs = plan.sample_layouts[0][0]
    first, cache = jg._get_prefill_pdrop(bucket, bucket + 5, plan.num_visual)(
        params, jnp.asarray(ids_arr), jnp.asarray(gidx), jnp.asarray(seq),
        jg.encode_frames(pixels), pad, jnp.asarray(pad + vs, jnp.int32),
        jnp.asarray(bucket - 1, jnp.int32))
    _close(got.first_logits, first, "first logits")
    # the cache the port's prefill gives: lengths and TransV rows
    visual = tg.encode_frames(pixels)
    _, tcache = tg.prefill(ids_arr, gidx, seq, visual, pad, bucket + 5, pad + vs)
    drops = pdrop.pdrop_drop_counts(arch.llm, plan.num_visual)
    assert tcache["length"] == int(cache["length"]) == bucket - sum(drops)
    assert [tcache["layers"][i]["kv_len"] for i in (2, 5)] == [
        int(cache["layers"][i]["kv_len"]) for i in (2, 5)] == [bucket, bucket - sum(drops)]
    for si, drop in enumerate(drops):
        assert tcache["ca_kv"][si]["k"].shape[0] == drop
        _close(tcache["ca_kv"][si]["k"], cache["ca_kv"][si]["k"], f"ca_kv {si}")


def test_pdrop_prefix_and_a_question_match_jax():
    arch, jarch, params, model = _setup()
    ids, pixels = _video(2)
    prefix, question = ids[:-3], [12, 13, 14, 15]
    jg = jax_gen.Generator(params, jarch, cache_dtype=jnp.float32, **KW)
    tg = Generator(model, arch, **KW)
    jstate = jg.prefill_prefix(prefix, pixels=pixels, image_token_id=IMG, suffix_budget=16,
                               use_pdrop=True)
    tstate = tg.prefill_prefix(prefix, pixels=pixels, image_token_id=IMG, suffix_budget=16,
                               use_pdrop=True)
    assert (tstate.bucket, tstate.cache_len, tstate.pad) == (
        jstate.bucket, jstate.cache_len, jstate.pad)
    assert tstate.cache["length"] == int(jstate.cache["length"]) < tstate.bucket
    want = jg.generate(question, prefix=jstate).token_ids.tolist()
    got = tg.generate(question, prefix=tstate)
    assert got.token_ids.tolist() == want
    again = tg.generate(question, prefix=tstate)  # the prefix is left as it was
    np.testing.assert_array_equal(n(again.first_logits), n(got.first_logits))


def test_longctx_with_pdrop_at_a_nondivisible_length():
    """30 visual tokens -> 15 -> 7 (uni before layer 3, attn before layer 5):
    L 96 -> 81 -> 73, no multiple of the 32-row chunks."""
    arch, jarch, params, model = _setup()
    cfg = jarch.llm
    llm, lp = model.llm_backbone, params["llm_backbone"]
    emb = rng(3).standard_normal((1, 96, cfg.hidden_size)).astype(np.float32)
    spec_j = jax_pdrop.make_pdrop_spec([(8, 30, 58)], cfg.pdrop_stages, [95])
    spec_t = pdrop.make_pdrop_spec([(8, 30, 58)], arch.llm.pdrop_stages, [95])
    want = jax.jit(lambda p, e, m: jax_longctx.nano_forward_longctx(
        p, cfg, e, chunk_tokens=32, pdrop_spec=spec_j, pdrop_params=m,
        logits_to_keep=1)["logits"])(lp, jnp.asarray(emb), params["merge_modules"])
    got = nano_forward_longctx(llm, arch.llm, t(emb), chunk_tokens=32, pdrop_spec=spec_t,
                               pdrop_params=model.merge_modules)
    assert got["hidden_states"].shape[1] == 73
    _close(got["logits"], want, "longctx vs JAX longctx")
    with torch.no_grad():
        whole = nano_forward(llm, arch.llm, inputs_embeds=t(emb), logits_to_keep=1,
                             pdrop_spec=spec_t, pdrop_params=model.merge_modules)
    _close(got["logits"], whole["logits"], "longctx vs nano_forward")


def test_engine_pdrop_frames_with_a_text_only_slot():
    arch, jarch, params, model = _setup()
    ids, pixels = _video(4)
    text = [6, 7, 8, 9]
    greedy = dict(terminator_ids=[2], num_slots=2, max_len=256, max_new_tokens=5,
                  steps_per_sync=2, pdrop_frames=FRAMES)

    def mix(make):
        return [make(request_id=0, input_ids=ids, pixels=pixels, image_token_id=IMG,
                     max_new_tokens=5),
                make(request_id=1, input_ids=text, max_new_tokens=5),
                make(request_id=2, input_ids=text[::-1], max_new_tokens=3)]

    jax_out = JaxEngine(params, jarch, cache_dtype=jnp.float32, **greedy).run(mix(JaxRequest))
    eng = ServingEngine(model, arch, cache_dtype=torch.float32, **greedy)
    out = eng.run(mix(Request))
    assert all(r.done and r.error is None for r in out), [(r.request_id, r.error) for r in out]
    assert [r.output_ids for r in out] == [r.output_ids for r in jax_out]
    offline = Generator(model, arch, terminator_ids=[2], max_new_tokens=5).generate(
        ids, pixels=pixels, image_token_id=IMG, use_pdrop=True)
    assert out[0].output_ids == offline.token_ids.tolist()
    # a text-only slot's zero TransV rows are inert: its tokens are its own
    alone = Generator(model, arch, terminator_ids=[2], max_new_tokens=5).generate(text)
    assert out[1].output_ids == alone.token_ids.tolist()
    # a request of another frame count is refused, the others go on
    bad = eng.run([Request(request_id=3, input_ids=[5] + [IMG] * 2, pixels=pixels[:2],
                           image_token_id=IMG, max_new_tokens=2)])
    assert bad[0].error and "visual tokens" in bad[0].error
    state = Generator(model, arch, terminator_ids=[2], max_new_tokens=5).prefill_prefix(
        ids[:-3], pixels=pixels, image_token_id=IMG, suffix_budget=16, cache_len=256,
        use_pdrop=True)
    refused = eng.run([Request(request_id=4, input_ids=[12, 13], prefix=state)])
    assert "pdrop prefix states are not servable" in refused[0].error


def _merge_dropped(text, dropped, mm, cfg):
    """JAX's `_merge_dropped` in the port's pieces: text (T, D) cross-attends
    the dropped tokens (Nd, D)."""
    kv = pdrop._ca_kv(dropped, mm, cfg)
    return pdrop._gated_merge(text[None], kv["k"][None], kv["v"][None], mm, cfg)[0]


def test_int8_pdrop_generate_matches_jax(monkeypatch):
    for s in ("TIMEVIPER_LLM_INT8_MXU", "TIMEVIPER_VIT_INT8_MXU"):
        monkeypatch.setenv(s, "1")
    arch, jarch, params, model = _setup()
    model = TimeViperVLM(arch, torch.float32, device="cpu")
    model.load_state_dict(from_jax_numpy(params, arch))
    cfg = jarch.llm
    r = rng(5)
    cal_px = r.random((3, 28, 28, 3), np.float32)
    cal_ids = r.integers(10, 400, (1, 40)).astype(np.int32)
    text = r.standard_normal((6, cfg.hidden_size)).astype(np.float32)
    dropped = r.standard_normal((5, cfg.hidden_size)).astype(np.float32)
    vq = jax_quant.calibrate_act_scales(
        lambda p, b: jax_vit.vit_forward(p, jarch.vision, b),
        jax_quant.quantize_params_int8(params["vision_backbone"], min_size=1),
        [jnp.asarray(cal_px)])
    lq = jax_quant.calibrate_act_scales(
        lambda p, b: jax_nano.nano_forward(p, cfg, input_ids=b, logits_to_keep=1)["logits"],
        jax_quant.quantize_params_int8(params["llm_backbone"], min_size=1),
        [jnp.asarray(cal_ids)])
    # the merge modules, calibrated on one TransV merge each (q, k, v, o in
    # the order the pytree walk pairs them)
    mq = jax_quant.calibrate_act_scales(
        lambda p, b: [jax_pdrop._merge_dropped(b[0], b[1], m, cfg) for m in p],
        jax_quant.quantize_params_int8(params["merge_modules"], min_size=1),
        [(jnp.asarray(text), jnp.asarray(dropped))])
    qparams = dict(params, vision_backbone=vq, llm_backbone=lq, merge_modules=mq)

    calibrate_act_scales(lambda m, b: vit_forward(m, arch.vision, b),
                         quantize_params_int8(model.vision_backbone, min_size=1), [t(cal_px)])
    calibrate_act_scales(lambda m, b: nano_forward(m, arch.llm, input_ids=b, logits_to_keep=1),
                         quantize_params_int8(model.llm_backbone, min_size=1),
                         [t(cal_ids).long()])
    calibrate_act_scales(
        lambda m, b: [_merge_dropped(b[0], b[1], m.stage(i), arch.llm) for i in range(2)],
        quantize_params_int8(model.merge_modules, min_size=1), [(t(text), t(dropped))])
    sd, mine = from_jax_numpy(qparams, arch), model.state_dict()
    assert sd.keys() == mine.keys()
    assert sum(k.startswith("merge_modules") and k.endswith("act_inv") for k in sd) == 8
    for k, v in sd.items():
        if k.endswith("act_inv"):
            np.testing.assert_allclose(float(mine[k]), float(v), rtol=1e-5, err_msg=k)
    model.load_state_dict(sd)

    ids, pixels = _video(6)
    jg = jax_gen.Generator(qparams, jarch, cache_dtype=jnp.float32, **KW)
    want = jg.generate(ids, pixels=pixels, image_token_id=IMG, use_pdrop=True)
    got = Generator(model, arch, **KW).generate(ids, pixels=pixels, image_token_id=IMG,
                                                use_pdrop=True)
    assert got.token_ids.tolist() == want.token_ids.tolist()
