"""N-gram speculative decoding in the port (models/speculative.py, the
continuations' `logits_all` / `chunk_size`, the Generator's
`speculative="ngram"`) against the JAX package's models/speculative.py.

* `ngram_propose` equals JAX's on the buffers of tests/test_speculative.py,
  on the clamp at the buffer's end, with no match and -1 slots, and on
  hypothesis buffers; `text_history` equals JAX's.
* Speculative tokens equal the JAX Generator(speculative="ngram")'s and the
  port's plain greedy tokens, on a tiny random nano and qwen2 VLM bridged
  from JAX, with the prompts of tests/test_speculative.py (drafts mostly
  rejected: partial commits and plain rounds), and after a pdrop + TransV
  prefill.
* The successor rig (one-hot embeddings, a shifted lm_head, every mixer's
  output projection zeroed) on both backbones: every draft accepted, the
  cycle's tokens, and a terminator inside accepted drafts.
* The verify and commit calls against step-by-step decode (JAX's
  test_verify_commit_matches_decode_steps) on both backbones, the verify
  leaving the cache before it bitwise unchanged for the commit; the
  `chunk_size` override against the config's chunk; `logits_all` through an
  int8 lm_head.
* A speculative question on a PrefixState leaves the prefix bitwise
  unchanged and gives the plain loop's tokens.

Tolerance: f32, 1e-4 of the largest magnitude; tokens exactly equal. The JAX
side is jitted and shared in module fixtures.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch_parity import n, rng

from timeviper_tpu.config import VLMConfig, tiny_nano_config, tiny_qwen2_config, tiny_vit_config
from timeviper_tpu.models import generate as jax_gen
from timeviper_tpu.models import speculative as jax_spec
from timeviper_tpu.models import vlm as jax_vlm
from timeviper_tpu_torch import config as tcfg
from timeviper_tpu_torch.models.generate import Generator
from timeviper_tpu_torch.models.nano import nano_decode_step, nano_forward
from timeviper_tpu_torch.models.prefix_cache import (
    forward_continue,
    nano_forward_continue,
    scan_chunk,
)
from timeviper_tpu_torch.models.qwen2 import qwen2_decode_step, qwen2_forward
from timeviper_tpu_torch.models.speculative import ngram_propose, text_history
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch, init_vlm_params
from timeviper_tpu_torch.ops.int8_linear import Int8Linear
from timeviper_tpu_torch.params import from_jax_numpy
from timeviper_tpu_torch.train.quantize import quantize_params_int8

IMG = 500
QWEN = "qwen2.5-7b-instruct"
PDROP = dict(num_hidden_layers=6, hybrid_override_pattern="M-*M-*", use_pdrop=True,
             pdrop_type="uni_3_0.5-attn_5_0.25", merge_module="CrossAttention")
_jax_propose = jax.jit(jax_spec.ngram_propose, static_argnums=(2, 3))


def _close(got, want, what, tol=1e-4):
    got, want = n(got), n(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err < tol, (what, err)


def _propose_both(buf, buf_len, n_draft, k=2):
    got, has = ngram_propose(np.asarray(buf, np.int32), buf_len, n_draft, k)
    want, jhas = _jax_propose(jnp.asarray(buf, jnp.int32), jnp.asarray(buf_len, jnp.int32),
                              n_draft, k)
    assert got.tolist() == np.asarray(want).tolist() and has == bool(jhas), (
        buf, buf_len, got, want, has)
    return got.tolist(), has


def test_ngram_propose_matches_jax():
    pad = [-1] * 4
    # the most recent earlier match of (5, 6) ends at index 5: drafts from 6
    assert _propose_both([5, 6, 9, 9, 5, 6, 7, 8, 5, 6] + pad, 10, 3) == ([7, 8, 5], True)
    assert not _propose_both([1, 2, 3, 4, 9, 5, -1, -1], 6, 3)[1]  # no match
    assert not _propose_both([1, 2, 3, 4, 5, 6, -1, -1], 6, 2)[1]  # the self-match only
    # a match near the end: JAX's dynamic_slice clamps the start to M - n_draft
    # (the match is at 6: a plain slice would give [3, 4])
    assert _propose_both([1, 2, 9, 9, 3, 4, 3, 4], 8, 4) == ([3, 4, 3, 4], True)
    # drafts running into the unfilled -1 slots
    assert _propose_both([3, 4, 3, 4] + pad * 2, 4, 5) == ([3, 4, -1, -1, -1], True)
    # -1 slots never match, a history of one token, k = 3
    assert not _propose_both([-1, -1, 5, -1, -1, -1, -1, -1], 1, 2)[1]
    _propose_both([1, 2, 3, 1, 2, 3, 1, 2, -1, -1, -1, -1], 8, 3, 3)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(st.sampled_from([8, 16]), st.sampled_from([1, 3, 4]), st.data())
def test_ngram_propose_matches_jax_on_random_buffers(M, n_draft, data):
    buf_len = data.draw(st.integers(1, M))
    toks = data.draw(st.lists(st.integers(0, 3), min_size=buf_len, max_size=buf_len))
    _propose_both(toks + [-1] * (M - buf_len), buf_len, n_draft)


def test_text_history_matches_jax():
    for ids, kw in (([5, 6, IMG, IMG, 7, 0, 8], dict(max_new_tokens=4, n_draft=3)),
                    (list(range(1, 200)), dict(max_new_tokens=40, n_draft=7))):
        got = text_history(ids, IMG, 0, **kw)
        want = jax_spec.text_history(ids, IMG, 0, **kw)
        assert got[1] == want[1] and got[0].tolist() == want[0].tolist()


def _arches(family, **llm_kw):
    vlm = VLMConfig(arch_specifier="tome_mlp-2",
                    **({"llm_backbone_id": QWEN} if family == "qwen2" else {}))
    jcfg = (tiny_qwen2_config if family == "qwen2" else tiny_nano_config)(**llm_kw)
    tllm = (tcfg.tiny_qwen2_config if family == "qwen2" else tcfg.tiny_nano_config)(**llm_kw)
    arch = VLMArch(vlm=vlm, vision=tiny_vit_config(), llm=tllm, llm_family=family)
    jarch = jax_vlm.VLMArch(vlm=vlm, vision=arch.vision, llm=jcfg, llm_family=family)
    return arch, jarch


VOCAB = 48  # every prompt below fits one bucket and one history buffer of 128


@functools.lru_cache(maxsize=None)
def _bridged(family):
    """(port arch, JAX arch, JAX params, port model): tests/test_speculative.py's
    random VLMs (PRNGKey 0 for nano, 1 for qwen2) at a vocabulary of VOCAB
    ids, bridged."""
    arch, jarch = _arches(family, vocab_size=VOCAB)
    params = jax.jit(jax_vlm.init_vlm_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(1 if family == "qwen2" else 0), jarch, jnp.float32)
    model = TimeViperVLM(arch, torch.float32, device="cpu")
    model.load_state_dict(from_jax_numpy(params, arch))
    return arch, jarch, params, model


def _cover(t=3, vocab=VOCAB):
    """A prompt holding the bigram (t, y) for every id y but the pad and the
    image token, ending in t: whatever token a random model gives first, the
    proposer finds it, so the verify and the partial commit run."""
    return [x for y in range(1, vocab) if y != IMG for x in (t, y)] + [t]


# tests/test_speculative.py's prompts (repeated n-grams), and a covering one
# (whose verify passes are certain), each (family, ids, max_new_tokens)
CASES = {"nano": ("nano", [5, 6, 7, 8, 5, 6, 7, 9, 5, 6, 7, 8, 11], 12),
         "qwen2": ("qwen2", [5, 6, 7, 8, 5, 6, 7, 8, 9], 12),
         "nano-cover": ("nano", _cover(), 12),
         "qwen2-cover": ("qwen2", _cover(), 12)}


@pytest.mark.parametrize("case", list(CASES))
def test_spec_tokens_equal_jax_and_the_plain_loop(case):
    family, ids, max_new = CASES[case]
    arch, jarch, params, model = _bridged(family)
    kw = dict(terminator_ids=[2], pad_token_id=0, max_new_tokens=max_new)
    want = jax_gen.Generator(params, jarch, cache_dtype=jnp.float32, speculative="ngram",
                             n_draft=3, **kw).generate(ids).token_ids.tolist()
    spec = Generator(model, arch, speculative="ngram", n_draft=3, **kw).generate(ids)
    plain = Generator(model, arch, **kw).generate(ids)
    assert spec.token_ids.tolist() == want == plain.token_ids.tolist()
    assert plain.spec_stats is None
    if case.endswith("cover"):
        assert spec.spec_stats["verify"] > 0 and spec.spec_stats["partial"] > 0
    with pytest.raises(ValueError, match="speculative mode"):
        Generator(model, arch, speculative="eagle", **kw)


def _successor(family, vocab=16):
    """tests/test_speculative.py:98's successor model on the port: one-hot
    embeddings and a shifted lm_head over `vocab` ids below the hidden
    width, every mixer's output projection zeroed, so that the greedy token
    after i is (i + 1) % vocab."""
    arch, _ = _arches(family, vocab_size=vocab)
    model = init_vlm_params(arch, torch.Generator().manual_seed(0), torch.float32, device="cpu")
    llm = model.llm_backbone
    eye = torch.eye(vocab, arch.llm.hidden_size)
    with torch.no_grad():
        llm.embeddings.weight.copy_(eye)
        llm.lm_head.weight.copy_(eye.roll(1, 0))  # row (i + 1) % vocab reads dim i
        for name, p in llm.named_parameters():
            if any(f"{proj}." in name for proj in ("out_proj", "o_proj", "down_proj")):
                p.zero_()
    return arch, model


@pytest.mark.parametrize("family", ["nano", "qwen2"])
def test_successor_rig_accepts_every_draft(family):
    arch, model = _successor(family)
    kw = dict(pad_token_id=0, max_new_tokens=24)
    spec = Generator(model, arch, terminator_ids=[99], speculative="ngram", n_draft=4, **kw)
    plain = Generator(model, arch, terminator_ids=[99], **kw)
    out = spec.generate([3, 4, 5, 6, 7, 8])
    cycle = [(9 + t) % 16 for t in range(24)]
    assert out.token_ids.tolist() == cycle == plain.generate([3, 4, 5, 6, 7, 8]).token_ids.tolist()
    s = out.spec_stats
    assert s["verify"] > 0 and s["accepted"] == s["proposed"] and s["partial"] == 0
    # a terminator inside accepted drafts: 9, 10, 11, 12, 13 and stop
    spec = Generator(model, arch, terminator_ids=[13], speculative="ngram", n_draft=4, **kw)
    out = spec.generate(list(range(16)) + [3, 4, 5, 6, 7, 8])
    assert out.token_ids.tolist() == [9, 10, 11, 12, 13] and out.spec_stats["verify"] == 1


def _clone(cache):
    if isinstance(cache, torch.Tensor):
        return cache.clone()
    if isinstance(cache, dict):
        return {k: _clone(v) for k, v in cache.items()}
    if isinstance(cache, list):
        return [_clone(v) for v in cache]
    return cache


def _cache_close(got, want, rows, what):
    """Mamba states and the K/V rows below `rows` of two caches."""
    assert got["length"] == want["length"], what
    for i, (g, w) in enumerate(zip(got["layers"], want["layers"])):
        if "ssm_state" in g:
            _close(g["ssm_state"], w["ssm_state"], f"{what} layer {i} ssm_state")
            for part in ("x", "B", "C"):
                _close(g["conv_state"][part], w["conv_state"][part], f"{what} layer {i} {part}")
        if "k" in g:
            for key in ("k", "v"):
                _close(g[key][:, :rows], w[key][:, :rows], f"{what} layer {i} {key}")


@pytest.mark.parametrize("family", ["nano", "qwen2"])
def test_verify_and_commit_equal_decode_steps(family):
    arch, _ = _arches(family)
    model = init_vlm_params(arch, torch.Generator().manual_seed(3), torch.float32, device="cpu")
    llm, cfg = model.llm_backbone, arch.llm
    fwd, step = ((qwen2_forward, qwen2_decode_step) if family == "qwen2"
                 else (nano_forward, nano_decode_step))
    cont = forward_continue(arch)
    P, S, M = 24, 5, 64
    r = rng(1)
    ids = torch.as_tensor(r.integers(0, cfg.vocab_size, (1, P)))
    seq = r.integers(0, cfg.vocab_size, S).tolist()
    with torch.no_grad():
        pre = fwd(llm, cfg, input_ids=ids, fill_cache=True, cache_max_len=M)["cache"]
        embeds = llm.embeddings(torch.as_tensor([seq]))
        logits, verified = cont(llm, cfg, embeds, _clone(pre), logits_all=True, chunk_size=S)
        stepped, rows = _clone(pre), []
        for tok in seq:
            lg, stepped = step(llm, cfg, torch.as_tensor([[tok]]), stepped)
            rows.append(lg[0])
            if len(rows) == 2:
                two = _clone(stepped)
        assert logits.shape == (1, S, cfg.vocab_size)
        for i, row in enumerate(rows):
            _close(logits[0, i], row, f"logits row {i}")
        _cache_close(verified, stepped, P + S, "full accept")
        # the loop's pattern: verify, then commit 2 rows from the cache
        # before the verify, which the verify left as it was
        own = _clone(pre)
        before = _digest(own)
        cont(llm, cfg, embeds, own, logits_all=True, chunk_size=S)
        assert _same(_digest(own), before)
        _, committed = cont(llm, cfg, embeds[:, :2], own, logits_all=True, chunk_size=S)
        _cache_close(committed, two, P + 2, "partial commit")
        if family == "nano":
            # a suffix within one chunk of both sizes runs at the config's chunk;
            # a longer one at the override
            assert scan_chunk(cfg, S, S) == scan_chunk(cfg, S) == cfg.chunk_size
            assert scan_chunk(cfg, S, 2) == 2
            base, _ = cont(llm, cfg, embeds, _clone(pre), logits_all=True)
            assert torch.equal(base, logits)
            split, _ = cont(llm, cfg, embeds, _clone(pre), logits_all=True, chunk_size=2)
            _close(split, base, "chunks of 2 rows against one chunk", tol=1e-5)


def test_logits_all_through_an_int8_lm_head():
    """Every suffix row's logits through an int8 lm_head (its f32 dequant,
    models/nano.py:compute_logits on (B, S, D) rows): the last row's are the
    continuation's last-row logits, and each row's the int8 decode step's."""
    arch, _ = _arches("nano")
    model = init_vlm_params(arch, torch.Generator().manual_seed(4), torch.float32, device="cpu")
    llm, cfg = model.llm_backbone, arch.llm
    quantize_params_int8(llm, min_size=1)
    assert isinstance(llm.lm_head, Int8Linear)
    r = rng(2)
    seq = r.integers(0, cfg.vocab_size, 4).tolist()
    with torch.no_grad():
        pre = nano_forward(llm, cfg, input_ids=torch.as_tensor(r.integers(0, cfg.vocab_size,
                                                                          (1, 20))),
                           fill_cache=True, cache_max_len=32)["cache"]
        embeds = llm.embeddings(torch.as_tensor([seq]))
        rows, _ = nano_forward_continue(llm, cfg, embeds, pre, logits_all=True)
        last, _ = nano_forward_continue(llm, cfg, embeds, pre)
        assert rows.shape == (1, 4, cfg.vocab_size) and rows.dtype == torch.float32
        _close(rows[:, -1], last, "last row", tol=1e-6)
        cache = _clone(pre)
        for i, tok in enumerate(seq):
            step, cache = nano_decode_step(llm, cfg, torch.as_tensor([[tok]]), cache)
            _close(rows[0, i], step[0], f"row {i}")


def _digest(tree):
    if isinstance(tree, torch.Tensor):
        return [tree.clone()]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _digest(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _digest(v)]
    return [tree]


def _same(a, b):
    return len(a) == len(b) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(a, b))


@pytest.mark.parametrize("family", ["nano", "qwen2"])
def test_spec_question_leaves_the_prefix_state_unchanged(family):
    arch, _, _, model = _bridged(family)
    kw = dict(terminator_ids=[2], pad_token_id=0, max_new_tokens=10)
    spec = Generator(model, arch, speculative="ngram", n_draft=3, **kw)
    question = _cover()
    state = spec.prefill_prefix([5, 6, IMG, IMG, 7, 8], pixels=rng(1).random(
        (2, 28, 28, 3), np.float32), image_token_id=IMG, suffix_budget=112)
    assert state.cache_len == state.bucket + 112 + 10 + 5
    before = _digest(state.cache)
    got = spec.generate(question, prefix=state)
    assert _same(_digest(state.cache), before)
    want = Generator(model, arch, **kw).generate(question, prefix=state)
    assert got.token_ids.tolist() == want.token_ids.tolist()
    assert got.spec_stats["verify"] > 0 and got.spec_stats["partial"] > 0
    assert _same(_digest(state.cache), before)


def test_spec_after_a_pdrop_prefill_matches_jax():
    arch, jarch = _arches("nano", vocab_size=VOCAB, **PDROP)
    params = jax.jit(jax_vlm.init_vlm_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jarch, jnp.float32)
    params["merge_modules"] = [dict(m, alpha=jnp.asarray(a, jnp.float32))
                               for m, a in zip(params["merge_modules"], (0.7, 1.3))]
    model = TimeViperVLM(arch, torch.float32, device="cpu")
    model.load_state_dict(from_jax_numpy(params, arch))
    ids = _cover()[:-1] + [IMG] * 8 + [3]
    pixels = rng(1).random((8, 28, 28, 3), np.float32)
    kw = dict(terminator_ids=[-2], pad_token_id=0, max_new_tokens=8)
    want = jax_gen.Generator(params, jarch, cache_dtype=jnp.float32, speculative="ngram",
                             n_draft=3, **kw).generate(ids, pixels=pixels, image_token_id=IMG,
                                                       use_pdrop=True)
    got = Generator(model, arch, speculative="ngram", n_draft=3, **kw).generate(
        ids, pixels=pixels, image_token_id=IMG, use_pdrop=True)
    assert got.token_ids.tolist() == np.asarray(want.token_ids).tolist()
    assert got.spec_stats["verify"] > 0
