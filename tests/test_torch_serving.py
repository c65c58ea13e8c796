"""serving/engine.py against timeviper_tpu/serving/engine.py: one request mix
through both engines, on the tiny VLM of tests/test_torch_generate_prefix.py
(tiny SigLIP, `tome_mlp-2`, the 6-layer `M-M*M-` backbone with chunk 16),
JAX-initialised weights bridged with from_jax_numpy, f32, greedy.

The mix, through 4 slots: more requests than slots (slots are refilled);
two length buckets (128 and 256) of two prompts each, batched in the first
round; a request with pixels (the single-row path); a 400-token prompt
prefilled in chunks of 160 (three rounds, through the continuation); two
questions on a prefix from engine.prefill_prefix (one served, one whose
suffix overflows the prefix's budget); a prompt whose bucket and token budget
overflow max_len; and a terminator that stops a request early (a token one
request produces, found by a run of the port's engine without terminators).
Both engines give the same output tokens (but see test_engine_matches_jax
on near-ties), the same `done` and the same `error` messages. The JAX
engine runs once for the file (its compiles cost ~15 s on a CPU).

Port-only checks: every served token of the text-only requests is the
argmax of one nano_forward over prompt + output (teacher forcing), to 1e-4
(f32 decode steps against one forward), and the first-token logits of a
batched row equal Generator.generate's on the same prompt, to 1e-4; the
`mesh` with a model axis shards the model and its caches, and
`pdrop_frames` on a model without pdrop stages raises ValueError.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rng

from timeviper_tpu.config import NanoConfig, VLMConfig, tiny_vit_config
from timeviper_tpu.models import vlm as jax_vlm
from timeviper_tpu.serving import Request as JaxRequest
from timeviper_tpu.serving import ServingEngine as JaxEngine
from timeviper_tpu_torch.models.generate import Generator
from timeviper_tpu_torch.models.nano import nano_forward
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch
from timeviper_tpu_torch.params import from_jax_numpy
from timeviper_tpu_torch.serving import Request, ServingEngine

IMG = 200
LLM = NanoConfig(vocab_size=256, hidden_size=32, intermediate_size=64, num_hidden_layers=6,
                 hybrid_override_pattern="M-M*M-", num_attention_heads=2, head_dim=16,
                 num_key_value_heads=1, ssm_state_size=16, mamba_num_heads=4, mamba_n_groups=2,
                 mamba_head_dim=8, chunk_size=16)
ENGINE = dict(num_slots=4, max_len=448, steps_per_sync=3, prefill_chunk_tokens=150,
              pad_token_id=0)


def _mix():
    """[(kind, kwargs)] of the request mix, in queue order."""
    r = rng(11)

    def text(n):
        return r.integers(1, 190, n).tolist()

    pixels = r.random((2, 28, 28, 3), np.float32)
    return [
        ("text", dict(input_ids=text(6), max_new_tokens=5)),       # bucket 128
        ("text", dict(input_ids=text(9), max_new_tokens=7)),       # bucket 128
        ("text", dict(input_ids=text(140), max_new_tokens=4)),     # bucket 256
        ("text", dict(input_ids=text(150), max_new_tokens=6)),     # bucket 256
        ("pixels", dict(input_ids=[5, IMG, IMG, 9, 10], pixels=pixels, image_token_id=IMG,
                        max_new_tokens=5)),
        ("text", dict(input_ids=text(4), max_new_tokens=8)),
        ("text", dict(input_ids=text(400), max_new_tokens=5)),     # chunked: 160 + 160 + 80
        ("prefix", dict(input_ids=text(12), max_new_tokens=6)),
        ("prefix", dict(input_ids=text(20), max_new_tokens=3)),    # suffix bucket 32 > 16
        ("text", dict(input_ids=text(11), max_new_tokens=4)),
        ("text", dict(input_ids=text(140), max_new_tokens=200)),   # 256 + 200 > 448
        ("text", dict(input_ids=text(135), max_new_tokens=3)),
    ]


PREFIX = dict(input_ids=[5, 6, IMG, IMG, 7, 8], image_token_id=IMG, suffix_budget=16)
PREFIX_PIXELS = rng(12).random((2, 28, 28, 3), np.float32)


def _serve(make_engine, make_request, mix):
    eng = make_engine()
    state = eng.prefill_prefix(pixels=PREFIX_PIXELS, **PREFIX)
    reqs = [make_request(request_id=i, prefix=state if kind == "prefix" else None, **kw)
            for i, (kind, kw) in enumerate(mix)]
    return eng.run(reqs)


@functools.lru_cache(maxsize=None)
def _setup():
    vlm = VLMConfig(arch_specifier="tome_mlp-2")
    arch = VLMArch(vlm=vlm, vision=tiny_vit_config(), llm=LLM)
    jarch = jax_vlm.VLMArch(vlm=vlm, vision=arch.vision, llm=LLM, llm_family="nano")
    params = jax.jit(jax_vlm.init_vlm_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jarch, jnp.float32)
    model = TimeViperVLM(arch, torch.float32, device="cpu")
    model.load_state_dict(from_jax_numpy(params, arch))
    mix = _mix()

    def port(terminators):
        return _serve(lambda: ServingEngine(model, arch, terminator_ids=terminators,
                                            cache_dtype=torch.float32, **ENGINE),
                      Request, mix)

    # a token the 6-token request emits third: the terminator that stops it
    term = port([])[0].output_ids[2]
    got = port([term])
    want = _serve(lambda: JaxEngine(params, jarch, terminator_ids=[term],
                                    cache_dtype=jnp.float32, **ENGINE),
                  JaxRequest, mix)
    return arch, model, mix, term, got, want


def _forced_row(model, ids, outputs, t):
    """The f32 logits of one nano_forward over prompt + outputs[:t] at the
    row that predicts output t."""
    seq = torch.tensor([ids + outputs[:t]])
    with torch.no_grad():
        return nano_forward(model.llm_backbone, LLM, input_ids=seq)["logits"][0, -1]


def test_engine_matches_jax():
    """Token-equal, except where the JAX engine's own token is not the argmax
    of one forward over the same tokens: its chunked continuation drifts from
    that forward by up to ~5e-3 in f32 (tests/test_serving.py's note), so at
    a near-tie of a text request the comparison stops there, and the port's
    token must be the argmax and JAX's within 5e-3 of it."""
    _, model, mix, term, got, want = _setup()
    assert [r.error for r in got] == [r.error for r in want]
    assert [r.done for r in got] == [r.done for r in want] == [True] * len(mix)
    equal = 0
    for (kind, kw), g, w in zip(mix, got, want):
        if g.output_ids == w.output_ids:
            equal += 1
            continue
        t_ = next(i for i, (a, b) in enumerate(zip(g.output_ids, w.output_ids)) if a != b)
        assert kind == "text", (g.request_id, g.output_ids, w.output_ids)
        row = _forced_row(model, kw["input_ids"], g.output_ids, t_)
        assert row[g.output_ids[t_]] == row.max(), (g.request_id, t_)
        assert row.max() - row[w.output_ids[t_]] <= 5e-3, (g.request_id, t_)
    assert equal >= len(mix) - 1
    # what the mix is for: an early stop, both rejections, every other served
    assert got[0].output_ids[-1] == term and len(got[0].output_ids) < 5
    assert [i for i, r in enumerate(got) if r.error] == [8, 10]
    assert "suffix_budget" in got[8].error and "exceeds engine max_len" in got[10].error
    assert all(len(r.output_ids) > 0 for r in got if not r.error)


def test_engine_teacher_forcing_and_first_logits():
    arch, model, mix, term, got, _ = _setup()
    llm = model.llm_backbone
    n_forced = 0
    with torch.no_grad():
        for (kind, kw), r in zip(mix, got):
            if kind != "text" or r.error:
                continue
            seq = torch.tensor([kw["input_ids"] + r.output_ids[:-1]])
            logits = nano_forward(llm, LLM, input_ids=seq)["logits"][0]
            rows = logits[len(kw["input_ids"]) - 1:]
            for tok, row in zip(r.output_ids, rows):
                assert row[tok] >= row.max() - 1e-4, (r.request_id, tok, int(row.argmax()))
            n_forced += len(r.output_ids)
    assert n_forced >= 30
    # a batched row (bucket 128, a left pad of 119) against the Generator's own prefill
    gen = Generator(model, arch, terminator_ids=[term], max_new_tokens=7)
    ref = gen.generate(mix[1][1]["input_ids"])
    assert ref.token_ids.tolist() == got[1].output_ids
    np.testing.assert_allclose(got[1].first_logits.numpy(), ref.first_logits.numpy(),
                               rtol=1e-4, atol=1e-4)


class ModelAxisMesh:
    """A (data 1, seq 1, model 2) mesh's shape, as the engine reads it."""

    mesh_dim_names = ("data", "seq", "model")

    def size(self, dim: int = None) -> int:
        return 2 if dim is None else (1, 1, 2)[dim]

    def get_local_rank(self, axis: str) -> int:
        return 0


@pytest.mark.parametrize("option", [dict(pdrop_frames=4), dict(mesh=ModelAxisMesh())])
def test_unported_options_raise(option):
    """`pdrop_frames` (tests/test_torch_pdrop_generate.py) refuses a model
    without pdrop stages, as the JAX engine does. A mesh with a model axis is
    served (its runs: tests/test_torch_mesh_serve.py): the engine shards a
    copy of the model and its slot caches hold this rank's heads and
    channels."""
    arch, model, *_ = _setup()
    if "pdrop_frames" in option:
        with pytest.raises(ValueError, match="pdrop-configured"):
            ServingEngine(model, arch, terminator_ids=[2], cache_dtype=torch.float32,
                          num_slots=1, max_len=64, **option)
        return
    shard = TimeViperVLM(arch, torch.float32, device="cpu")
    shard.load_state_dict(model.state_dict())
    eng = ServingEngine(shard, arch, terminator_ids=[2], cache_dtype=torch.float32,
                        num_slots=1, max_len=64, **option)
    # one KV head does not split in two: attention runs whole on each rank
    attn = eng.cache_layers[LLM.attention_layer_indices[0]]
    assert attn["k"].shape[2] == LLM.num_key_value_heads == 1
    mamba = eng.cache_layers[LLM.mamba_layer_indices[0]]
    assert mamba["ssm_state"].shape[1] == LLM.mamba_num_heads // 2
    assert eng.batch_prefill


def test_a_completed_chunked_prompt_keeps_its_slot():
    """Two slots: a 70-token prompt in chunks of 32 holds slot 0 while a
    long request decodes in slot 1 and two wait. In the round where the
    chunks complete, slot 0 must not be handed to a waiting request before
    the prompt's state lands there (the JAX engine does hand it out, and the
    waiting request is lost). Every request finishes with the Generator's
    tokens."""
    arch, model, *_ = _setup()
    r = rng(13)
    prompts = [r.integers(1, 190, n).tolist() for n in (70, 5, 6, 7)]
    news = (4, 20, 3, 3)
    eng = ServingEngine(model, arch, terminator_ids=[], cache_dtype=torch.float32, num_slots=2,
                        max_len=160, steps_per_sync=3, prefill_chunk_tokens=32)
    out = eng.run([Request(request_id=i, input_ids=p, max_new_tokens=m)
                   for i, (p, m) in enumerate(zip(prompts, news))])
    assert [r.done and not r.error for r in out] == [True] * 4
    for p, m, r in zip(prompts, news, out):
        gen = Generator(model, arch, terminator_ids=[], max_new_tokens=m)
        assert r.output_ids == gen.generate(p).token_ids.tolist()
