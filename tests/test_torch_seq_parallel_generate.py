"""The port's sequence-parallel entry points against the JAX package's, on a
2-device `seq` mesh: a tiny VLM (tiny SigLIP, `tome_mlp-2`: 2 tokens a frame)
over a 6-layer Nano `M-M*M-` with pdrop stages "uni_1_0.5-attn_3_0.25" and
TransV (alpha 0.7), JAX-initialised weights bridged with from_jax_numpy,
f32, greedy. JAX runs its Generator(mesh=) on the conftest's virtual CPU
devices; the port runs in one 2-rank gloo spawn (tests/torch_seq_ranks.py,
whose ranks never import JAX) while JAX computes. Every rank must return
the same tokens.

* `encode_frames_seq_parallel`: each rank's span of visual tokens against
  the JAX frame-sharded encode's, 1e-5 of the largest magnitude.
* `Generator(mesh=).generate`: the JAX Generator(mesh=)'s greedy tokens
  (tests/test_seq_parallel_generate.py:140), and the first logits against
  its sequence-sharded prefill to 2e-4 (that file's tolerance); the same
  with `use_pdrop=True` (a `kv_valid` cache, speculation off), and a
  question on a pdrop prefix from `prefill_prefix(use_pdrop=True)`.
* `ServingEngine(mesh=)` with a text, a video and a longer text request:
  the tokens of the engine without a mesh (which batches the text prompts).
* `eval/evaluate.py --mesh_seq 2` on tests/test_torch_api.py's tiny
  checkpoint and records: rank 0 alone writes the answers, and they are the
  answers of the CLI without a mesh.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_seq_ranks as ranks
from torch_parity import n, rng

from timeviper_tpu.config import VLMConfig, tiny_nano_config, tiny_vit_config
from timeviper_tpu.models import generate as jax_gen
from timeviper_tpu.models import vlm as jax_vlm
from timeviper_tpu.parallel.sharding import make_mesh as jax_mesh
from timeviper_tpu_torch import config as tcfg
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch
from timeviper_tpu_torch.params import from_jax_numpy
from timeviper_tpu_torch.serving import Request, ServingEngine

PDROP = dict(use_pdrop=True, pdrop_type="uni_1_0.5-attn_3_0.25", merge_module="CrossAttention")
IMG = 500
FRAMES = 8
KW = dict(terminator_ids=[-2], pad_token_id=0, max_new_tokens=6)
IDS = [5, 6] + [IMG] * FRAMES + [9, 10, 11]
PREFIX, QUESTION = [5, 6] + [IMG] * FRAMES, [9, 10, 11, 12]


def _close(got, want, tol, what):
    got, want = n(got), n(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err <= tol, (what, err)


@functools.lru_cache(maxsize=None)
def _setup():
    vlm = VLMConfig(arch_specifier="tome_mlp-2")
    jllm, tllm = tiny_nano_config(**PDROP), tcfg.tiny_nano_config(**PDROP)
    arch = VLMArch(vlm=vlm, vision=tiny_vit_config(), llm=tllm)
    jarch = jax_vlm.VLMArch(vlm=vlm, vision=arch.vision, llm=jllm, llm_family="nano")
    params = jax.jit(lambda key: jax_vlm.init_vlm_params(key, jarch, jnp.float32))(
        jax.random.PRNGKey(0))
    params["merge_modules"] = [dict(m, alpha=jnp.asarray(0.7, jnp.float32))
                               for m in params["merge_modules"]]
    model = TimeViperVLM(arch, torch.float32, device="cpu")
    model.load_state_dict(from_jax_numpy(params, arch))
    return arch, jarch, params, model.eval()


def _requests(pixels):
    r = rng(3)
    return [dict(input_ids=r.integers(1, 400, 9).tolist(), max_new_tokens=5),
            dict(input_ids=IDS, pixels=pixels, image_token_id=IMG, max_new_tokens=6),
            dict(input_ids=r.integers(1, 400, 30).tolist(), max_new_tokens=4)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One 2-rank spawn: the ranks start up while the parent makes the
    inputs, and run while it computes the references."""
    import test_torch_api as api_tests

    folder = tmp_path_factory.mktemp("generate")
    with ranks.running(ranks.generate, str(folder)) as got:
        arch, jarch, params, model = _setup()
        pixels = rng(1).random((FRAMES, 28, 28, 3), np.float32)
        ckpt = folder / "ckpt"
        api_tests.write_checkpoint(ckpt, api_tests.CONFIG)
        argv = ["--checkpoint", str(ckpt), "--dataset_name", "mvbench", "--max_new_tokens", "6",
                "--min_frames", "4", "--max_frames", "4", "--device", "cpu"]
        ranks.save_inputs(str(folder), arch=arch, state=model.state_dict(), pixels=pixels,
                          ids=IDS, img=IMG, gen_kw=KW, prefix_ids=PREFIX, question=QUESTION,
                          engine_kw=dict(terminator_ids=[-2], num_slots=2, max_len=160),
                          requests=_requests(pixels),
                          eval=dict(records=api_tests.RECORDS, argv=argv,
                                    mesh_dir=str(folder / "mesh"), one_dir=str(folder / "one")))
        want = _references(pixels)
    return pixels, got, folder, want


def _references(pixels):
    """JAX's Generator(mesh=) on the prompts of the ranks (its encode, the
    plain and pdrop generations, a question on a pdrop prefix, the first
    logits of its sharded prefills), and the port's engine without a mesh."""
    arch, jarch, params, model = _setup()
    jg = jax_gen.Generator(params, jarch, mesh=jax_mesh(data=1, seq=2), cache_dtype=jnp.float32,
                           **KW)
    want = {"encode": np.asarray(jg.encode_frames(pixels)),  # (F * 2, D), sharded over frames
            "tokens": jg.generate(IDS, pixels=pixels, image_token_id=IMG),
            "pdrop": jg.generate(IDS, pixels=pixels, image_token_id=IMG, use_pdrop=True)}
    st = jg.prefill_prefix(PREFIX, pixels=pixels, image_token_id=IMG, use_pdrop=True,
                           suffix_budget=16)
    want["prefix_kv_valid"] = np.asarray(st.cache["kv_valid"])
    want["question"] = jg.generate(QUESTION, prefix=st)
    plan, bucket, pad, ids_arr, gidx, _ = jg._plan_prompt(IDS, IMG)
    visual = jg.encode_frames(pixels)
    cache_len = bucket + KW["max_new_tokens"]
    want["first"], _ = jg._get_prefill_seq_parallel(bucket, cache_len)(
        params, jnp.asarray(ids_arr), jnp.asarray(gidx), visual, jnp.asarray(pad, jnp.int32))
    vs = plan.sample_layouts[0][0]
    want["pdrop_first"], _ = jg._get_prefill_seq_parallel(
        bucket, cache_len, num_visual=plan.num_visual, use_pdrop=True)(
        params, jnp.asarray(ids_arr), jnp.asarray(gidx), visual, jnp.asarray(pad, jnp.int32),
        jnp.asarray(pad + vs, jnp.int32), jnp.asarray(bucket - 1, jnp.int32))
    eng = ServingEngine(model, arch, terminator_ids=[-2], num_slots=2, max_len=160,
                        cache_dtype=torch.float32)
    want["engine"] = [r.output_ids for r in eng.run([Request(request_id=i, **r)
                                                     for i, r in enumerate(_requests(pixels))])]
    return want


def test_frame_sharded_encode_matches_jax(run):
    pixels, got, _, refs = run
    want = refs["encode"]
    half = want.shape[0] // 2
    for r in range(2):
        _close(got[r]["encode"][0], want[r * half:(r + 1) * half], 1e-5, f"rank {r} encode")


def test_generator_mesh_matches_jax_generator_mesh(run):
    pixels, got, _, refs = run
    want, want_pdrop, want_q = refs["tokens"], refs["pdrop"], refs["question"]
    for r in range(2):
        assert got[r]["tokens"].tolist() == want.token_ids.tolist()
        assert got[r]["pdrop_tokens"].tolist() == want_pdrop.token_ids.tolist()
        assert got[r]["prefix_tokens"].tolist() == want_q.token_ids.tolist()
        assert len(got[r]["tokens"]) == 6
    assert np.array_equal(n(got[0]["prefix_kv_valid"]), refs["prefix_kv_valid"])
    assert not np.allclose(n(got[0]["first"]), n(got[0]["pdrop_first"]))
    # the first logits, from the JAX Generator's own sharded prefills
    for r in range(2):
        _close(got[r]["first"], refs["first"], 2e-4, "first logits")
        _close(got[r]["pdrop_first"], refs["pdrop_first"], 2e-4, "pdrop first logits")


def test_serving_engine_mesh_matches_engine_without_mesh(run):
    pixels, got, _, refs = run
    want = refs["engine"]
    assert [len(w) for w in want] == [5, 6, 4]
    for r in range(2):
        assert got[r]["engine"] == want



def test_eval_cli_mesh_seq_writes_the_answers_once(run):
    """Rank 0 alone writes the 3 answers, and they are the CLI's without a
    mesh (run on rank 0 after it)."""
    import json
    import os

    def answers(d):
        with open(os.path.join(d, "0_of_1.jsonl")) as f:
            return {r["qid"]: r["output_text"] for r in map(json.loads, f)}

    got, want = answers(run[2] / "mesh"), answers(run[2] / "one")
    assert len(got) == 3 and got == want
