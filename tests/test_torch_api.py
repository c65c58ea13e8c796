"""The port's checkpoint loading, chat and eval CLI against the JAX package,
on one tiny checkpoint directory that the test writes: `config.json`, two
`.bin` shards in the reference's layout (made from a seed through
`chip_smoke.py:reference_state_dict`) and a word-level tokenizer, as
tests/test_eval_cli.py writes them. Both packages load the same directory
in f32 on the CPU (the port with device="cpu"); the JAX model is loaded
once per module and its Generator jitted once per prompt shape.

Checks: `chat` text, `generate` with an answer prompt and a question on
`prefill_video_prefix` equal JAX's; the port's eval CLI
(`timeviper_tpu_torch.eval.evaluate.main`) writes predictions equal to the
port's own `generate` in its three generation modes (the Generator,
`--prefix_cache`, `--use_serving_engine`) and with `--speculative`,
resumes, and scores them as
JAX's `calc_score` does; a TransV checkpoint loads its merge modules; the
bf16 load takes the JAX loader's values; the JAX-only formats and options
are refused."""

import json
import os

import numpy as np
import pytest
import torch
from torch_parity import rng

from chip_smoke import reference_state_dict
from timeviper_tpu_torch.models.api import checkpoint_arch, load_pretrained_vlm, load_vlm_weights
from timeviper_tpu_torch.models.vlm import init_vlm_params

CONFIG = {"model_id": "timeviper-debug", "vision_backbone_id": "debug-vit-tiny",
          "llm_backbone_id": "debug-nano-tiny", "arch_specifier": "tome_mlp-2",
          "conv_template": "nano_base"}
WORDS = ("<pad> <unk> <SPECIAL_10> <SPECIAL_11> <SPECIAL_12> System User Assistant ( ) A "
         "B C D . what color is the sky blue red Best Option : Please provide your answer "
         "by stating letter followed full option").split()
QUESTION = "what color is the sky ."
MAX_NEW = 6
RECORDS = [{"video": f"/nonexistent/v{i % 2}.mp4", "question": QUESTION if i < 2 else
            "is the sky red .", "options": ["A . blue", "B . red"], "answer": i % 2,
            "duration": 10.0, "task_type": "color", "qid": f"fake|{i}"} for i in range(3)]


def write_tokenizer(path) -> None:
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(WORDS)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>", unk_token="<unk>",
                            eos_token="<SPECIAL_12>").save_pretrained(str(path))


def write_checkpoint(path, config: dict, seed: int = 0):
    """config.json, the weights as two .bin shards in the reference's
    layout, the tokenizer. The weights are the port's init from the seed,
    their 1-D and scalar leaves (norms, biases, TransV's alphas, which start
    at 0) moved off their init values by numpy noise so that each counts. Returns the state_dict the shards were made from."""
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "config.json", "w") as f:
        json.dump(config, f)
    arch, _ = checkpoint_arch(str(path))
    model = init_vlm_params(arch, torch.Generator().manual_seed(seed), dtype=torch.float32,
                            device="cpu")
    r = rng(seed)
    sd = {k: v + torch.from_numpy(np.asarray(0.1 * r.standard_normal(v.shape), np.float32))
          if v.ndim <= 1 and not k.endswith((".A_log", ".D", ".dt_bias")) else v
          for k, v in model.state_dict().items()}
    ref = {k: v.contiguous() for k, v in reference_state_dict(sd, arch).items()}
    names = sorted(ref)
    for i, part in enumerate((names[: len(names) // 2], names[len(names) // 2:])):
        torch.save({k: ref[k] for k in part}, path / f"pytorch_model-{i + 1:05d}-of-00002.bin")
    write_tokenizer(path)
    return sd


def frames(seed: int, n: int = 4) -> np.ndarray:
    return rng(seed).integers(0, 255, (n, 28, 28, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """(the checkpoint directory, the state_dict its shards were made from)."""
    path = tmp_path_factory.mktemp("ckpt")
    return path, write_checkpoint(path, CONFIG)


@pytest.fixture(scope="module")
def ckpt(written):
    return written[0]


@pytest.fixture(scope="module")
def models(ckpt):
    import jax.numpy as jnp

    from timeviper_tpu.models.api import load_pretrained_vlm as jax_load

    jax_model = jax_load(str(ckpt), max_new_tokens=MAX_NEW, dtype=jnp.float32)
    port = load_pretrained_vlm(str(ckpt), max_new_tokens=MAX_NEW, dtype=torch.float32,
                               device="cpu")
    return jax_model, port


def test_loaded_weights_are_the_checkpoint(written):
    """f32: every tensor of the loaded model is the one the shards were made
    from, bitwise."""
    ckpt, sd = written
    model, arch, meta = load_vlm_weights(str(ckpt), dtype=torch.float32, device="cpu")
    got = model.state_dict()
    assert sorted(got) == sorted(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    assert meta["conv_template"] == "nano_base" and arch.llm.vocab_size == 128


def test_chat_matches_jax(models):
    jax_model, port = models
    px = frames(1)
    assert port.chat(QUESTION, frames=px) == jax_model.chat(QUESTION, frames=px)


def test_generate_with_answer_prompt_matches_jax(models):
    jax_model, port = models
    prompt = port.template.prompt_for_generation("<image>" * 4 + "\n" + QUESTION)
    enc = port.processor(prompt, videos=[list(frames(2))])
    jenc = jax_model.processor(prompt, videos=[list(frames(2))])
    assert np.array_equal(enc["input_ids"], jenc["input_ids"])
    assert np.array_equal(enc["pixels"], jenc["pixels"])
    got = port.generate(enc["input_ids"], pixels=enc["pixels"], answer_prompt="Best Option: (")
    want = jax_model.generate(jenc["input_ids"], pixels=jenc["pixels"],
                              answer_prompt="Best Option: (")
    assert got == want


def test_question_on_a_video_prefix_matches_jax(models):
    from timeviper_tpu_torch.models.generate import split_prompt_at_last_image

    jax_model, port = models
    prompt = port.template.prompt_for_generation("<image>" * 4 + "\n" + QUESTION)
    enc = port.processor(prompt, videos=[list(frames(3))])
    pre, suf = split_prompt_at_last_image(enc["input_ids"], port.processor.image_token_id)
    texts = []
    for m in (port, jax_model):
        state = m.prefill_video_prefix(pre, enc["pixels"], suffix_budget=64)
        texts.append(m.generate(suf, prefix=state))
    assert texts[0] == texts[1]


def _fake_load_video(path, **kw):
    from timeviper_tpu_torch.data.video import VideoMeta

    return frames(int(path[-5])), np.arange(4) / 1.0, VideoMeta(4, 1.0, 4.0)


@pytest.mark.parametrize("mode", ["plain", "prefix_cache", "serving", "speculative"])
def test_eval_cli_matches_generate_and_jax_scores(mode, ckpt, models, tmp_path, monkeypatch,
                                                  capsys):
    import timeviper_tpu_torch.data.video as video_mod
    import timeviper_tpu_torch.eval.evaluate as ev
    from timeviper_tpu.eval.scoring import calc_score, load_scored_data
    from timeviper_tpu_torch.eval.datasets import (
        MCQ_ANSWER_PROMPT,
        EvalDataset,
        EvalSampleConfig,
    )

    monkeypatch.setattr(ev, "load_benchmark", lambda name, root, split: list(RECORDS))
    monkeypatch.setattr(video_mod, "load_video", _fake_load_video)
    out_dir = str(tmp_path / mode)
    argv = ["--checkpoint", str(ckpt), "--dataset_name", "mvbench", "--output_dir", out_dir,
            "--max_new_tokens", str(MAX_NEW), "--min_frames", "4", "--max_frames", "4",
            "--device", "cpu"]
    argv += {"plain": [], "prefix_cache": ["--prefix_cache", "--suffix_budget", "64"],
             "serving": ["--use_serving_engine", "--serving_slots", "2"],
             "speculative": ["--speculative", "ngram", "--n_draft", "3"]}[mode]
    ev.main(argv)
    if mode == "prefix_cache":
        assert "prefix-cache hits: 1/3" in capsys.readouterr().out
    shard = os.path.join(out_dir, "0_of_1.jsonl")
    with open(shard) as f:
        recs = {r["qid"]: r for r in map(json.loads, f)}
    port = models[1]
    ds = EvalDataset(list(RECORDS), "mcq", port.processor, port.template,
                     EvalSampleConfig(min_frames=4, max_frames=4))
    for i in range(len(ds)):
        item = ds[i]
        text = "(" + port.generate(item["input_ids"], pixels=item["pixels"],
                                   answer_prompt=MCQ_ANSWER_PROMPT)
        assert recs[item["qid"]]["output_text"] == text, (mode, item["qid"])
    ev.main(argv)  # resume: nothing added
    with open(shard) as f:
        assert len(f.readlines()) == 3
    got = ev.main(["--score_only", "--dataset_name", "mvbench", "--output_dir", out_dir])
    assert got == calc_score(load_scored_data(out_dir, "mvbench"), "mvbench")
    assert got["total"] == 3


def test_transv_checkpoint_loads_its_merge_modules(tmp_path):
    """use_pdrop + a CrossAttention merge module in config.json: the merge
    modules and their alphas come from the checkpoint (the JAX loader
    drops them, tests/test_torch_convert.py)."""
    config = dict(CONFIG, use_pdrop=True, pdrop_type="uni_2_0.8-attn_3_0.6",
                  merge_module="CrossAttention")
    sd = write_checkpoint(tmp_path, config, seed=4)
    model, arch, _ = load_vlm_weights(str(tmp_path), dtype=torch.float32, device="cpu")
    assert arch.llm.use_pdrop and model.merge_modules is not None
    merge = {k: v for k, v in sd.items() if k.startswith("merge_modules.")}
    assert merge and any(k.endswith("alpha") and float(v) != 0.0 for k, v in merge.items())
    got = model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in merge.items())


def test_bf16_load_takes_the_jax_loaders_values(written):
    """ndim >= 2 rounded to bf16, the rest kept in f32 (JAX's cast), each
    stored in the type the port's bf16 module keeps for it."""
    ckpt, sd = written
    model, _, _ = load_vlm_weights(str(ckpt), dtype=torch.bfloat16, device="cpu")
    got = model.state_dict()
    for k, v in sd.items():
        want = v.to(torch.bfloat16 if v.ndim >= 2 else torch.float32).to(got[k].dtype)
        assert torch.equal(got[k], want), k
    assert got["llm_backbone.layers.0.mixer.conv1d.x.weight"].dtype == torch.float32
    assert got["llm_backbone.embeddings.weight"].dtype == torch.bfloat16


class ModelAxisMesh:
    """Rank 0 of a (data 1, seq 1, model 2) mesh, as sharding the weights
    reads it (the collectives run in tests/test_torch_mesh_serve.py)."""

    mesh_dim_names = ("data", "seq", "model")

    def size(self, dim: int = None) -> int:
        return 2 if dim is None else (1, 1, 2)[dim]

    def get_local_rank(self, axis: str) -> int:
        return 0


def test_jax_only_formats_and_options_are_refused(ckpt, tmp_path):
    import timeviper_tpu_torch.eval.evaluate as ev

    # a model axis shards the loaded weights: this rank holds its half of
    # each split leaf, and the Generator runs at the local head counts
    whole = load_pretrained_vlm(str(ckpt), device="cpu").model
    tm = load_pretrained_vlm(str(ckpt), mesh=ModelAxisMesh(), device="cpu")
    llm, cfg = tm.model.llm_backbone, tm.arch.llm
    assert tm.generator.arch.llm.num_attention_heads == cfg.num_attention_heads // 2
    assert llm.embeddings.weight.shape[0] == cfg.vocab_size // 2
    a = llm.layers[cfg.attention_layer_indices[0]].mixer
    w = whole.llm_backbone.layers[cfg.attention_layer_indices[0]].mixer
    assert torch.equal(a.q_proj.weight, w.q_proj.weight[:a.q_proj.weight.shape[0]])
    assert torch.equal(a.o_proj.weight, w.o_proj.weight[:, :a.o_proj.weight.shape[1]])
    # a seq and a model axis together: the next parallelism slice
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 4"):
        ev.main(["--checkpoint", str(ckpt), "--dataset_name", "mvbench", "--output_dir",
                 str(tmp_path / "o"), "--mesh_model", "2", "--mesh_seq", "2",
                 "--device", "cpu"])
    (tmp_path / "orbax").mkdir()
    with open(tmp_path / "config.json", "w") as f:
        json.dump(CONFIG, f)
    with pytest.raises(ValueError, match="orbax"):
        load_vlm_weights(str(tmp_path), device="cpu")
