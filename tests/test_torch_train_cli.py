"""The port's training CLI (train/cli.py) end to end on the CPU, as the JAX
package's tests/test_train_cli.py runs its own: a tokenizer, a data JSON and
a YAML data config written by the test, frames from a stand-in for
`data.video.load_video`, a tiny model (debug-vit-tiny, debug-nano-tiny).

The YAML lists two datasets of 2 and 4 frames a video, so a batch of 2 can
be heterogeneous (rows with other layouts, data/loader.py:collate_hetero).
Checked: the flags are the JAX CLI's plus --device; without a card and
without --device it raises; --data_parallel above 1 raises; full training
writes checkpoints, the final params, meta.json, config.json and train.log,
and a second run resumes from the last checkpoint; QLoRA (the tiny model's
linears are all under quantize_params_int8's min_size, as in the JAX test;
tests/test_torch_qlora.py quantizes) moves lora_b off zero, records
`lora.quantized_base: true`, writes lora_state.npz whose factors equal the
final params bitwise, and keeps a projector warm-started from a params
directory as it was (frozen under LoRA).
"""

import json
import os
import re

import numpy as np
import pytest
import torch

import timeviper_tpu_torch.data.video as video_mod
from timeviper_tpu_torch.train import cli
from timeviper_tpu_torch.train.checkpoint import restore_params, save_params


def _make_tokenizer(path):
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    words = ("<pad> <unk> <SPECIAL_10> <SPECIAL_11> <SPECIAL_12> System User Assistant . "
             "what color is the sky blue red").split()
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>", unk_token="<unk>",
                            eos_token="<SPECIAL_12>").save_pretrained(str(path))


def _fake_load_video(path, *, num_frames=None, **kw):
    r = np.random.default_rng(abs(hash(path)) % 2**31)
    frames = r.integers(0, 255, (num_frames, 28, 28, 3), dtype=np.uint8)
    return frames, np.arange(num_frames) / 1.0, video_mod.VideoMeta(num_frames, 1.0,
                                                                   float(num_frames))


@pytest.fixture
def setup(tmp_path, monkeypatch):
    monkeypatch.setattr(video_mod, "load_video", _fake_load_video)
    _make_tokenizer(tmp_path)
    entries = []
    for name, frames in (("a", 2), ("b", 4)):
        items = [{"video": f"{name}{i}.mp4", "conversations": [
            {"from": "human", "value": "what color is the sky ."},
            {"from": "gpt", "value": "blue ." if i % 2 else "red ."}]} for i in range(3)]
        jpath = tmp_path / f"{name}.json"
        jpath.write_text(json.dumps(items))
        entries.append(f"  - format: conversation\n    json_path: {jpath}\n"
                       f"    sampling: uniform\n    num_frames: {frames}\n")
    ypath = tmp_path / "data.yaml"
    ypath.write_text("datasets:\n" + "".join(entries))
    return tmp_path, ["--data_config", str(ypath), "--vision_backbone_id", "debug-vit-tiny",
                      "--llm_backbone_id", "debug-nano-tiny", "--arch_specifier", "tome_mlp-2",
                      "--tokenizer_path", str(tmp_path), "--num_workers", "1",
                      "--log_every", "1", "--device", "cpu"]


def _flags(get_args, capsys):
    with pytest.raises(SystemExit):
        get_args(["--help"])
    return set(re.findall(r"(?<![\w-])--[a-z_]+", capsys.readouterr().out))


def test_help_lists_every_jax_flag_and_device(capsys):
    from timeviper_tpu.train.cli import get_args as jax_get_args

    want = _flags(jax_get_args, capsys)
    assert "--lora_quantize_base" in want and len(want) > 30
    assert _flags(cli.get_args, capsys) == want | {"--device"}


def test_it_raises_without_a_card_or_a_device(setup):
    tmp, argv = setup
    no_device = [a for a in argv if a not in ("--device", "cpu")]
    # a data axis takes ranks: one process has no group to build the mesh
    # from (the 2-rank run: tests/test_torch_mesh_serve.py)
    with pytest.raises(RuntimeError, match="process group"):
        cli.main(argv + ["--data_parallel", "2", "--run_dir", str(tmp / "mesh")])
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(no_device + ["--run_dir", str(tmp / "none")])
    assert not (tmp / "none").exists()


def test_train_cli_end_to_end_and_resume(setup):
    tmp, argv = setup
    run = str(tmp / "run")
    base = argv + ["--run_dir", run, "--batch_size", "2", "--save_every", "2",
                   "--learning_rate", "1e-3", "--remat_policy", "scan"]
    trainer = cli.main(base + ["--max_steps", "3"])
    assert trainer.step == 3 and [h["step"] for h in trainer.history] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    assert sorted(os.listdir(run)) == ["checkpoint-2", "final", "train.log"]
    final = os.path.join(run, "final")
    assert sorted(os.listdir(final)) == ["config.json", "meta.json", "params"]
    cfg = json.load(open(os.path.join(final, "config.json")))
    assert cfg == json.load(open(os.path.join(final, "meta.json")))
    assert cfg["llm_backbone_id"] == "debug-nano-tiny" and cfg["use_pdrop"] is False
    params = restore_params(os.path.join(final, "params"))
    assert torch.equal(params["projector.fc1.weight"], trainer.model.projector.fc1.weight)
    assert "step 3 | loss" in open(os.path.join(run, "train.log")).read()
    # a second run resumes at the last checkpoint (step 2) and goes on to 4
    again = cli.main(base + ["--max_steps", "4"])
    assert [h["step"] for h in again.history] == [3, 4]


def test_train_cli_qlora(setup):
    tmp, argv = setup
    run = str(tmp / "run_qlora")
    warm = {k: v * 0 + 0.01 for k, v in _projector_state().items()}
    save_params(str(tmp / "warm"), {f"projector.{k}": v for k, v in warm.items()})
    trainer = cli.main(argv + ["--run_dir", run, "--batch_size", "1", "--max_steps", "2",
                               "--save_every", "10", "--learning_rate", "1e-2",
                               "--lora_enable", "--lora_r", "4", "--lora_quantize_base",
                               "--projector_checkpoint", str(tmp / "warm")])
    final = os.path.join(run, "final")
    cfg = json.load(open(os.path.join(final, "config.json")))
    assert cfg["lora"] == {"r": 4, "alpha": 16.0, "quantized_base": True}
    sd = np.load(os.path.join(final, "lora_state.npz"))
    dtypes = json.load(open(os.path.join(final, "lora_state.dtypes.json")))
    params = restore_params(os.path.join(final, "params"))
    assert set(sd.files) == set(dtypes) == {k for k in params if ".lora_" in k}
    assert [k for k in sd.files if k.endswith("lora_b") and np.abs(sd[k]).sum() > 0]
    for k in sd.files:
        assert torch.equal(torch.from_numpy(sd[k]).to(params[k].dtype), params[k]), k
        assert dtypes[k] == str(params[k].dtype).replace("torch.", "")
    for k, v in warm.items():
        assert torch.equal(trainer.model.projector.state_dict()[k], v.to(torch.float32)), k


def _projector_state():
    """A projector's state dict of the test's model, for a warm start."""
    from timeviper_tpu_torch.config import VLMConfig
    from timeviper_tpu_torch.models.api import build_arch
    from timeviper_tpu_torch.models.vlm import TimeViperVLM

    arch = build_arch(VLMConfig(vision_backbone_id="debug-vit-tiny",
                                llm_backbone_id="debug-nano-tiny", arch_specifier="tome_mlp-2"))
    return TimeViperVLM(arch, torch.float32, device="cpu").projector.state_dict()


def test_train_cli_pdrop_transv(setup):
    """--use_pdrop with TransV on one-row batches (pdrop refuses
    heterogeneous ones, as the JAX package does): the merge modules train
    with the projector and LoRA, and the pdrop settings reach config.json."""
    tmp, argv = setup
    run = str(tmp / "run_pdrop")
    trainer = cli.main(argv + ["--run_dir", run, "--batch_size", "1", "--max_steps", "2",
                               "--learning_rate", "1e-2", "--use_pdrop", "--pdrop_type",
                               "uni_1_0.75-attn_3_0.5", "--merge_module", "CrossAttention",
                               "--lora_enable", "--trainable_modules", "projector,merge"])
    assert trainer.step == 2 and trainer.model.merge_modules is not None
    assert any(n.startswith("merge_modules.") for n in trainer.opt.params)
    cfg = json.load(open(os.path.join(run, "final", "config.json")))
    assert (cfg["use_pdrop"], cfg["pdrop_type"], cfg["merge_module"]) == (
        True, "uni_1_0.75-attn_3_0.5", "CrossAttention")


@pytest.mark.parametrize("form", ["reference .bin", "params directory", "orbax directory"])
def test_projector_warm_start(tmp_path, form):
    """--projector_checkpoint: a reference torch file (projector.projector.<i>
    keys, train/convert.py), a params directory of save_params, or, refused,
    a directory without params.pt (the JAX package's orbax format)."""
    from timeviper_tpu_torch.config import VLMConfig
    from timeviper_tpu_torch.models.api import build_arch
    from timeviper_tpu_torch.models.vlm import TimeViperVLM

    arch = build_arch(VLMConfig(vision_backbone_id="debug-vit-tiny",
                                llm_backbone_id="debug-nano-tiny", arch_specifier="tome_mlp-2"))
    model = TimeViperVLM(arch, torch.float32, device="cpu")
    want = {k: torch.full_like(v, 0.25 + i) for i, (k, v) in
            enumerate(model.projector.state_dict().items())}
    if form == "reference .bin":
        ref = {}
        for i, name in ((0, "fc1"), (2, "fc2")):
            ref[f"projector.projector.{i}.weight"] = want[f"{name}.weight"]
            ref[f"projector.projector.{i}.bias"] = want[f"{name}.bias"]
        path = str(tmp_path / "projector.bin")
        torch.save(ref, path)
    else:
        path = str(tmp_path / "warm")
        if form == "params directory":
            save_params(path, {f"projector.{k}": v for k, v in want.items()})
        else:
            os.makedirs(os.path.join(path, "orbax"))
            with pytest.raises(ValueError, match="params.pt"):
                cli._load_projector(model, path)
            return
    cli._load_projector(model, path)
    for k, v in model.projector.state_dict().items():
        assert torch.equal(v, want[k]), k
