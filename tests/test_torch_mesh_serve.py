"""Serving on a model axis, the gradient through the sequence-parallel
prefill, and the training CLI on a data axis, on the CPU: one run of two
ranks under torchrun (tests/torch_mesh_ranks.py, gloo; the ranks never
import JAX) while this process computes the references.

* `Generator(mesh=make_mesh(model=2))` on a tiny VLM with the pdrop stages
  "uni_1_0.5-attn_3_0.25" and TransV (alpha 0.7; the attn stage's q_proj
  sharpened x50, so that its scores are not ties of 1/L to 1e-7), for a
  text request, a request with frames and a pdrop request: the JAX
  Generator's greedy tokens, and its prefill's first logits to 2e-3 (the
  JAX sequence-parallel tests' tolerance) of their largest magnitude; one
  `ServingEngine(mesh=)` run gives the one-device engine's tokens; a tiny
  qwen2 VLM (Hq / Hkv 2 / 1 a rank, its q/k/v biases drawn off zero) on the
  text and the frames request gives the one-device port Generator's tokens
  and first logits.
* The seq-2 prefill under autograd (JAX tests/test_seq_parallel.py:79's
  config and loss, the mean square of the last 8 logits, a packed row): the
  loss and every gradient, the ranks' parts psummed over `seq`, against
  JAX's jitted gradient of the unsharded forward at that test's tolerance
  (rtol 5e-3, atol 5e-4); the same for the mean square of the
  `return_hidden` rows.
* `python -m timeviper_tpu_torch.train.cli ... --data_parallel 2 --device
  cpu` under torchrun, two loader workers (the default): rank 0 alone writes
  the final artifacts, they load into a one-device model, and the losses
  are those of the CLI on one process with the same global batches.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mesh_ranks
import torch_seq_ranks as ranks
from torch_parity import n, rng

from timeviper_tpu.config import VLMConfig, tiny_nano_config, tiny_vit_config
from timeviper_tpu.models import generate as jax_gen
from timeviper_tpu.models import nano as jax_nano
from timeviper_tpu.models import vlm as jax_vlm
from timeviper_tpu_torch import config as tcfg
from timeviper_tpu_torch.models.generate import Generator
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch
from timeviper_tpu_torch.params import from_jax_numpy, nano_state_dict
from timeviper_tpu_torch.serving import Request, ServingEngine
from timeviper_tpu_torch.train.checkpoint import restore_params

REPO = Path(__file__).resolve().parent.parent
PDROP = dict(use_pdrop=True, pdrop_type="uni_1_0.5-attn_3_0.25", merge_module="CrossAttention")
IMG = 500
FRAMES = 8
KW = dict(terminator_ids=[-2], pad_token_id=0, max_new_tokens=6)
IDS = [5, 6] + [IMG] * FRAMES + [9, 10, 11]


@functools.lru_cache(maxsize=None)
def _setup():
    vlm = VLMConfig(arch_specifier="tome_mlp-2")
    jllm, tllm = tiny_nano_config(**PDROP), tcfg.tiny_nano_config(**PDROP)
    arch = VLMArch(vlm=vlm, vision=tcfg.tiny_vit_config(), llm=tllm)
    jarch = jax_vlm.VLMArch(vlm=vlm, vision=tiny_vit_config(), llm=jllm, llm_family="nano")
    params = jax.device_get(jax.jit(lambda key: jax_vlm.init_vlm_params(key, jarch, jnp.float32))(
        jax.random.PRNGKey(0)))
    params["merge_modules"] = [dict(m, alpha=np.float32(0.7)) for m in params["merge_modules"]]
    q = params["llm_backbone"]["layers"][3]["mixer"]["q_proj"]
    q["kernel"] = q["kernel"] * 50.0
    model = TimeViperVLM(arch, torch.float32, device="cpu")
    model.load_state_dict(from_jax_numpy(params, arch))
    return arch, jarch, params, model.eval()


def _qwen2_model():
    """A tiny qwen2 VLM of the port, its q/k/v biases drawn off zero."""
    arch = VLMArch(vlm=VLMConfig(arch_specifier="tome_mlp-2"), vision=tcfg.tiny_vit_config(),
                   llm=tcfg.tiny_qwen2_config(), llm_family="qwen2")
    model = TimeViperVLM(arch, torch.float32, device="cpu")
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.normal_(0.0, 0.5 if name.endswith("_proj.bias") else 0.05, generator=g)
    return arch, model.eval()


def _requests(pixels):
    return {"text": dict(input_ids=rng(3).integers(1, 400, 9).tolist()),
            "frames": dict(input_ids=IDS, pixels=pixels, image_token_id=IMG),
            "pdrop": dict(input_ids=IDS, pixels=pixels, image_token_id=IMG, use_pdrop=True)}


def _engine_requests(pixels):
    r = rng(4)
    return [dict(input_ids=r.integers(1, 400, 9).tolist(), max_new_tokens=5),
            dict(input_ids=IDS, pixels=pixels, image_token_id=IMG, max_new_tokens=6),
            dict(input_ids=r.integers(1, 400, 30).tolist(), max_new_tokens=4)]


def _jax_first(jg, params, req):
    plan, bucket, pad, ids_arr, gidx, seq = jg._plan_prompt(req["input_ids"], IMG)
    visual = (jg.encode_frames(req["pixels"]) if "pixels" in req
              else jnp.zeros((0, jg.arch.llm.hidden_size), jnp.float32))
    args = (params, jnp.asarray(ids_arr), jnp.asarray(gidx), jnp.asarray(seq), visual, pad)
    if req.get("use_pdrop"):
        vs = plan.sample_layouts[0][0]
        first, _ = jg._get_prefill_pdrop(bucket, bucket + KW["max_new_tokens"], plan.num_visual)(
            *args, jnp.asarray(pad + vs, jnp.int32), jnp.asarray(bucket - 1, jnp.int32))
    else:
        first, _ = jg._get_prefill(bucket, bucket + KW["max_new_tokens"])(*args)
    return np.asarray(first)


# -- the sequence-parallel gradient --------------------------------------------


def _seq_grad_inputs():
    cfg = tiny_nano_config(num_hidden_layers=4, hybrid_override_pattern="M-*-")
    params = jax.device_get(jax.jit(jax_nano.init_nano_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(7), cfg, jnp.float32))
    embeds = np.asarray(jax.random.normal(jax.random.PRNGKey(8), (1, 32, cfg.hidden_size)))
    seq_idx = np.asarray([[0] * 13 + [1] * 19], np.int32)
    return cfg, params, embeds, seq_idx


def _seq_grad_refs(cfg, params, embeds, seq_idx):
    def fwd(p):
        return jax_nano.nano_forward(p, cfg, inputs_embeds=embeds, seq_idx=seq_idx)

    def loss(p):
        return jnp.mean(fwd(p)["logits"][:, -8:].astype(jnp.float32) ** 2)

    def loss_h(p):
        return jnp.mean(fwd(p)["hidden_states"].astype(jnp.float32) ** 2)

    out = {"loss": float(jax.jit(loss)(params))}
    for tag, f in (("grads", loss), ("hidden_grads", loss_h)):
        out[tag] = nano_state_dict(jax.device_get(jax.jit(jax.grad(f))(params)), cfg)
    return out


# -- the CLI --------------------------------------------------------------------


def _cli_setup(folder: Path):
    import test_torch_train_cli as cli_tests

    cli_tests._make_tokenizer(folder)
    entries = []
    for name, frames in (("a", 2), ("b", 4)):
        items = [{"video": f"{name}{i}.mp4", "conversations": [
            {"from": "human", "value": "what color is the sky ."},
            {"from": "gpt", "value": "blue ." if i % 2 else "red ."}]} for i in range(3)]
        (folder / f"{name}.json").write_text(json.dumps(items))
        entries.append(f"  - format: conversation\n    json_path: {folder / f'{name}.json'}\n"
                       f"    sampling: uniform\n    num_frames: {frames}\n")
    (folder / "data.yaml").write_text("datasets:\n" + "".join(entries))
    return ["--data_config", str(folder / "data.yaml"), "--vision_backbone_id", "debug-vit-tiny",
            "--llm_backbone_id", "debug-nano-tiny", "--arch_specifier", "tome_mlp-2",
            "--tokenizer_path", str(folder), "--log_every", "1",
            "--device", "cpu", "--batch_size", "2", "--max_steps", "3", "--save_every", "10",
            "--learning_rate", "1e-3"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    folder = tmp_path_factory.mktemp("mesh_serve")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         str(REPO / "tests" / "torch_mesh_ranks.py"), str(folder)],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        arch, jarch, params, model = _setup()
        pixels = rng(1).random((FRAMES, 28, 28, 3), np.float32)
        cfg, sparams, embeds, seq_idx = _seq_grad_inputs()
        argv = _cli_setup(folder)
        mesh_argv = argv + ["--run_dir", str(folder / "cli_mesh"), "--data_parallel", "2"]
        one = subprocess.Popen(  # the CLI on one process, beside this one's references
            [sys.executable, str(REPO / "tests" / "torch_mesh_ranks.py"), "--one", str(folder)]
            + argv + ["--run_dir", str(folder / "cli_one")], cwd=str(REPO), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        qarch, qwen2 = _qwen2_model()
        ranks.save_inputs(
            str(folder), arch=arch, state=model.state_dict(), gen_kw=KW,
            qwen2_arch=qarch, qwen2_state=qwen2.state_dict(), requests=_requests(pixels),
            engine_kw=dict(terminator_ids=[-2], num_slots=2, max_len=160),
            engine_requests=_engine_requests(pixels),
            seq_grad={"cfg": torch_mesh_ranks.seq_grad_config(),
                      "state": nano_state_dict(sparams, cfg), "embeds": embeds,
                      "seq_idx": seq_idx},
            cli_argv=mesh_argv)
        jg = jax_gen.Generator(params, jarch, cache_dtype=jnp.float32, **KW)
        want = {"gen": {name: (jg.generate(**req).token_ids, _jax_first(jg, params, req))
                        for name, req in _requests(pixels).items()}}
        qgen = Generator(qwen2, qarch, **KW)
        want["qwen2"] = {}
        for name in ("text", "frames"):
            res = qgen.generate(**_requests(pixels)[name])
            want["qwen2"][name] = (res.token_ids, res.first_logits)
        eng = ServingEngine(model, arch, cache_dtype=torch.float32,
                            terminator_ids=[-2], num_slots=2, max_len=160)
        want["engine"] = [r.output_ids for r in eng.run(
            [Request(request_id=i, **r) for i, r in enumerate(_engine_requests(pixels))])]
        want["seq_grad"] = _seq_grad_refs(cfg, sparams, embeds, seq_idx)
        log, _ = proc.communicate(timeout=600)
        one_log, _ = one.communicate(timeout=600)
    except BaseException:
        open(folder / "abort", "w").close()
        proc.kill()
        if "one" in locals():
            one.kill()
        raise
    if proc.returncode:
        errs = "".join(p.read_text() for p in folder.glob("rank*.err"))
        raise RuntimeError(errs or log.decode()[-4000:])
    if one.returncode:
        raise RuntimeError(one_log.decode()[-4000:])
    want["cli_losses"] = torch.load(folder / "cli_one.pt")["losses"].tolist()
    got = [torch.load(folder / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return arch, folder, got, want


def _close(got, want, tol, what):
    got, want = n(got), n(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err <= tol, (what, err)


@pytest.mark.parametrize("name", ["text", "frames", "pdrop"])
def test_generator_on_model2_matches_jax_generator(run, name):
    arch, _, got, want = run
    tokens, first = want["gen"][name]
    for r in range(2):
        mine = got[r]["serve"]
        assert mine["heads"] == arch.llm.num_attention_heads // 2
        assert mine[name]["tokens"].tolist() == tokens.tolist(), (name, r)
        _close(mine[name]["first"], first, 2e-3, f"{name} first logits, rank {r}")
    assert not np.allclose(n(got[0]["serve"]["frames"]["first"]),
                           n(got[0]["serve"]["pdrop"]["first"]))


@pytest.mark.parametrize("name", ["text", "frames"])
def test_qwen2_generator_on_model2_matches_one_device(run, name):
    _, _, got, want = run
    tokens, first = want["qwen2"][name]
    for r in range(2):
        mine = got[r]["serve"]["qwen2"]
        assert mine["heads"] == (2, 1)
        assert mine[name]["tokens"].tolist() == tokens.tolist(), (name, r)
        _close(mine[name]["first"], first, 2e-3, f"qwen2 {name} first logits, rank {r}")


def test_serving_engine_on_model2_matches_one_device(run):
    _, _, got, want = run
    assert [len(t) for t in want["engine"]] == [5, 6, 4]
    for r in range(2):
        assert got[r]["serve"]["engine"] == want["engine"]


@pytest.mark.parametrize("tag", ["grads", "hidden_grads"])
def test_seq2_prefill_gradient_matches_jax(run, tag):
    _, _, got, want = run
    ref = want["seq_grad"]
    for r in range(2):
        mine = got[r]["seq_grad"]
        np.testing.assert_allclose(float(mine["loss"]), ref["loss"], rtol=5e-3)
        assert set(mine[tag]) == set(ref[tag])
        for k, w in ref[tag].items():
            np.testing.assert_allclose(n(mine[tag][k]), n(w), rtol=5e-3, atol=5e-4,
                                       err_msg=f"{tag} {k}")


@pytest.mark.parametrize("n_spans,my,segs,valid", [
    (2, 1, True, True), (3, 2, True, False), (3, 1, False, False), (2, 0, True, True)])
def test_span_attention_gradient_is_dense_attentions(n_spans, my, segs, valid):
    """SpanAttnFn (the sharded prefill's attention under autograd: K9's parts
    forward, K2-bwd's causal mode over the span's block and its non-causal
    mode, a segment at a time, over the keys left of it, given the merged
    output and row log-sum-exp) against autograd through dense attention
    over the row's first (my + 1) spans, f32 on the CPU."""
    from timeviper_tpu_torch.ops.attention import attention
    from timeviper_tpu_torch.ops.block_attention import fold_segments
    from timeviper_tpu_torch.parallel.seq_parallel import SpanAttnFn

    B, L, Hq, Hkv, D = 2, 24, 4, 2, 16
    Lloc = L // n_spans
    lo = my * Lloc
    r = rng(9)
    q, kg, vg = (torch.from_numpy(r.standard_normal((B, m, h, D)).astype(np.float32))
                 .requires_grad_() for m, h in ((Lloc, Hq), (L, Hkv), (L, Hkv)))
    seq = (torch.tensor([[0] * 5 + [1] * 10 + [2] * 9, [0] * 11 + [1] * 13], dtype=torch.int32)
           if segs else None)
    kv_valid = None
    if valid:
        kv_valid = torch.arange(L) >= 3
        kv_valid[17] = False
    seg = fold_segments(B, L, L, valid_kv=kv_valid, valid_q=kv_valid, seg_q=seq, seg_kv=seq)[0]
    dout = torch.from_numpy(r.standard_normal((B, Lloc, Hq, D)).astype(np.float32))
    out = SpanAttnFn.apply(q, kg, vg, lo, seg)
    got = torch.autograd.grad(out, (q, kg, vg), dout)
    mask = (torch.arange(lo, lo + Lloc)[:, None] >= torch.arange(L)[None])[None]
    if seg is not None:
        mask = mask & (seg[:, lo:lo + Lloc, None] == seg[:, None, :])
    ref = attention(q, kg, vg, mask)
    want = torch.autograd.grad(ref, (q, kg, vg), dout)
    np.testing.assert_allclose(n(out), n(ref), rtol=1e-5, atol=1e-5)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(n(g), n(w), rtol=1e-5, atol=1e-5, err_msg=name)


def test_train_cli_data2_writes_its_artifacts_once(run):
    arch, folder, got, want = run
    final = folder / "cli_mesh" / "final"
    assert sorted(os.listdir(final)) == ["config.json", "meta.json", "params"]
    log = (folder / "cli_mesh" / "train.log").read_text()
    assert log.count("step 3 | loss") == 1
    for r in range(2):
        np.testing.assert_allclose(n(got[r]["cli"]["losses"]), want["cli_losses"], rtol=1e-4)
    # the gathered artifacts load into a one-device model
    from timeviper_tpu_torch.models.api import build_arch
    from timeviper_tpu_torch.models.vlm import init_vlm_params

    tarch = build_arch(tcfg.VLMConfig(vision_backbone_id="debug-vit-tiny",
                                      llm_backbone_id="debug-nano-tiny",
                                      arch_specifier="tome_mlp-2"))
    model = init_vlm_params(tarch, torch.Generator().manual_seed(0), torch.float32, device="cpu")
    model.load_state_dict(restore_params(str(final / "params")))
