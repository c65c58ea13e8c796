"""Rank work of the port's tensor, data and FSDP parallelism on the CPU, for
tests/test_torch_mesh_train.py (four ranks from `torch_seq_ranks.running`)
and tests/test_torch_mesh_serve.py (two ranks under torchrun: run this file
as a script; `--one folder argv...` runs the training CLI's one-process
reference). A rank imports torch and the port, never JAX; the parent
writes the inputs to a folder and reads back each rank's result dict.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_seq_ranks import build_model, load_inputs  # noqa: E402


def _batch(cb, device="cpu"):
    from timeviper_tpu_torch.data.loader import to_device

    return to_device(cb.batch, torch.device(device))


def _lora_model(inp):
    from timeviper_tpu_torch.models.vlm import TimeViperVLM
    from timeviper_tpu_torch.train.lora import add_lora

    model = TimeViperVLM(inp["arch"], torch.float32, device="cpu")
    add_lora(model, rank=4, alpha=8.0, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(inp["lora_state"])
    return model


def _trainer_run(inp, mesh, model, lora: bool, run_dir: str) -> dict:
    """First-step gradients (whole), then the Trainer's steps on the batches
    (the first batch alone under LoRA); the checkpoint written at the end,
    and the whole parameters."""
    from timeviper_tpu_torch.train.optim import OptimConfig
    from timeviper_tpu_torch.train.step import grad_step
    from timeviper_tpu_torch.train.trainer import Trainer, TrainerConfig

    batches = inp["batches"][:1] if lora else inp["batches"]
    cfg = TrainerConfig(run_dir=run_dir, max_steps=len(batches), log_every=1,
                        save_every=100, data_parallel=2, model_parallel=2, resume=False,
                        lora=lora, trainable_modules="projector" if lora else None)
    tr = Trainer(inp["arch"], model, OptimConfig(**inp["opt"]), cfg, device="cpu", mesh=mesh)
    cb = batches[0]
    _, grads = grad_step(tr.model, tr.step_arch, tr.opt.params, tr._rows(_batch(cb)), cb.plan,
                         remat=True, layout=tr.layout)
    out = {"grads": tr.layout.full_state(grads)}
    tr.train(iter(batches))
    out["losses"] = torch.tensor([h["loss"] for h in tr.history])
    out["ckpt"] = tr.save()
    out["params"] = tr.state()["params"]
    return out


def _first_grads(model, arch, mesh, cb):
    """The first step's gradients of every parameter on a mesh (FSDP on),
    gathered whole, and the layout."""
    from timeviper_tpu_torch.parallel.tensor_parallel import shard_model, split_rows
    from timeviper_tpu_torch.train.step import grad_step, trainable_params

    layout = shard_model(model, arch, mesh, fsdp_params=True)
    params = trainable_params(model, False)
    _, grads = grad_step(model, layout.arch, params, split_rows(_batch(cb), mesh), cb.plan,
                         remat=True, layout=layout)
    return layout.full_state(grads), layout


def train(rank: int, _mesh, folder: str) -> dict:
    """On (data 2, model 2) with FSDP: the full and the LoRA Trainer, and
    qwen2's first-step gradients; on (1, 1, 4), where the tiny config's KV
    heads and groups do not divide, the first-step gradients."""
    from timeviper_tpu_torch.models.vlm import TimeViperVLM
    from timeviper_tpu_torch.parallel.sharding import make_mesh

    inp = load_inputs(folder)
    mesh = make_mesh(data=2, model=2)
    out = {"full": _trainer_run(inp, mesh, build_model(inp), False,
                                os.path.join(folder, "run_full")),
           "lora": _trainer_run(inp, mesh, _lora_model(inp), True,
                                os.path.join(folder, "run_lora"))}
    qwen2 = TimeViperVLM(inp["qwen2_arch"], torch.float32, device="cpu")
    qwen2.load_state_dict(inp["qwen2_state"])
    grads, layout = _first_grads(qwen2, inp["qwen2_arch"], mesh, inp["batches"][0])
    out["qwen2"] = {"grads": grads, "heads": (layout.arch.llm.num_attention_heads,
                                              layout.arch.llm.num_key_value_heads)}
    grads, layout = _first_grads(build_model(inp), inp["arch"], make_mesh(model=4),
                                 inp["batches"][0])
    out["tp4"] = {"grads": grads,
                  "whole": [n for n, lf in layout.leaves.items() if lf.model_dim is None]}
    return out if rank == 0 else {"losses": out["full"]["losses"]}


# ---------------------------------------------------------------------------
# tests/test_torch_mesh_serve.py, under torchrun
# ---------------------------------------------------------------------------


def _serve(inp) -> dict:
    from timeviper_tpu_torch.models.generate import Generator
    from timeviper_tpu_torch.parallel.sharding import make_mesh
    from timeviper_tpu_torch.serving import Request, ServingEngine

    mesh = make_mesh(model=2)
    model = build_model(inp)
    gen = Generator(model, inp["arch"], mesh=mesh, **inp["gen_kw"])
    out = {"heads": gen.arch.llm.num_attention_heads}
    for name, req in inp["requests"].items():
        res = gen.generate(**req)
        out[name] = {"tokens": torch.from_numpy(res.token_ids), "first": res.first_logits}
    eng = ServingEngine(model, inp["arch"], mesh=mesh, cache_dtype=torch.float32,
                        **inp["engine_kw"])
    out["engine"] = [r.output_ids for r in eng.run(
        [Request(request_id=i, **r) for i, r in enumerate(inp["engine_requests"])])]
    qwen2 = build_model({"arch": inp["qwen2_arch"], "state": inp["qwen2_state"]})
    gen = Generator(qwen2, inp["qwen2_arch"], mesh=mesh, **inp["gen_kw"])
    out["qwen2"] = {"heads": (gen.arch.llm.num_attention_heads,
                              gen.arch.llm.num_key_value_heads)}
    for name in ("text", "frames"):
        res = gen.generate(**inp["requests"][name])
        out["qwen2"][name] = {"tokens": torch.from_numpy(res.token_ids),
                              "first": res.first_logits}
    return out


def _seq_grad(inp) -> dict:
    """The gradient of the JAX test's loss (the mean square of the last 8
    logits) and of the mean square of the hidden rows, through the seq-2
    prefill; each rank's part, psummed over `seq`."""
    from timeviper_tpu_torch.models.nano import NanoModel
    from timeviper_tpu_torch.parallel.seq_parallel import nano_prefill_seq_parallel
    from timeviper_tpu_torch.parallel.sharding import make_mesh, psum

    mesh = make_mesh(seq=2)
    sg = inp["seq_grad"]
    cfg = sg["cfg"]
    llm = NanoModel(cfg, torch.float32, device="cpu")
    llm.load_state_dict(sg["state"])
    emb, seq_idx = torch.from_numpy(sg["embeds"]), torch.from_numpy(sg["seq_idx"])
    out = {}
    names = [n for n, _ in llm.named_parameters()]
    logits = nano_prefill_seq_parallel(llm, cfg, emb, mesh, logits_to_keep=8, seq_idx=seq_idx)
    loss = logits.float().square().mean()
    g = torch.autograd.grad(loss, [p for _, p in llm.named_parameters()], allow_unused=True)
    out["loss"] = loss.detach()
    out["grads"] = {n: psum(x if x is not None else torch.zeros_like(p), mesh, "seq")
                    for n, x, p in zip(names, g, llm.parameters())}
    _, hidden = nano_prefill_seq_parallel(llm, cfg, emb, mesh, logits_to_keep=8,
                                          seq_idx=seq_idx, return_hidden=True)
    loss_h = hidden.float().square().sum() / (emb.shape[0] * emb.shape[1] * emb.shape[2])
    g = torch.autograd.grad(loss_h, [p for _, p in llm.named_parameters()], allow_unused=True)
    out["hidden_grads"] = {n: psum(x if x is not None else torch.zeros_like(p), mesh, "seq")
                           for n, x, p in zip(names, g, llm.parameters())}
    return out


def _cli(argv) -> dict:
    """`train.cli.main(argv)` with a stand-in video decoder; the losses."""
    from timeviper_tpu_torch.train import cli

    import timeviper_tpu_torch.data.video as video_mod

    def load_video(path, *, num_frames=None, **kw):
        r = np.random.default_rng(sum(map(ord, os.path.basename(path))))
        frames = r.integers(0, 255, (num_frames, 28, 28, 3), dtype=np.uint8)
        return frames, np.arange(num_frames) / 1.0, video_mod.VideoMeta(
            num_frames, 1.0, float(num_frames))

    video_mod.load_video = load_video
    trainer = cli.main(argv)
    return {"losses": torch.tensor([h["loss"] for h in trainer.history])}


def serve_main(folder: str) -> None:
    """One torchrun rank: the Generator (nano and qwen2) and the engine on a
    model axis of 2, the gradient through the seq-2 prefill, the training CLI on a data axis
    of 2; writes rank<r>.pt (or rank<r>.err) in the folder."""
    import traceback

    import torch.distributed as dist

    from timeviper_tpu_torch.utils.dist import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed("gloo")
    rank = dist.get_rank()
    try:
        inp = load_inputs(folder)
        out = {"serve": _serve(inp), "seq_grad": _seq_grad(inp), "cli": _cli(inp["cli_argv"])}
        torch.save(out, os.path.join(folder, f"rank{rank}.pt"))
    except Exception:
        with open(os.path.join(folder, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def seq_grad_config():
    """The JAX test's config (tests/test_seq_parallel.py:79)."""
    from timeviper_tpu_torch.config import tiny_nano_config

    return tiny_nano_config(num_hidden_layers=4, hybrid_override_pattern="M-*-")


if __name__ == "__main__":
    if sys.argv[1] == "--one":  # the CLI's one-process reference run: --one folder argv...
        torch.set_num_threads(1)
        torch.save(_cli(sys.argv[3:]), os.path.join(sys.argv[2], "cli_one.pt"))
    else:
        serve_main(sys.argv[1])
