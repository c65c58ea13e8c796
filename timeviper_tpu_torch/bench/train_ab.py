"""LoRA training steps of TimeViper-9B on the card, as chip_smoke.py's
training phase runs them (all 52 layers, random bf16 weights from a seed,
LoRA rank 8 on the backbone's linears and the projector unfrozen, remat
"full"), timed so that two trees of the package can be compared in one run:

    python -m timeviper_tpu_torch.bench.train_ab [--steps N] [--pdrop]

or, for another checkout of the package, with that checkout first on the path:

    PYTHONPATH=<checkout> python timeviper_tpu_torch/bench/train_ab.py [--steps N] [--pdrop]

Rows: 64 frames and 40 text tokens (1,064 tokens), and 256 frames (4,136).
After one warm-up step on each, N steps of each (4 by default) are timed by
the host clock from a synchronize to the synchronize after the step's loss
is read (`<len>_step_s`). Then one step of each runs under torch.profiler:
its wall time, the device's busy time, and the device time of the SSD
kernels' passes (K4's by their argument struct BwdArgs, K1's by SsdArgs).
The JSON object names the card, its power limit, the versions and the
package's path.

`--pdrop` times the same LoRA steps with the JAX package's pdrop setting on
the 9B (bench_all.py:377: "uni_14_0.8-attn_18_0.6", CrossAttention): the
merge modules drawn from a generator of their own with tanh(alpha) = 0.5,
trained with the projector (trainable_modules "projector,merge", use_pdrop),
the rows' first 12 text tokens after the frames unlabelled (the question
that the "attn" stage ranks by). The profile then also gives the device time
of K2-bwd's non-causal mode (TransV's backward, `k2_bwd_noncausal_ms`).
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import tempfile
import time

import torch

import timeviper_tpu_torch
from timeviper_tpu_torch.bench import device_info
from timeviper_tpu_torch.config import VLMConfig
from timeviper_tpu_torch.data.fusion import IGNORE_INDEX
from timeviper_tpu_torch.data.loader import collate
from timeviper_tpu_torch.device import resolve_device
from timeviper_tpu_torch.models.api import build_arch
from timeviper_tpu_torch.models.pdrop import init_merge_modules
from timeviper_tpu_torch.models.vlm import init_vlm_params
from timeviper_tpu_torch.train.lora import add_lora
from timeviper_tpu_torch.train.optim import OptimConfig
from timeviper_tpu_torch.train.trainer import Trainer, TrainerConfig

IMAGE_TOKEN = 131000  # an id inside the 131072 vocabulary that no text id uses
SEED = 0
PDROP = dict(use_pdrop=True, pdrop_type="uni_14_0.8-attn_18_0.6", merge_module="CrossAttention")
QUESTION = 12  # unlabelled text tokens after the frames with --pdrop


def _row(arch, n_frames: int, g: torch.Generator, device, question: int = 0):
    """One row as chip_smoke.py collates it: 8 text tokens, the frames, 32
    text tokens, with labels on those last 32 but the first `question`."""
    text = torch.randint(10, 130000, (40,), generator=g, device=device).tolist()
    ids = text[:8] + [IMAGE_TOKEN] * n_frames + text[8:]
    labels = [IGNORE_INDEX] * (8 + n_frames + question) + text[8 + question:]
    size = arch.vision.image_size
    pixels = torch.rand(n_frames, size, size, 3, generator=g, device=device) * 2 - 1
    return collate([{"input_ids": torch.tensor(ids).numpy(),
                     "labels": torch.tensor(labels).numpy(), "pixels": pixels.cpu().numpy()}],
                   IMAGE_TOKEN, arch.tokens_per_frame)


def _profiled(step) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return {"wall_ms": wall, "busy_ms": sum(ms for _, ms in rows),
            "k4_ms": sum(ms for k, ms in rows if "BwdArgs" in k),
            "k1_ms": sum(ms for k, ms in rows if "SsdArgs" in k),
            "k2_bwd_noncausal_ms": sum(ms for k, ms in rows
                                       if "BwdParams" in k and "kernel<false>" in k)}


def run(device=None, steps: int = 4, pdrop: bool = False) -> dict:
    device = resolve_device(device)
    res = dict(device_info(device), package=str(timeviper_tpu_torch.__path__[0]), pdrop=pdrop)
    arch = build_arch(VLMConfig())
    model = init_vlm_params(arch, torch.Generator(device=device).manual_seed(SEED),
                            dtype=torch.bfloat16)
    add_lora(model, rank=8, alpha=16.0,
             generator=torch.Generator(device=device).manual_seed(SEED + 2))
    trainable = "projector"
    if pdrop:
        arch = dataclasses.replace(arch, llm=dataclasses.replace(arch.llm, **PDROP))
        model.merge_modules = init_merge_modules(arch.llm, torch.bfloat16, device)
        model.merge_modules.reset_parameters(
            torch.Generator(device=device).manual_seed(SEED + 8))
        with torch.no_grad():
            for mm in model.merge_modules.values():
                mm.alpha.fill_(math.atanh(0.5))
        trainable = "projector,merge"
    g = torch.Generator(device=device).manual_seed(SEED + 3)
    question = QUESTION if pdrop else 0
    rows = {"1064": _row(arch, 64, g, device, question),
            "4136": _row(arch, 256, g, device, question)}
    opt_cfg = OptimConfig(learning_rate=1e-3, schedule="constant", max_grad_norm=1.0)
    with tempfile.TemporaryDirectory() as run_dir:
        cfg = TrainerConfig(run_dir=run_dir, max_steps=10**9, log_every=1, save_every=10**9,
                            lora=True, trainable_modules=trainable, use_pdrop=pdrop,
                            remat="full", resume=False)
        trainer = Trainer(arch, model, opt_cfg, cfg, device=device)

        def step(cb):
            float(trainer.train_step(cb)["loss"])

        for name, cb in rows.items():
            if cb.plan.fused_len != int(name):
                raise AssertionError(f"row of {cb.plan.fused_len} tokens, not {name}")
            step(cb)  # warm-up
            times = []
            for _ in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(cb)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            res[f"{name}_step_s"] = times
            res[f"{name}_profile"] = _profiled(lambda cb=cb: step(cb))
    return res


if __name__ == "__main__":
    argv = sys.argv[1:]
    n = int(argv[argv.index("--steps") + 1]) if "--steps" in argv else 4
    print(json.dumps(run(steps=n, pdrop="--pdrop" in argv)))
