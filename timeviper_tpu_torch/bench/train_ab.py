"""LoRA training steps of TimeViper-9B on the card, as chip_smoke.py's
training phase runs them (all 52 layers, random bf16 weights from a seed,
LoRA rank 8 on the backbone's linears and the projector unfrozen, remat
"full"), timed so that two trees of the package can be compared in one run:

    python -m timeviper_tpu_torch.bench.train_ab [--steps N]

or, for another checkout of the package, with that checkout first on the path:

    PYTHONPATH=<checkout> python timeviper_tpu_torch/bench/train_ab.py [--steps N]

Rows: 64 frames and 40 text tokens (1,064 tokens), and 256 frames (4,136).
After one warm-up step on each, N steps of each (4 by default) are timed by
the host clock from a synchronize to the synchronize after the step's loss
is read (`<len>_step_s`). Then one step of each runs under torch.profiler:
its wall time, the device's busy time, and the device time of the SSD
kernels' passes (K4's by their argument struct BwdArgs, K1's by SsdArgs).
The JSON object names the card, its power limit, the versions and the
package's path.
"""

from __future__ import annotations

import json
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
from timeviper_tpu_torch.models.vlm import init_vlm_params
from timeviper_tpu_torch.train.lora import add_lora
from timeviper_tpu_torch.train.optim import OptimConfig
from timeviper_tpu_torch.train.trainer import Trainer, TrainerConfig

IMAGE_TOKEN = 131000  # an id inside the 131072 vocabulary that no text id uses
SEED = 0


def _row(arch, n_frames: int, g: torch.Generator, device):
    """One row as chip_smoke.py collates it: 8 text tokens, the frames, 32
    text tokens, with labels on those last 32."""
    text = torch.randint(10, 130000, (40,), generator=g, device=device).tolist()
    ids = text[:8] + [IMAGE_TOKEN] * n_frames + text[8:]
    labels = [IGNORE_INDEX] * (8 + n_frames) + text[8:]
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
            "k1_ms": sum(ms for k, ms in rows if "SsdArgs" in k)}


def run(device=None, steps: int = 4) -> dict:
    device = resolve_device(device)
    res = dict(device_info(device), package=str(timeviper_tpu_torch.__path__[0]))
    arch = build_arch(VLMConfig())
    model = init_vlm_params(arch, torch.Generator(device=device).manual_seed(SEED),
                            dtype=torch.bfloat16)
    add_lora(model, rank=8, alpha=16.0,
             generator=torch.Generator(device=device).manual_seed(SEED + 2))
    g = torch.Generator(device=device).manual_seed(SEED + 3)
    rows = {"1064": _row(arch, 64, g, device), "4136": _row(arch, 256, g, device)}
    opt_cfg = OptimConfig(learning_rate=1e-3, schedule="constant", max_grad_norm=1.0)
    with tempfile.TemporaryDirectory() as run_dir:
        cfg = TrainerConfig(run_dir=run_dir, max_steps=10**9, log_every=1, save_every=10**9,
                            lora=True, trainable_modules="projector", remat="full",
                            resume=False)
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
    print(json.dumps(run(steps=n)))
