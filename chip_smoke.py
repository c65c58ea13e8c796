#!/usr/bin/env python3
"""Drive the PyTorch port of TimeViper once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (there is no fallback anywhere):

1. device: a CUDA card must be present; print its name and power limit;
   TF32 off for matmuls and convolutions.
2. build: compile csrc/*.cu with nvcc into one library; print the seconds.
3. kernels: each hand-written kernel against its plain PyTorch version at the
   main path's shapes, in bf16; print max error and times.
4. end to end: TimeViper-9B (SigLIP-SO400M-384 + ToMe-16 MLP + Nemotron-H 9B,
   all 52 layers) with random bf16 weights from a seeded CUDA generator, three
   greedy requests through Generator.generate (text only, 64 frames, 256
   frames) and a repeat of the second; the launch counters of the three
   kernels must grow during them. The kernels are then held against their
   plain versions on the inputs the 64-frame request really gave them, and the
   64-frame request is run once more with the plain versions in place of the
   kernels as a reference for its first-token logits.

The line before the last is one JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Needs the CUDA toolkit (nvcc) and no network.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from timeviper_tpu.config import VLMConfig  # noqa: E402
from timeviper_tpu_torch.models import nano as nano_mod  # noqa: E402
from timeviper_tpu_torch.models import vit as vit_mod  # noqa: E402
from timeviper_tpu_torch.models.api import build_arch  # noqa: E402
from timeviper_tpu_torch.models.generate import Generator  # noqa: E402
from timeviper_tpu_torch.models.vlm import init_vlm_params  # noqa: E402
from timeviper_tpu_torch.ops import _cuda  # noqa: E402
from timeviper_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_plain,
)
from timeviper_tpu_torch.ops.ssd import ssd_chunked  # noqa: E402
from timeviper_tpu_torch.ops.ssd_kernel import ssd_scan  # noqa: E402
from timeviper_tpu_torch.ops.vit_attention import (  # noqa: E402
    vit_attention_qkv,
    vit_attention_qkv_plain,
)

DEV = torch.device("cuda")
SEED = 0
IMAGE_TOKEN = 131000  # an id inside the 131072 vocabulary that no text id uses
MAX_NEW = 16

# Per kernel: its source, the TPU kernel it replaces (file:line) and its
# tolerance, relative to the plain output's largest magnitude: both sides read
# the same bf16 inputs, round their output to bf16 (2^-8 relative) and sum in
# f32 in other orders; both attentions round their probabilities to bf16
# before the PV product (the kernels feed them to bf16 tensor cores).
KERNELS = {
    "ssd_fwd": dict(source="timeviper_tpu_torch/csrc/ssd_fwd.cu",
                    replaces="timeviper_tpu/ops/ssd_pallas.py:52", rel_tol=1e-2),
    "flash_fwd": dict(source="timeviper_tpu_torch/csrc/flash_fwd.cu",
                      replaces="timeviper_tpu/ops/flash_pallas.py:39", rel_tol=1e-2),
    "vit_attn_qkv": dict(source="timeviper_tpu_torch/csrc/vit_attn_qkv.cu",
                         replaces="timeviper_tpu/ops/vit_attention.py:197", rel_tol=1e-2),
}
WRAPPERS = {"ssd_fwd": ssd_scan, "flash_fwd": flash_attention,
            "vit_attn_qkv": vit_attention_qkv}


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_ms(fn, iters: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name: str, got, want) -> float:
    """Max abs error of the kernel output(s) against the plain one(s); raises
    past the kernel's tolerance."""
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    worst = 0.0
    for g, w in pairs:
        g, w = g.float(), w.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        err = (g - w).abs().max().item()
        scale = max(w.abs().max().item(), 1.0)
        if err > KERNELS[name]["rel_tol"] * scale:
            raise AssertionError(f"{name}: max abs error {err:.3e} > "
                                 f"{KERNELS[name]['rel_tol']} x {scale:.3e}")
        worst = max(worst, err)
    return worst


def segments(L: int, pad: int, cut: int) -> torch.Tensor:
    """A left pad of -1, segment 0 up to `cut`, segment 1 after: the
    Generator's pad plus one packed boundary."""
    seq = torch.zeros(1, L, dtype=torch.int32, device=DEV)
    seq[:, :pad] = -1
    seq[:, cut:] = 1
    return seq


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {smi}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    path = _cuda.build()
    _cuda.lib()
    log(f"[build] {path.relative_to(Path(__file__).resolve().parent)} in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {_cuda.build_seconds:.1f} s)")
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")


def kernel_cases(g: torch.Generator):
    """Inputs at the main path's shapes: (name, kernel call, plain call)."""
    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=DEV) * scale).to(torch.bfloat16)

    # K1: one Mamba layer of the 9B at L = 4096 (16 chunks of 256)
    L, H, P, G, N = 4096, 128, 64, 8, 128
    x, dt = randn(1, L, H, P), randn(1, L, H, scale=0.5)
    Bm, Cm = randn(1, L, G, N), randn(1, L, G, N)
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=DEV)
    D = torch.ones(H, dtype=torch.float32, device=DEV)
    dtb = torch.log(torch.expm1(torch.full((H,), 0.01, device=DEV)))
    seq = segments(L, 300, 2500)
    ssd_kw = dict(chunk_size=256, D=D, dt_bias=dtb, seq_idx=seq)
    yield ("ssd_fwd", lambda: ssd_scan(x, dt, A, Bm, Cm, **ssd_kw),
           lambda: ssd_chunked(x, dt, A, Bm, Cm, **ssd_kw))

    # K2: one attention layer of the 9B at L = 4096, same segments
    q, k, v = randn(1, L, 32, 128), randn(1, L, 8, 128), randn(1, L, 8, 128)
    yield ("flash_fwd", lambda: flash_attention(q, k, v, segment_ids=seq),
           lambda: flash_attention_plain(q, k, v, segment_ids=seq))

    # K3: one SigLIP-SO400M layer over 8 frames
    qkv = randn(8, 729, 3 * 16 * 72)
    yield ("vit_attn_qkv", lambda: vit_attention_qkv(qkv, 16, 72),
           lambda: vit_attention_qkv_plain(qkv, 16, 72))


def phase_kernels(g: torch.Generator) -> dict:
    results = {}
    for name, kern, plain in kernel_cases(g):
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        err = compare(name, got, want)
        del got, want
        ms = timed_ms(kern)
        plain_ms = timed_ms(plain, iters=2)
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        log(f"[kernels] {name}: max abs err {err:.3e}; kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms")
        torch.cuda.empty_cache()
    return results


class Capture:
    """Records the first call's inputs of a wrapper while `armed`."""

    def __init__(self, fn):
        self.fn, self.armed, self.args, self.kwargs = fn, False, None, None

    def __call__(self, *args, **kwargs):
        if self.armed and self.args is None:
            clone = lambda v: v.clone() if isinstance(v, torch.Tensor) else v  # noqa: E731
            self.args = tuple(clone(a) for a in args)
            self.kwargs = {k: clone(v) for k, v in kwargs.items()}
        return self.fn(*args, **kwargs)


def phase_end_to_end(kernel_results: dict) -> None:
    arch = build_arch(VLMConfig())  # siglip-vit-so400m-384px + tome_mlp-16 + nano-9b-v2
    t0 = time.perf_counter()
    model = init_vlm_params(arch, torch.Generator(device=DEV).manual_seed(SEED),
                            dtype=torch.bfloat16, device=DEV)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[e2e] TimeViper-9B: {n_params / 1e9:.2f} B params, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB, init {time.perf_counter() - t0:.1f} s")
    gen = Generator(model, arch, terminator_ids=[], max_new_tokens=MAX_NEW)

    g = torch.Generator(device=DEV).manual_seed(SEED + 1)
    size = arch.vision.image_size

    def request(n_frames: int):
        text = torch.randint(10, 130000, (40,), generator=g, device=DEV).tolist()
        ids = text[:8] + [IMAGE_TOKEN] * n_frames + text[8:]
        pixels = (torch.rand(n_frames, size, size, 3, generator=g, device=DEV) * 2 - 1
                  if n_frames else None)
        return ids, pixels

    requests = [("text", request(0)), ("64 frames", request(64)), ("256 frames", request(256))]
    captures = {"ssd_fwd": Capture(nano_mod.ssd_scan),
                "flash_fwd": Capture(nano_mod.flash_attention),
                "vit_attn_qkv": Capture(vit_mod.encoder_attention_qkv)}
    nano_mod.ssd_scan = captures["ssd_fwd"]
    nano_mod.flash_attention = captures["flash_fwd"]
    vit_mod.encoder_attention_qkv = captures["vit_attn_qkv"]

    for w in WRAPPERS.values():
        w.launches = 0
    outs = {}
    for label, (ids, pixels) in requests:
        for c in captures.values():
            c.armed = label == "64 frames"
        out = gen.generate(ids, pixels=pixels, image_token_id=IMAGE_TOKEN)
        outs[label] = out
        if not torch.isfinite(out.first_logits).all():
            raise AssertionError(f"{label}: non-finite first-token logits")
        decode_tps = (out.num_generated - 1) / out.decode_s
        log(f"[e2e] {label}: bucket {gen._plan_prompt(ids, IMAGE_TOKEN)[1]}, "
            f"encode {out.encode_s:.3f} s, prefill {out.prefill_s:.3f} s, "
            f"decode {decode_tps:.2f} tok/s, {out.num_generated} tokens "
            f"{out.token_ids.tolist()}")
    repeat = gen.generate(requests[1][1][0], pixels=requests[1][1][1],
                          image_token_id=IMAGE_TOKEN)
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    log(f"[e2e] launches during the requests: {launches}")
    if repeat.token_ids.tolist() != outs["64 frames"].token_ids.tolist():
        raise AssertionError("a repeat of the 64-frame request gave other ids")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} was never launched on the main path")
        kernel_results[name]["launches"] = count

    nano_mod.ssd_scan = captures["ssd_fwd"].fn
    nano_mod.flash_attention = captures["flash_fwd"].fn
    vit_mod.encoder_attention_qkv = captures["vit_attn_qkv"].fn

    # kernels against plain versions on the inputs the 64-frame request gave them
    c = captures["ssd_fwd"]
    errs = {"ssd_fwd": compare("ssd_fwd", ssd_scan(*c.args, **c.kwargs),
                               ssd_chunked(*c.args, **c.kwargs))}
    c = captures["flash_fwd"]
    errs["flash_fwd"] = compare("flash_fwd", flash_attention(*c.args, **c.kwargs),
                                flash_attention_plain(*c.args, **c.kwargs))
    c = captures["vit_attn_qkv"]
    errs["vit_attn_qkv"] = compare("vit_attn_qkv", vit_attention_qkv(*c.args),
                                   vit_attention_qkv_plain(*c.args))
    for name, err in errs.items():
        shapes = [tuple(a.shape) for a in captures[name].args if isinstance(a, torch.Tensor)]
        log(f"[e2e] {name} on the request's own inputs {shapes}: max abs err {err:.3e}")
        kernel_results[name]["max_abs_err"] = max(kernel_results[name]["max_abs_err"], err)
    del captures, c
    torch.cuda.empty_cache()

    # reference: the 64-frame request with the plain versions in place of the kernels
    nano_mod.ssd_scan = ssd_chunked
    nano_mod.flash_attention = flash_attention_plain
    vit_mod.encoder_attention_qkv = vit_attention_qkv_plain
    ref = gen.generate(requests[1][1][0], pixels=requests[1][1][1], image_token_id=IMAGE_TOKEN)
    nano_mod.ssd_scan = WRAPPERS["ssd_fwd"]
    nano_mod.flash_attention = WRAPPERS["flash_fwd"]
    vit_mod.encoder_attention_qkv = WRAPPERS["vit_attn_qkv"]
    got, want = outs["64 frames"].first_logits.float(), ref.first_logits.float()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1).item()
    log(f"[e2e] 64 frames, kernels vs plain versions: first-token logits max abs diff "
        f"{err:.3e} (max |logit| {scale:.3e}, cosine {cos:.6f}); ids kernels "
        f"{outs['64 frames'].token_ids.tolist()} plain {ref.token_ids.tolist()}")
    # bf16 activations through 52 layers: the two paths round at other places
    if not (math.isfinite(err) and cos > 0.99):
        raise AssertionError("first-token logits disagree with the plain-version run")


def main() -> int:
    smi = phase_device()
    phase_build()
    g = torch.Generator(device=DEV).manual_seed(SEED)
    results = phase_kernels(g)
    phase_end_to_end(results)
    line = {"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name]["source"],
             replaces=KERNELS[name]["replaces"], launches=r["launches"],
             max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"])
        for name, r in results.items()]}
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
