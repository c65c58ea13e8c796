"""K4 (csrc/ssd_bwd.cu), K5 and K1 (csrc/ssd_fwd.cu) at the paths' shapes on
the card, timed so that two trees of the package can be compared in one run:

    python -m timeviper_tpu_torch.bench.ssd_ab [--split] [case ...]

or, for another checkout of the package, with that checkout first on the path:

    PYTHONPATH=<checkout> python timeviper_tpu_torch/bench/ssd_ab.py [--split] [case ...]

The cases (all of them by default; each gives `<case>_ms`), on one Mamba
layer of TimeViper-9B (128 heads of 64 over 8 groups of 128, chunks of 256):

* `k4_seg`: K4 at L 4,096 with a -1 left pad of 300 rows and a boundary at
  2,500 and a final-state cotangent (chip_smoke.py's case);
* `k4_1064`, `k4_4136`: K4 at the LoRA training rows' lengths (64 and 256
  frames), whose last chunk is ragged, with no segment ids and no
  final-state cotangent, as the training step gives them;
* `k5`: K5 at L 4,096 on raw streams that are column slices of one
  in-projection output, the same segments;
* `k1`: K1 at L 4,096 on the same segments.

Each output is first held against its plain version to 1e-2 of the plain
result's largest magnitude (3e-2 for the gradients) and its SHA-256 printed
(`<case>_sha256`), so that two trees' bits can be compared. Each time is a
list of RUNS means of STEPS calls (CUDA events around the loop, after one
warm-up); `<case>_host_ms` is the host's time to issue one call, STEPS calls
issued back to back with no synchronize between them (a call that waits on
the card takes about its device time). `--split` adds `<case>_split`: the
device ms of one call by kernel name (torch.profiler). The JSON object
names the card, its power limit, the versions and the package's path.
"""

from __future__ import annotations

import hashlib
import json
import sys
import time

import torch

import timeviper_tpu_torch
from timeviper_tpu_torch.bench import device_info, timed_ms
from timeviper_tpu_torch.device import resolve_device
from timeviper_tpu_torch.ops.ssd import ssd_chunked
from timeviper_tpu_torch.ops.ssd_kernel import (
    ssd_conv_scan_fused,
    ssd_conv_scan_fused_plain,
    ssd_scan,
    ssd_scan_bwd,
    ssd_scan_bwd_plain,
    ssd_scan_fwd,
)

STEPS, RUNS = 20, 5
CASES = ("k4_seg", "k4_1064", "k4_4136", "k5", "k1")
H, P, G, N, CS = 128, 64, 8, 128, 256


def digest(out) -> str:
    h = hashlib.sha256()
    for x in out:
        if x is not None:
            h.update(x.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def split_ms(fn, iters: int = 5) -> dict:
    """Device ms of one call by kernel name (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / iters / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def _held(name: str, got, want, rel: float, floor: float) -> None:
    for g, w in zip(got, want):
        if g is None or w is None:
            continue
        err = (g.float() - w.float()).abs().max().item()
        if not err <= rel * max(w.float().abs().max().item(), floor):
            raise AssertionError(f"{name}: max abs err {err} against the plain version")


def _case(name: str, randn, device):
    """(kernel call, plain call, tolerance, floor) of one case, on fresh inputs."""
    L = {"k4_1064": 1064, "k4_4136": 4136}.get(name, 4096)
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=device)
    D = torch.ones(H, dtype=torch.float32, device=device)
    dtb = torch.log(torch.expm1(torch.full((H,), 0.01, device=device)))
    seq = None
    if name in ("k4_seg", "k5", "k1"):
        seq = torch.zeros(1, L, dtype=torch.int32, device=device)
        seq[:, :300], seq[:, 2500:] = -1, 1
    kw = dict(chunk_size=CS, D=D, dt_bias=dtb, seq_idx=seq)
    if name == "k5":
        di, gn = H * P, G * N
        proj = randn(1, L, 2 * di + 2 * gn + H)
        xr = proj[..., di:2 * di].reshape(1, L, H, P)
        Br = proj[..., 2 * di:2 * di + gn].reshape(1, L, G, N)
        Cr = proj[..., 2 * di + gn:2 * di + 2 * gn].reshape(1, L, G, N)
        dtr = proj[..., 2 * di + 2 * gn:]
        conv = {"wx": randn(di, 4).float() * 0.3, "bx": randn(di).float() * 0.1,
                "wB": randn(gn, 4).float() * 0.3, "bB": randn(gn).float() * 0.1,
                "wC": randn(gn, 4).float() * 0.3, "bC": randn(gn).float() * 0.1}
        return (lambda: ssd_conv_scan_fused(xr, dtr, A, Br, Cr, conv, **kw),
                lambda: ssd_conv_scan_fused_plain(xr, dtr, A, Br, Cr, conv, **kw), 1e-2, 1.0)
    x, dt = randn(1, L, H, P), randn(1, L, H) * 0.5
    Bm, Cm = randn(1, L, G, N), randn(1, L, G, N)
    if name == "k1":
        return (lambda: ssd_scan(x, dt, A, Bm, Cm, **kw),
                lambda: ssd_chunked(x, dt, A, Bm, Cm, **kw), 1e-2, 1.0)
    dy = randn(1, L, H, P)
    dfin = randn(1, H, P, N).float() if seq is not None else None
    _, _, states = ssd_scan_fwd(x, dt, A, Bm, Cm, CS, D, dtb, (0.0, float("inf")), seq, None)
    args = (x, dt, A, Bm, Cm, D, dtb, seq)
    return (lambda: ssd_scan_bwd(*args, states, dy, dfin, CS),
            lambda: ssd_scan_bwd_plain(*args, dy, dfin, CS), 3e-2, 0.0)


@torch.no_grad()
def run(device=None, cases=CASES, split: bool = False) -> dict:
    device = resolve_device(device)
    res = dict(device_info(device), package=str(timeviper_tpu_torch.__path__[0]))
    g = torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device).to(torch.bfloat16)

    for name in cases:
        kern, plain, rel, floor = _case(name, randn, device)
        got = kern()
        torch.cuda.synchronize()
        res[f"{name}_sha256"] = digest(got)
        _held(name, got, plain(), rel, floor)
        if digest(kern()) != res[f"{name}_sha256"]:
            raise AssertionError(f"{name}: a repeat gave other bits")
        del got
        res[f"{name}_ms"] = [timed_ms(kern, STEPS) for _ in range(RUNS)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            kern()
        res[f"{name}_host_ms"] = (time.perf_counter() - t0) / STEPS * 1e3
        torch.cuda.synchronize()
        if split:
            res[f"{name}_split"] = split_ms(kern)
        del kern, plain
        torch.cuda.empty_cache()
    return res


if __name__ == "__main__":
    argv = sys.argv[1:]
    split = "--split" in argv
    names = tuple(a for a in argv if a != "--split")
    unknown = set(names) - set(CASES)
    if unknown:
        raise SystemExit(f"ssd_ab: unknown cases {sorted(unknown)}; known: {CASES}")
    print(json.dumps(run(cases=names or CASES, split=split)))
