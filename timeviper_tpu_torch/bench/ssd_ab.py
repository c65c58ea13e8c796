"""K4 (csrc/ssd_bwd.cu), K5 and K1 (csrc/ssd_fwd.cu) and K7
(csrc/decode_fused.cu) at the paths' shapes on the card, timed so that two
trees of the package can be compared in one run:

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
* `k1`: K1 at L 4,096 on the same segments;
* `k1_8192`: K1 at L 8,192, the 256-frame prefill's bucket, with the
  Generator's -1 left pad of 4,056 rows;
* `k1_q12`, `k1_q300`: K1 on a question's 12 or 300 rows from a carried
  initial state, as a continuation on a cached prefix runs it (no segment
  ids);
* `k4_cs512`: K4 at L 4,096 on the same segments at chunks of 512 rows;
* `k7_b1`, `k7_b3`, `k7_b8`: K7, one decode step of a Mamba layer at batch 1, 3 and 8
  (xr and the gate column slices of the fused in_proj row), timed by its
  device time under torch.profiler with the 50 MB L2 flushed before each
  call, as chip_smoke.py times it.

Each output is first held against its plain version to 1e-2 of the plain
result's largest magnitude (3e-2 for the gradients) and its SHA-256 printed
(`<case>_sha256`), so that two trees' bits can be compared. Each time is a
list of RUNS means of STEPS calls (CUDA events around the loop, after one
warm-up); `<case>_host_ms` is the host's time to issue one call, STEPS calls
issued back to back with no synchronize between them (a call that waits on
the card takes about its device time).
A case that the tree refuses (a ValueError of its wrapper) gives
`<case>_refused` with the message instead. `--split` adds `<case>_split`: the
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
from timeviper_tpu_torch.bench import device_info, device_ms, timed_ms
from timeviper_tpu_torch.device import resolve_device
from timeviper_tpu_torch.ops.decode_fused import fused_mamba_decode, fused_mamba_decode_plain
from timeviper_tpu_torch.ops.ssd import _process_dt, ssd_chunked
from timeviper_tpu_torch.ops.ssd_kernel import (
    ssd_conv_scan_fused,
    ssd_conv_scan_fused_plain,
    ssd_scan,
    ssd_scan_bwd,
    ssd_scan_bwd_plain,
    ssd_scan_fwd,
)

STEPS, RUNS = 20, 5
CASES = ("k4_seg", "k4_1064", "k4_4136", "k4_cs512", "k5", "k1", "k1_8192", "k1_q12",
         "k1_q300", "k7_b1", "k7_b3", "k7_b8")
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
    L = {"k4_1064": 1064, "k4_4136": 4136, "k1_8192": 8192, "k1_q12": 12,
         "k1_q300": 300}.get(name, 4096)
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=device)
    D = torch.ones(H, dtype=torch.float32, device=device)
    dtb = torch.log(torch.expm1(torch.full((H,), 0.01, device=device)))
    if name.startswith("k7"):
        return _decode_case(int(name[4:]), randn, A, D, dtb, device)
    seq = None
    if name in ("k4_seg", "k4_cs512", "k5", "k1"):
        seq = torch.zeros(1, L, dtype=torch.int32, device=device)
        seq[:, :300], seq[:, 2500:] = -1, 1
    elif name == "k1_8192":
        seq = torch.zeros(1, L, dtype=torch.int32, device=device)
        seq[:, :L - 4136] = -1
    cs = 512 if name == "k4_cs512" else CS
    kw = dict(chunk_size=cs, D=D, dt_bias=dtb, seq_idx=seq)
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
    if name.startswith("k1"):
        if name.startswith("k1_q"):
            kw["initial_state"] = randn(1, H, P, N).float() * 0.3
        return (lambda: ssd_scan(x, dt, A, Bm, Cm, **kw),
                lambda: ssd_chunked(x, dt, A, Bm, Cm, **kw), 1e-2, 1.0)
    dy = randn(1, L, H, P)
    dfin = randn(1, H, P, N).float() if seq is not None else None
    _, _, states = ssd_scan_fwd(x, dt, A, Bm, Cm, cs, D, dtb, (0.0, float("inf")), seq, None,
                                keep_states=True)
    args = (x, dt, A, Bm, Cm, D, dtb, seq)
    return (lambda: ssd_scan_bwd(*args, states, dy, dfin, cs),
            lambda: ssd_scan_bwd_plain(*args, dy, dfin, cs), 3e-2, 0.0)


def _decode_case(bsz: int, randn, A, D, dtb, device):
    """K7 at the 9B's widths (chip_smoke.py's case): d_inner 8,192 in 8 groups
    of 1,024 channels, N 128, K 4."""
    di, gn, K = H * P, G * N, 4
    row = randn(bsz, 2 * di + 2 * gn + H)
    f32 = lambda *s, k=1.0: randn(*s).float() * k  # noqa: E731
    dec = (row[:, di:2 * di], randn(bsz, gn), randn(bsz, gn),
           _process_dt(randn(bsz, H), dtb, (0.0, float("inf"))), row[:, :di],
           randn(bsz, di, K), f32(bsz, H, P, N, k=0.3), f32(di, K, k=0.3), f32(di, k=0.1),
           torch.log(-A), D, 1 + f32(di, k=0.1))
    kw = dict(n_groups=G, head_dim=P, eps=1e-5)
    return (lambda: fused_mamba_decode(*dec, **kw),
            lambda: fused_mamba_decode_plain(*dec, **kw), 1e-2, 1.0)


@torch.no_grad()
def run(device=None, cases=CASES, split: bool = False) -> dict:
    device = resolve_device(device)
    res = dict(device_info(device), package=str(timeviper_tpu_torch.__path__[0]))
    g = torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device).to(torch.bfloat16)

    for name in cases:
        kern, plain, rel, floor = _case(name, randn, device)
        try:
            got = kern()
        except ValueError as e:
            res[f"{name}_refused"] = str(e)
            continue
        torch.cuda.synchronize()
        res[f"{name}_sha256"] = digest(got)
        _held(name, got, plain(), rel, floor)
        if digest(kern()) != res[f"{name}_sha256"]:
            raise AssertionError(f"{name}: a repeat gave other bits")
        del got
        if name.startswith("k7"):
            res[f"{name}_ms"] = [device_ms(kern) for _ in range(RUNS)]
            del kern, plain
            continue
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
