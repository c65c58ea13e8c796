"""K6, K9, K3 and K2 (csrc/attn_sm90.cuh) at their main shapes on the card,
timed so that two trees of the package can be compared in one run:

    python -m timeviper_tpu_torch.bench.attention_ab [case ...]

or, for another checkout of the package, with that checkout first on the path:

    PYTHONPATH=<checkout> python timeviper_tpu_torch/bench/attention_ab.py [case ...]

The cases (all of them by default; each gives `<case>_ms`):

* `k6`: K6 over 16 clips of 1,025 tokens, 16 heads of 88, v a column slice
  of a fused qkv buffer (InternVideo2's 64 frames), whose last key tile
  holds 1 key;
* `k9`: K9 at 4,096 x 12,288 (a clip against its prefix, whole tiles), and
  `k9_ragged` at 4,096 x 12,296 (a last key tile of 8 keys);
* `k3`: K3 over 8 SigLIP frames (729 tokens, 16 heads of 72: a last key tile
  of 25 keys), `k3_dino` over 8 DINOv2-L frames (734, 16 x 64: 30), and
  `k3_256` over 256 SigLIP frames (the ViT microbenchmark's shape);
* `k2_seg`: K2 on one 9B attention layer at L 4,096 (32 heads over 8 of 128)
  with a -1 left pad of 300 rows and a boundary at 2,500, as the paths pass
  segment ids; `k2` without segment ids.

Each output is first held against its plain version to 1e-2 of the plain
result's largest magnitude (K3 at 256 frames on its first 8 frames). Each
time is a list of RUNS means of STEPS calls (CUDA events around the loop,
after one warm-up). The JSON object names the card, its power limit, the
versions and the package's path.
"""

from __future__ import annotations

import json
import sys

import torch

import timeviper_tpu_torch
from timeviper_tpu_torch.bench import device_info, timed_ms
from timeviper_tpu_torch.device import resolve_device
from timeviper_tpu_torch.ops.block_attention import block_attn_lse, block_attn_lse_plain
from timeviper_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from timeviper_tpu_torch.ops.vit_attention import (
    vit_attention,
    vit_attention_plain,
    vit_attention_qkv,
    vit_attention_qkv_plain,
)

STEPS, RUNS = 50, 5
CASES = ("k6", "k9", "k9_ragged", "k3", "k3_dino", "k3_256", "k2_seg", "k2")


def _held(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    err = (got.float() - want.float()).abs().max().item()
    if not err <= 1e-2 * want.float().abs().max().item():
        raise AssertionError(f"{name}: max abs err {err} against the plain version")


def _case(name: str, randn, device):
    """(kernel call, plain call) of one case, on fresh inputs."""
    Hq, Hkv, D = 32, 8, 128
    if name == "k6":
        B, T, H, hd = 16, 1025, 16, 88
        q, k = randn(B, T, H, hd), randn(B, T, H, hd)
        v = randn(B, T, 3 * H * hd)[..., 2 * H * hd:].view(B, T, H, hd)
        return lambda: vit_attention(q, k, v), lambda: vit_attention_plain(q, k, v)
    if name in ("k9", "k9_ragged"):
        Lk = 12288 if name == "k9" else 12296
        q, k, v = randn(1, 4096, Hq, D), randn(1, Lk, Hkv, D), randn(1, Lk, Hkv, D)
        return (lambda: block_attn_lse(q, k, v)[0], lambda: block_attn_lse_plain(q, k, v)[0])
    if name.startswith("k3"):
        F, T, hd = {"k3": (8, 729, 72), "k3_dino": (8, 734, 64), "k3_256": (256, 729, 72)}[name]
        qkv = randn(F, T, 3 * 16 * hd)
        return (lambda: vit_attention_qkv(qkv, 16, hd),
                lambda: vit_attention_qkv_plain(qkv[:8], 16, hd))
    L = 4096
    q, k, v = randn(1, L, Hq, D), randn(1, L, Hkv, D), randn(1, L, Hkv, D)
    seg = None
    if name == "k2_seg":
        seg = torch.zeros(1, L, dtype=torch.int32, device=device)
        seg[:, :300], seg[:, 2500:] = -1, 1
    return lambda: flash_attention(q, k, v, seg), lambda: flash_attention_plain(q, k, v, seg)


@torch.no_grad()
def run(device=None, cases=CASES) -> dict:
    device = resolve_device(device)
    res = dict(device_info(device), package=str(timeviper_tpu_torch.__path__[0]))
    g = torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device).to(torch.bfloat16)

    for name in cases:
        kern, plain = _case(name, randn, device)
        want = plain()
        _held(name, kern()[:want.shape[0]], want)
        del want
        res[f"{name}_ms"] = [timed_ms(kern, STEPS) for _ in range(RUNS)]
        del kern, plain
        torch.cuda.empty_cache()
    return res


if __name__ == "__main__":
    unknown = set(sys.argv[1:]) - set(CASES)
    if unknown:
        raise SystemExit(f"attention_ab: unknown cases {sorted(unknown)}; known: {CASES}")
    print(json.dumps(run(cases=tuple(sys.argv[1:]) or CASES)))
