"""K6, K9, K3, K2 and K10a (csrc/attn_sm90.cuh) and K2-bwd (csrc/flash_bwd.cu)
at their main shapes on the card, timed so that two trees of the package can
be compared in one run:

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
  segment ids; `k2` without segment ids;
* `k2_bwd_seg`, `k2_bwd`: K2-bwd on the same layer, with and without the
  segment ids, given K2's output and row log-sum-exp;
* `k10a_hpp{1,2,4}`: K10a over 8 SigLIP frames with heads padded to 128
  columns, 1, 2 or 4 heads a block, and `k10a_256_hpp{1,2,4}` over 256
  frames (the ViT microbenchmark's shape); `k10a_sdpa` and `k10a_256_sdpa`
  time K10a's library yardstick on the same shapes, SDPA on the padded
  heads (hd 72's scale), so that a run can hold K10a against it.

Each output is first held against its plain version to 1e-2 of the plain
result's largest magnitude (3e-2 for the gradients; K3 and K10a at 256
frames on their first 8 frames). Each
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
from timeviper_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_plain,
)
from timeviper_tpu_torch.ops.headgrid_attention import (
    headgrid_attention,
    headgrid_attention_plain,
    pad_heads,
)
from timeviper_tpu_torch.ops.vit_attention import (
    vit_attention,
    vit_attention_plain,
    vit_attention_qkv,
    vit_attention_qkv_plain,
)

STEPS, RUNS = 50, 5
CASES = ("k6", "k9", "k9_ragged", "k3", "k3_dino", "k3_256", "k2_seg", "k2", "k2_bwd_seg",
         "k2_bwd", *(f"k10a{f}_{c}" for f in ("", "_256")
                     for c in ("hpp1", "hpp2", "hpp4", "sdpa")))


def _held(name: str, got, want, rel: float) -> None:
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    for g, w in pairs:
        err = (g.float() - w.float()).abs().max().item()
        if not err <= rel * w.float().abs().max().item():
            raise AssertionError(f"{name}: max abs err {err} against the plain version")


def _case(name: str, randn, device):
    """(kernel call, plain call, tolerance) of one case, on fresh inputs."""
    Hq, Hkv, D = 32, 8, 128
    if name == "k6":
        B, T, H, hd = 16, 1025, 16, 88
        q, k = randn(B, T, H, hd), randn(B, T, H, hd)
        v = randn(B, T, 3 * H * hd)[..., 2 * H * hd:].view(B, T, H, hd)
        return lambda: vit_attention(q, k, v), lambda: vit_attention_plain(q, k, v), 1e-2
    if name in ("k9", "k9_ragged"):
        Lk = 12288 if name == "k9" else 12296
        q, k, v = randn(1, 4096, Hq, D), randn(1, Lk, Hkv, D), randn(1, Lk, Hkv, D)
        return (lambda: block_attn_lse(q, k, v)[0], lambda: block_attn_lse_plain(q, k, v)[0],
                1e-2)
    if name.startswith("k3"):
        F, T, hd = {"k3": (8, 729, 72), "k3_dino": (8, 734, 64), "k3_256": (256, 729, 72)}[name]
        qkv = randn(F, T, 3 * 16 * hd)
        return (lambda: vit_attention_qkv(qkv, 16, hd),
                lambda: vit_attention_qkv_plain(qkv[:8], 16, hd), 1e-2)
    if name.startswith("k10a"):
        F = 256 if "_256" in name else 8
        qkv = pad_heads(randn(F, 729, 3 * 16 * 72), 16, 72).contiguous()
        plain = lambda: headgrid_attention_plain(qkv[:8], 16, 72 ** -0.5)  # noqa: E731
        if name.endswith("_sdpa"):  # (F, H, T, 128), held against the plain (8, T, H * 128)
            q, k, v = (x.transpose(1, 2).contiguous()
                       for x in qkv.reshape(F, 729, 3, 16, 128).unbind(2))
            return (lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, scale=72 ** -0.5),
                    lambda: plain().view(8, 729, 16, 128).transpose(1, 2), 1e-2)
        hpp = int(name[-1])
        return lambda: headgrid_attention(qkv, 16, hpp, 72 ** -0.5), plain, 1e-2
    L = 4096
    q, k, v = randn(1, L, Hq, D), randn(1, L, Hkv, D), randn(1, L, Hkv, D)
    seg = None
    if name.endswith("_seg"):
        seg = torch.zeros(1, L, dtype=torch.int32, device=device)
        seg[:, :300], seg[:, 2500:] = -1, 1
    if name.startswith("k2_bwd"):
        out, lse = flash_attention_fwd(q, k, v, seg, with_lse=True)
        do = randn(1, L, Hq, D)
        return (lambda: flash_attention_bwd(q, k, v, out, do, lse, seg),
                lambda: flash_attention_bwd_plain(q, k, v, do, seg), 3e-2)
    return (lambda: flash_attention(q, k, v, seg), lambda: flash_attention_plain(q, k, v, seg),
            1e-2)


@torch.no_grad()
def run(device=None, cases=CASES) -> dict:
    device = resolve_device(device)
    res = dict(device_info(device), package=str(timeviper_tpu_torch.__path__[0]))
    g = torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device).to(torch.bfloat16)

    for name in cases:
        kern, plain, rel = _case(name, randn, device)
        want, got = plain(), kern()
        if not isinstance(got, tuple):
            got = got[:want.shape[0]]
        _held(name, got, want, rel)
        del got
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
