"""K6 and K9 (csrc/attn_sm90.cuh) at their main shapes on the card, timed so
that two trees of the package can be compared in one run:

    python -m timeviper_tpu_torch.bench.attention_ab

or, for another checkout of the package, with that checkout first on the path:

    PYTHONPATH=<checkout> python timeviper_tpu_torch/bench/attention_ab.py

* `k6_ms`: K6 over 16 clips of 1,025 tokens, 16 heads of 88, v a column
  slice of a fused qkv buffer (InternVideo2's 64 frames), whose last key
  tile holds 1 key;
* `k9_ms`: K9 at 4,096 x 12,288 (a clip against its prefix, whole tiles),
  and `k9_ragged_ms` at 4,096 x 12,296 (a last key tile of 8 keys).

Each output is first held against its plain version to 1e-2 of the plain
result's largest magnitude. Each time is a list of RUNS means of STEPS calls
(CUDA events around the loop, after one warm-up). The JSON object names the
card, its power limit, the versions and the package's path.
"""

from __future__ import annotations

import json

import torch

import timeviper_tpu_torch
from timeviper_tpu_torch.bench import device_info, timed_ms
from timeviper_tpu_torch.device import resolve_device
from timeviper_tpu_torch.ops.block_attention import block_attn_lse, block_attn_lse_plain
from timeviper_tpu_torch.ops.vit_attention import vit_attention, vit_attention_plain

STEPS, RUNS = 50, 5


def _held(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    err = (got.float() - want.float()).abs().max().item()
    if not err <= 1e-2 * want.float().abs().max().item():
        raise AssertionError(f"{name}: max abs err {err} against the plain version")


@torch.no_grad()
def run(device=None) -> dict:
    device = resolve_device(device)
    res = dict(device_info(device), package=str(timeviper_tpu_torch.__path__[0]))
    g = torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device).to(torch.bfloat16)

    B, T, H, hd = 16, 1025, 16, 88
    q, k = randn(B, T, H, hd), randn(B, T, H, hd)
    v = randn(B, T, 3 * H * hd)[..., 2 * H * hd:].view(B, T, H, hd)
    _held("K6", vit_attention(q, k, v), vit_attention_plain(q, k, v))
    res["k6_ms"] = [timed_ms(lambda: vit_attention(q, k, v), STEPS) for _ in range(RUNS)]
    del q, k, v

    Hq, Hkv, D = 32, 8, 128
    for key, Lk in (("k9_ms", 12288), ("k9_ragged_ms", 12296)):
        q, k, v = randn(1, 4096, Hq, D), randn(1, Lk, Hkv, D), randn(1, Lk, Hkv, D)
        _held(key, block_attn_lse(q, k, v)[0], block_attn_lse_plain(q, k, v)[0])
        res[key] = [timed_ms(lambda: block_attn_lse(q, k, v), STEPS) for _ in range(RUNS)]
        del q, k, v
    return res


if __name__ == "__main__":
    print(json.dumps(run()))
