"""Causal flash attention (K2) at the 80k-prefill shape on the card
(counterpart of scripts/microbench_flash.py):

    python -m timeviper_tpu_torch.bench.microbench_flash

L = MB_SEQ (81,920) tokens, MB_HEADS (32) query heads over MB_KV (8) KV
heads of 128, bf16, causal. K2 (ops/flash_attention.py:flash_attention_fwd)
runs at each tile (query rows, keys) of MB_BLOCKS (default: the four of
FLASH_TILES; the paths run (64, 64)), reading the KV heads in place where the
TPU script repeated them to MHA. Each tile gives `blk_q{bq}_k{bk}_ms` and
`blk_q{bq}_k{bk}_tfs` with the TPU script's count of operations,
2 * 2 * Hq * D * L (L + 1) / 2. SDPA on the KV heads repeated to MHA (the
flash backend; a yardstick the port never calls) gives `sdpa_ms` and
`sdpa_tfs`, and `bound_ms` is the card's least time for the causal work.
Times are CUDA events over MB_STEPS (3) calls after a warm-up. The JSON
object names the card, its power limit and the torch and CUDA versions.
"""

from __future__ import annotations

import ast
import json
import os
from typing import Optional

import torch
from torch.nn.attention import SDPBackend, sdpa_kernel

from timeviper_tpu_torch.bench import bound_ms, device_info, timed_ms
from timeviper_tpu_torch.device import resolve_device
from timeviper_tpu_torch.ops.flash_attention import FLASH_TILES, flash_attention_fwd

D = 128


def causal_flops(L: int, Hq: int) -> float:
    return 2 * 2 * Hq * D * (L * (L + 1) // 2)


@torch.no_grad()
def run(device=None, seq: Optional[int] = None) -> dict:
    """The sweep at L = `seq` (default MB_SEQ) tokens, the other shapes
    from the MB_* variables."""
    device = resolve_device(device)
    env = os.environ.get
    L = int(env("MB_SEQ", 81920)) if seq is None else seq
    Hq, Hkv = int(env("MB_HEADS", 32)), int(env("MB_KV", 8))
    steps = int(env("MB_STEPS", 3))
    tiles = ast.literal_eval(env("MB_BLOCKS", repr(FLASH_TILES)))
    info = device_info(device)
    g = torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return (torch.randn(*shape, generator=g, device=device) * 0.3).to(torch.bfloat16)

    q, k, v = randn(1, L, Hq, D), randn(1, L, Hkv, D), randn(1, L, Hkv, D)
    flops = causal_flops(L, Hq)
    res = {}
    for bq, bk in tiles:
        ms = timed_ms(lambda tile=(bq, bk): flash_attention_fwd(q, k, v, None, False, tile),
                      steps)
        res[f"blk_q{bq}_k{bk}_ms"] = ms
        res[f"blk_q{bq}_k{bk}_tfs"] = flops / (ms / 1e3) / 1e12
    rep = Hq // Hkv
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (
        q, k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)))
    del q, k, v
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        ms = timed_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True), steps)
    res["sdpa_ms"], res["sdpa_tfs"] = ms, flops / (ms / 1e3) / 1e12
    # q and o, k and v at their own Hkv heads, 2 bytes each
    res["bound_ms"] = bound_ms(flops, 2 * (2 * qs.numel() + 2 * L * Hkv * D))
    res["note"] = f"L={L} Hq={Hq} Hkv={Hkv} D={D} causal bf16, GQA read in place"
    res.update(info)
    return res


def main() -> None:
    print(json.dumps(run(), indent=1))


if __name__ == "__main__":
    main()
