"""ViT attention at SigLIP's shape on the card (counterpart of
scripts/microbench_vit_attn.py):

    python -m timeviper_tpu_torch.bench.microbench_vit_attn

MB_FRAMES frames (256) of 729 tokens, 16 heads of 72, bf16:

* `current_qkv_ms`: K3, the model's attention (ops/vit_attention.py), on the
  fused qkv at hd 72;
* `hd128_grid_hpp{1,2,4}_ms`, `hd128_grid_hpp2_noexp_ms`: K10a
  (ops/headgrid_attention.py) on the qkv padded to 128 columns a head, 1, 2
  or 4 heads a block, with the softmax's exp or without it;
* `qkvproj_{72,128}_{bf16,int8}_ms`: the qkv projection that emits 72- or
  128-column heads, as a bf16 `torch.matmul` and as the int8 product
  `torch._int_mm` with the script's quantize and scale around it (plain
  products, which the JAX package leaves to XLA);
* SDPA on the same q, k and v at hd 72 and 128 (`sdpa_hd{72,128}_ms`), a
  yardstick the port never calls, and the bounds of K3 and K10a's work.

Times are CUDA events over 10 calls after a warm-up. The JSON object names
the card, its power limit and the torch and CUDA versions.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from timeviper_tpu_torch.bench import bound_ms, device_info, timed_ms
from timeviper_tpu_torch.device import resolve_device
from timeviper_tpu_torch.ops.headgrid_attention import headgrid_attention, pad_heads
from timeviper_tpu_torch.ops.int8_linear import int_mm
from timeviper_tpu_torch.ops.vit_attention import vit_attention_qkv

T, H, HD = 729, 16, 72
STEPS = 10


def _sdpa(qkv: torch.Tensor, hd: int):
    """SDPA over (B, H, T, hd) copies of q, k and v, made outside the timed call."""
    B = qkv.shape[0]
    q, k, v = (x.transpose(1, 2).contiguous()
               for x in qkv.reshape(B, T, 3, H, hd).unbind(2))
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)


@torch.no_grad()
def run(device=None, frames: Optional[int] = None) -> dict:
    """The runs at `frames` (default MB_FRAMES) frames; returns the JSON
    object."""
    device = resolve_device(device)
    B = int(os.environ.get("MB_FRAMES", 256)) if frames is None else frames
    info = device_info(device)
    g = torch.Generator(device=device).manual_seed(0)
    qkv = (torch.randn(B, T, 3 * H * HD, generator=g, device=device) * 0.3).to(torch.bfloat16)
    qkv128 = pad_heads(qkv, H, HD).contiguous()
    scale = HD ** -0.5
    res = {"current_qkv_ms": timed_ms(lambda: vit_attention_qkv(qkv, H, HD), STEPS)}
    for hpp in (1, 2, 4):
        res[f"hd128_grid_hpp{hpp}_ms"] = timed_ms(
            lambda hpp=hpp: headgrid_attention(qkv128, H, hpp, scale), STEPS)
    res["hd128_grid_hpp2_noexp_ms"] = timed_ms(
        lambda: headgrid_attention(qkv128, H, 2, scale, do_exp=False), STEPS)
    for hd, x in ((72, qkv), (128, qkv128)):
        res[f"sdpa_hd{hd}_ms"] = timed_ms(_sdpa(x, hd), STEPS)
        res[f"bound_hd{hd}_ms"] = bound_ms(4 * B * H * T * T * hd,
                                           x.numel() * x.element_size() * 4 // 3)
    del qkv, qkv128
    # the qkv projection at 72- and 128-column heads, bf16 and int8
    x_in = torch.randn(B * T, H * HD, generator=g, device=device).to(torch.bfloat16)
    for hd in (72, 128):
        w = (torch.randn(3 * H * hd, H * HD, generator=g, device=device) * 0.02).to(
            torch.bfloat16)
        res[f"qkvproj_{hd}_bf16_ms"] = timed_ms(lambda w=w: torch.matmul(x_in, w.t()), STEPS)
        wq = torch.round(w.float() * 500).to(torch.int8)

        def mm_int8(wq=wq):
            xq = torch.clamp(torch.round(x_in * 16.0), -127, 127).to(torch.int8)
            return (int_mm(xq, wq).float() * 2e-4).to(torch.bfloat16)

        res[f"qkvproj_{hd}_int8_ms"] = timed_ms(mm_int8, STEPS)
    res["note"] = f"B={B} T={T} H={H} hd={HD} bf16"
    res.update(info)
    return res


def main() -> None:
    print(json.dumps(run(), indent=1))


if __name__ == "__main__":
    main()
