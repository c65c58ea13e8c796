"""Decode caches of the Nemotron-H and Qwen2 backbones (counterpart of
timeviper_tpu/models/cache.py).

A dict with the JAX package's layout: per Mamba layer `conv_state` {x, B, C}
(B, channels, K) and `ssm_state` (B, H, P, N) float32; per attention layer
`k`/`v` buffers of fixed capacity (B, max_len, Hkv, hd); `length`, the number
of tokens already processed, and `valid_from`, the first slot that is not a
left pad. A Qwen2 cache holds `k`/`v` buffers in every layer (keys after
RoPE). `length` and `valid_from` are host integers: the decode loop runs in
Python and never needs them on the device.
"""

from __future__ import annotations

from typing import Any, Dict

import torch


def init_nano_cache(cfg, batch_size: int, max_len: int, dtype=torch.bfloat16,
                    device=None) -> Dict[str, Any]:
    kw = dict(dtype=dtype, device=device)
    gn = cfg.mamba_n_groups * cfg.ssm_state_size
    K = cfg.mamba_d_conv
    layers = []
    for block_type in cfg.layers_block_type:
        if block_type == "mamba":
            layers.append({
                "conv_state": {
                    "x": torch.zeros(batch_size, cfg.mamba_intermediate_size, K, **kw),
                    "B": torch.zeros(batch_size, gn, K, **kw),
                    "C": torch.zeros(batch_size, gn, K, **kw),
                },
                "ssm_state": torch.zeros(
                    batch_size, cfg.mamba_num_heads, cfg.mamba_head_dim,
                    cfg.ssm_state_size, dtype=torch.float32, device=device),
            })
        elif block_type == "attention":
            shape = (batch_size, max_len, cfg.num_key_value_heads, cfg.head_dim)
            layers.append({"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)})
        else:
            layers.append({})
    return {"layers": layers, "length": 0, "valid_from": 0}


def init_qwen2_cache(cfg, batch_size: int, max_len: int, dtype=torch.bfloat16,
                     device=None) -> Dict[str, Any]:
    shape = (batch_size, max_len, cfg.num_key_value_heads, cfg.head_dim)
    layers = [{"k": torch.zeros(shape, dtype=dtype, device=device),
               "v": torch.zeros(shape, dtype=dtype, device=device)}
              for _ in range(cfg.num_hidden_layers)]
    return {"layers": layers, "length": 0, "valid_from": 0}
