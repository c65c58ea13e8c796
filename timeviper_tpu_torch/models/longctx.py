"""Memory-bounded long-context prefill: each Mamba and MLP layer streamed over
sequence chunks (counterpart of timeviper_tpu/models/longctx.py).

The 9B hybrid's wide per-layer intermediates cap the context one card can
take: at 160k tokens (10k frames) one Mamba layer's in_proj output is
(L, 18,560) bf16, 5.9 GB, and an MLP layer's up-projection 6.9 GB.
`nano_forward_longctx` computes the same function as
models/nano.py:nano_forward with the wide intermediates at chunk size:

* Mamba chunks are continuations (models/prefix_cache.py:_mamba_continue):
  each carries the conv window (the last raw inputs of x, B and C) and the
  SSM state, which the SSD scan (K1 on the card) takes as its
  `initial_state`.
* MLP chunks carry nothing (the layer is pointwise).
* The 4 attention layers run whole through the flash kernel (K2), already
  O(L) in memory. K2 takes any length, so the JAX package's padding to a
  multiple of 256 is left behind.

A length that is no multiple of the chunk leaves a short last chunk, which
runs as it is: K1 takes any length, so the JAX package's tail padding (pad
rows computed and dropped) is left behind too. The (L, D) hidden state
between layers stays whole. Inference only.

With a `pdrop_spec` the config's pdrop stages run between layers
(models/pdrop.py, timeviper_tpu/models/longctx.py:158-175); after a stage L
is in general no multiple of the chunk, and a layer runs unchunked once L
fits in one chunk.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from timeviper_tpu_torch.config import NanoConfig
from timeviper_tpu_torch.models.nano import (
    NanoBlock,
    NanoModel,
    _block_forward,
    compute_logits,
    mlp_mixer_forward,
)
from timeviper_tpu_torch.models.pdrop import apply_pdrop_stage
from timeviper_tpu_torch.models.prefix_cache import _mamba_continue
from timeviper_tpu_torch.ops.norms import rms_norm


def _mamba_layer_chunked(block: NanoBlock, cfg: NanoConfig, hidden: torch.Tensor,
                         chunk_tokens: int) -> torch.Tensor:
    """One Mamba layer (norm, mixer and residual) over chunks of
    `chunk_tokens` rows, each a continuation (models/prefix_cache.py) of
    the ones before it, from a zero conv window and no SSM state.
    hidden (B, L, D) -> (B, L, D)."""
    B = hidden.shape[0]
    K, gn = cfg.mamba_d_conv, cfg.mamba_n_groups * cfg.ssm_state_size
    widths = {"x": cfg.mamba_intermediate_size, "B": gn, "C": gn}
    state = {"conv_state": {name: hidden.new_zeros(B, w, K) for name, w in widths.items()},
             "ssm_state": None}
    out = torch.empty_like(hidden)
    for s in range(0, hidden.shape[1], chunk_tokens):
        chunk = hidden[:, s:s + chunk_tokens]
        normed = rms_norm(chunk, block.norm.weight, cfg.layer_norm_epsilon)
        y, state = _mamba_continue(block.mixer, cfg, normed, state)
        out[:, s:s + chunk.shape[1]] = chunk + y
    return out


def _mlp_layer_chunked(block: NanoBlock, cfg: NanoConfig, hidden: torch.Tensor,
                       chunk_tokens: int) -> torch.Tensor:
    out = torch.empty_like(hidden)
    for s in range(0, hidden.shape[1], chunk_tokens):
        chunk = hidden[:, s:s + chunk_tokens]
        normed = rms_norm(chunk, block.norm.weight, cfg.layer_norm_epsilon)
        out[:, s:s + chunk.shape[1]] = chunk + mlp_mixer_forward(block.mixer, cfg, normed)
    return out


@torch.inference_mode()
def nano_forward_longctx(model: NanoModel, cfg: NanoConfig, inputs_embeds: torch.Tensor, *,
                         chunk_tokens: int = 16384, logits_to_keep: int = 1, pdrop_spec=None,
                         pdrop_params=None) -> Dict[str, Any]:
    """Full-sequence prefill with the wide intermediates at chunk size; a layer
    runs unchunked where L <= chunk_tokens. Same math as
    nano_forward(inputs_embeds=..., pdrop_spec=..., pdrop_params=...). Returns
    {"hidden_states", "logits"} (the f32 logits of the last `logits_to_keep`
    rows; 0 keeps all)."""
    hidden = inputs_embeds
    stages = ({st.layer: (i, st) for i, st in enumerate(cfg.pdrop_stages)}
              if pdrop_spec is not None else {})
    for idx, block in enumerate(model.layers):
        if idx in stages:
            si, st = stages[idx]
            hidden, _, _, pdrop_spec, _ = apply_pdrop_stage(
                hidden, None, None, pdrop_spec, st, si, cfg=cfg,
                attn_mixer=block.mixer if st.compress_type == "attn" else None,
                merge=pdrop_params)
        chunked = hidden.shape[1] > chunk_tokens
        if block.block_type == "attention" or not chunked:
            hidden = _block_forward(block, cfg, hidden, None, False, 0)[0]
        elif block.block_type == "mamba":
            hidden = _mamba_layer_chunked(block, cfg, hidden, chunk_tokens)
        else:
            hidden = _mlp_layer_chunked(block, cfg, hidden, chunk_tokens)
    hidden = rms_norm(hidden, model.norm_f.weight, cfg.layer_norm_epsilon)
    tail = hidden[:, -logits_to_keep:] if logits_to_keep else hidden
    return {"hidden_states": hidden, "logits": compute_logits(model, tail)}
