"""TimeViper VLM assembly: vision -> projector -> fuse -> LLM (counterpart of
timeviper_tpu/models/vlm.py).

The host builds the fusion plan with the JAX package's numpy-only
`timeviper_tpu.data.fusion`, and the model applies it as one gather. Left out
for now: multi-tower vision, InternVideo2, the qwen2 backbone and pdrop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from timeviper_tpu.config import VLMConfig
from timeviper_tpu.data.fusion import FusionPlan
from timeviper_tpu_torch.models.cache import init_nano_cache
from timeviper_tpu_torch.models.nano import NanoModel, nano_decode_step, nano_forward
from timeviper_tpu_torch.models.projector import Projector, projector_forward
from timeviper_tpu_torch.models.vit import ViT, vit_forward


@dataclass(frozen=True)
class VLMArch:
    """Static bundle of configs, as timeviper_tpu.models.vlm.VLMArch."""

    vlm: VLMConfig
    vision: Any  # ViTConfig
    llm: Any  # NanoConfig
    llm_family: str = "nano"
    vision_family: str = "siglip"

    @property
    def tokens_per_frame(self) -> int:
        n = self.vlm.num_compressed_tokens
        return n if n > 0 else self.vision.num_patches


class TimeViperVLM(nn.Module):
    def __init__(self, arch: VLMArch, dtype=torch.bfloat16, device=None):
        super().__init__()
        if arch.llm_family != "nano" or arch.vision_family != "siglip":
            raise NotImplementedError(
                f"{arch.vision_family} + {arch.llm_family} is not ported")
        self.arch = arch
        self.vision_backbone = ViT(arch.vision, dtype, device)
        self.projector = Projector(arch.vision.hidden_size, arch.llm.hidden_size,
                                   arch.vlm.projector_type, dtype, device)
        self.llm_backbone = NanoModel(arch.llm, dtype, device)


def init_vlm_params(arch: VLMArch, generator: torch.Generator, dtype=torch.bfloat16,
                    device=None) -> TimeViperVLM:
    """Build the model on `device` with random weights drawn from `generator`
    (which must live on the same device)."""
    model = TimeViperVLM(arch, dtype, device)
    model.vision_backbone.reset_parameters(generator)
    model.projector.reset_parameters(generator)
    model.llm_backbone.reset_parameters(generator)
    return model.eval()


def encode_visual(model: TimeViperVLM, arch: VLMArch, pixels: torch.Tensor) -> torch.Tensor:
    """pixels (frames, H, W, 3) -> (frames, tokens_per_frame, llm_dim)."""
    feats = vit_forward(model.vision_backbone, arch.vision, pixels)
    n = arch.vlm.num_compressed_tokens
    return projector_forward(
        model.projector, feats, projector_type=arch.vlm.projector_type,
        num_compressed_tokens=n if n > 0 else feats.shape[1],
        token_order=arch.vlm.visual_token_order,
        compress="tome" in arch.vlm.projector_type)


def fuse_embeddings(model: TimeViperVLM, input_ids: torch.Tensor,
                    visual_embeddings: torch.Tensor, gather_idx) -> torch.Tensor:
    """One gather over concat(text embeddings, visual tokens) -> (1, L, D)."""
    text = model.llm_backbone.embeddings(input_ids)
    src = torch.cat([text, visual_embeddings.to(text.dtype)], dim=0)
    idx = torch.as_tensor(np.asarray(gather_idx), dtype=torch.long, device=src.device)
    return src[idx][None]


def vlm_forward(
    model: TimeViperVLM,
    arch: VLMArch,
    *,
    input_ids: torch.Tensor,
    plan: FusionPlan,
    pixels: Optional[torch.Tensor] = None,
    visual_embeddings: Optional[torch.Tensor] = None,
    fill_cache: bool = False,
    cache_max_len: int = 0,
    valid_from: int = 0,
    logits_to_keep: int = 0,
) -> Dict[str, Any]:
    """Prefill over one fused row: encode pixels unless visual embeddings are
    given, fuse them into the text by the plan, run the backbone."""
    emb = model.llm_backbone.embeddings.weight
    if visual_embeddings is None and pixels is not None:
        ve = encode_visual(model, arch, pixels)
        visual_embeddings = ve.reshape(-1, ve.shape[-1])
    if visual_embeddings is None:
        visual_embeddings = emb.new_zeros(0, arch.llm.hidden_size)
    if visual_embeddings.shape[0] != plan.num_visual:
        raise ValueError(f"{visual_embeddings.shape[0]} visual tokens for a plan of "
                         f"{plan.num_visual}")
    fused = fuse_embeddings(model, input_ids, visual_embeddings, plan.gather_idx)
    seq_idx = (torch.as_tensor(np.asarray(plan.seq_idx), dtype=torch.int32,
                               device=emb.device)[None]
               if plan.seq_idx is not None else None)
    return nano_forward(model.llm_backbone, arch.llm, inputs_embeds=fused, seq_idx=seq_idx,
                        fill_cache=fill_cache, cache_max_len=cache_max_len,
                        valid_from=valid_from, logits_to_keep=logits_to_keep)


def init_cache(arch: VLMArch, batch_size: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    return init_nano_cache(arch.llm, batch_size, max_len, dtype, device)


def decode_step(model: TimeViperVLM, arch: VLMArch, token: torch.Tensor, cache):
    return nano_decode_step(model.llm_backbone, arch.llm, token, cache)
