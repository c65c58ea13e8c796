"""Vision -> LLM projector (counterpart of timeviper_tpu/models/projector.py).

`tome_mlp-16`: each frame's patch tokens are ToMe-merged to 16 tokens, then a
2-layer exact-GELU MLP maps the vision width to the LLM width. Left out for
now: the 3-layer `fused_tome_mlp`, clip-joint merging over several frames
(InternVideo2) and multi-tower projectors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from timeviper_tpu_torch.ops.tome import tome_merge


class Projector(nn.Module):
    def __init__(self, vision_dim: int, llm_dim: int, projector_type: str = "tome_mlp",
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        if projector_type not in ("tome_mlp", "gelu_mlp"):
            raise NotImplementedError(f"projector `{projector_type}` is not ported")
        kw = dict(dtype=dtype, device=device)
        self.fc1 = nn.Linear(vision_dim, llm_dim, **kw)
        self.fc2 = nn.Linear(llm_dim, llm_dim, **kw)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for lin in (self.fc1, self.fc2):
            lin.weight.normal_(0.0, 0.02, generator=generator)
            lin.bias.zero_()


def apply_mlp(proj: Projector, x: torch.Tensor) -> torch.Tensor:
    return proj.fc2(F.gelu(proj.fc1(x)))


def projector_forward(
    proj: Projector,
    patch_features: torch.Tensor,
    *,
    projector_type: str = "tome_mlp",
    num_compressed_tokens: int = 16,
    token_order: str = "raw",
    compress: bool = True,
) -> torch.Tensor:
    """(frames, patches, vision_dim) -> (frames, tokens_out, llm_dim)."""
    x = patch_features
    if "tome" in projector_type and compress:
        x = tome_merge(x, num_compressed_tokens, token_order=token_order)
    return apply_mlp(proj, x)
