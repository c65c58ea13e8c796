"""Vision -> LLM projector (counterpart of timeviper_tpu/models/projector.py).

`tome_mlp-16`: each frame's patch tokens are ToMe-merged to 16 tokens, then a
2-layer exact-GELU MLP maps the vision width to the LLM width. With
`local_num_frames` > 1 (InternVideo2's clips of 4) a group of frames is merged
jointly to 16 tokens a frame and split back per frame. A multi-tower model
holds one projector per tower (models/vlm.py). `fused_tome_mlp` puts a third
layer first, `fc0` (vision width -> 4 x vision width, exact GELU), as the JAX
package does (timeviper_tpu/models/projector.py:47-61).
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
        if projector_type not in ("tome_mlp", "gelu_mlp", "fused_tome_mlp"):
            raise ValueError(f"Projector `{projector_type}` is not supported!")
        kw = dict(dtype=dtype, device=device)
        self.fc0 = None
        if projector_type == "fused_tome_mlp":
            self.fc0 = nn.Linear(vision_dim, 4 * vision_dim, **kw)
            vision_dim *= 4
        self.fc1 = nn.Linear(vision_dim, llm_dim, **kw)
        self.fc2 = nn.Linear(llm_dim, llm_dim, **kw)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for lin in (self.fc0, self.fc1, self.fc2):
            if lin is None:
                continue
            lin.weight.normal_(0.0, 0.02, generator=generator)
            lin.bias.zero_()


def apply_mlp(proj: Projector, x: torch.Tensor) -> torch.Tensor:
    if proj.fc0 is not None:
        x = F.gelu(proj.fc0(x))
    return proj.fc2(F.gelu(proj.fc1(x)))


def projector_forward(
    proj: Projector,
    patch_features: torch.Tensor,
    *,
    projector_type: str = "tome_mlp",
    num_compressed_tokens: int = 16,
    local_num_frames: int = 1,
    token_order: str = "raw",
    compress: bool = True,
) -> torch.Tensor:
    """(frames, patches, vision_dim) -> (frames, tokens_out, llm_dim). With
    `local_num_frames` > 1, each group of that many frames is merged jointly
    to num_compressed_tokens * local_num_frames tokens, projected, and split
    back to num_compressed_tokens a frame."""
    if not ("tome" in projector_type and compress):
        return apply_mlp(proj, patch_features)
    Fn, P, C = patch_features.shape
    lnf = max(local_num_frames, 1)
    if Fn % lnf:
        raise ValueError(f"{Fn} frames do not group by local_num_frames={lnf}")
    x = patch_features.reshape(Fn // lnf, lnf * P, C)
    x = apply_mlp(proj, tome_merge(x, num_compressed_tokens * lnf, token_order=token_order))
    return x.reshape(Fn, num_compressed_tokens, -1) if lnf > 1 else x
