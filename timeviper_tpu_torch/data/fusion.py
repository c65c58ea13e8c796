"""Host-side fusion planning: where the visual tokens go in the fused row (the
port's own numpy-only copy of FusionPlan, plan_fusion and fuse_labels from
timeviper_tpu/data/fusion.py; tests/test_torch_config.py holds them equal).

The model applies a plan as one gather over concat(text embeddings, visual
tokens). One `<image>` placeholder expands to one frame's `tokens_per_frame`
projected tokens; packed rows get block-diagonal segment ids.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

IGNORE_INDEX = -100


@dataclass(frozen=True)
class FusionPlan:
    """Plan for fusing one (possibly packed) row. gather_idx[i] indexes
    concat([text (Lt), visual (Nv)]): values < Lt are text positions, values
    >= Lt are visual token indices + Lt."""

    fused_len: int
    text_len: int
    num_visual: int
    gather_idx: np.ndarray  # (fused_len,) int32
    is_visual: np.ndarray  # (fused_len,) bool
    seq_idx: Optional[np.ndarray]  # (fused_len,) int32, None when unpacked
    position_ids: np.ndarray  # (fused_len,) int32, restarting per sample
    # per-sample layout: (vision_start, num_vision, text_suffix)
    sample_layouts: Tuple[Tuple[int, int, int], ...]


def plan_fusion(
    input_ids: Sequence[int],
    image_token_id: int,
    tokens_per_frame: int,
    txt_seq_lens: Optional[Sequence[int]] = None,
) -> FusionPlan:
    """Build the fusion plan for one row. txt_seq_lens: packed per-sample
    token lengths (image placeholders included); None = unpacked."""
    ids = np.asarray(input_ids, np.int64)
    Lt = len(ids)
    if txt_seq_lens is None:
        txt_seq_lens = [Lt]
    if sum(txt_seq_lens) != Lt:
        raise ValueError(f"txt_seq_lens sum to {sum(txt_seq_lens)}, the row has {Lt}")

    gather: List[int] = []
    seq: List[int] = []
    pos: List[int] = []
    layouts: List[Tuple[int, int, int]] = []
    vis_counter = 0
    text_off = 0
    for si, tl in enumerate(txt_seq_lens):
        sample = ids[text_off: text_off + tl]
        img_pos = np.nonzero(sample == image_token_id)[0]
        sample_start_fused = len(gather)
        if len(img_pos) == 0:
            vision_start, num_vision = tl, 0
            gather.extend(text_off + j for j in range(tl))
        else:
            first, last = int(img_pos[0]), int(img_pos[-1])
            if not np.all(np.diff(img_pos) == 1):
                raise ValueError("interleaved vision tokens are not supported: the "
                                 "<image> placeholders of a sample must be contiguous")
            vision_start = first
            num_vision = len(img_pos) * tokens_per_frame
            gather.extend(text_off + j for j in range(first))
            gather.extend(Lt + vis_counter + v for v in range(num_vision))
            vis_counter += num_vision
            gather.extend(text_off + j for j in range(last + 1, tl))
        fused_sample_len = len(gather) - sample_start_fused
        layouts.append((vision_start, num_vision,
                        fused_sample_len - vision_start - num_vision))
        seq.extend([si] * fused_sample_len)
        pos.extend(range(fused_sample_len))
        text_off += tl

    gather_idx = np.asarray(gather, np.int32)
    return FusionPlan(
        fused_len=len(gather),
        text_len=Lt,
        num_visual=vis_counter,
        gather_idx=gather_idx,
        is_visual=gather_idx >= Lt,
        seq_idx=np.asarray(seq, np.int32) if len(txt_seq_lens) > 1 else None,
        position_ids=np.asarray(pos, np.int32),
        sample_layouts=tuple(layouts),
    )


def fuse_labels(plan: FusionPlan, labels: Sequence[int]) -> np.ndarray:
    """Expand per-token labels to the fused layout; visual spans get
    IGNORE_INDEX."""
    lab = np.asarray(labels, np.int64)
    out = np.full((plan.fused_len,), IGNORE_INDEX, np.int64)
    text_mask = ~plan.is_visual
    out[text_mask] = lab[plan.gather_idx[text_mask]]
    return out
