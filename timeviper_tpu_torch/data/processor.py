"""Combined processor: tokenizer + image transform.

TPU re-design of Qwen2VLProcessor / ImageProcessor (reference:
timeviper/data/processor.py:62-242, image_processing.py:145-466): one object
that turns (text, frames) into model-ready arrays. Routing matches the
reference: a list of frames -> images; a list of lists -> videos
(processor.py:89-148). TimeViper operating point: temporal_patch_size=1,
merge_size=1 (image_processing.py:199-200) — every frame stands alone and
maps to one `<image>` placeholder expanding to `tokens_per_frame` projected
tokens.

The tokenizer is any HF `PreTrainedTokenizer`; `attach_special_tokens` adds
the `<image>` placeholder and resolves terminator ids the way the registry
init hooks do (reference llm_registry.py:37-62: qwen2 -> <|im_end|>, nano ->
<SPECIAL_12>).
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from timeviper_tpu_torch.data.image_processing import ImageTransform

IMAGE_TOKEN = "<image>"


def _keep_extra_special_tokens(tokenizer) -> Dict[str, bool]:
    """The keyword that has `add_special_tokens` keep the tokenizer's own
    extra special tokens (both replace them by default): transformers 4 names
    it `replace_additional_special_tokens`, transformers 5
    `replace_extra_special_tokens`."""
    params = inspect.signature(tokenizer.add_special_tokens).parameters
    for kw in ("replace_additional_special_tokens", "replace_extra_special_tokens"):
        if kw in params:
            return {kw: False}
    raise TypeError("add_special_tokens takes neither replace_additional_special_tokens nor "
                    "replace_extra_special_tokens: it could drop the tokenizer's own special "
                    "tokens")


def attach_special_tokens(tokenizer, llm_family: str) -> Dict[str, Any]:
    """Add `<image>` and resolve terminators (llm_registry.py:37-62)."""
    added = tokenizer.add_special_tokens({"additional_special_tokens": [IMAGE_TOKEN]},
                                         **_keep_extra_special_tokens(tokenizer))
    image_token_id = tokenizer.convert_tokens_to_ids(IMAGE_TOKEN)
    if llm_family == "nano":
        terminators = [tokenizer.convert_tokens_to_ids("<SPECIAL_12>")]
    else:
        terminators = [tokenizer.convert_tokens_to_ids("<|im_end|>")]
    terminators = [t for t in terminators if t is not None and t >= 0]
    if tokenizer.eos_token_id is not None and tokenizer.eos_token_id not in terminators:
        terminators.append(tokenizer.eos_token_id)
    return {
        "image_token_id": image_token_id,
        "terminator_ids": terminators,
        "num_added": added,
    }


@dataclass
class Processor:
    tokenizer: Any
    image_transform: ImageTransform
    image_token_id: int
    terminator_ids: List[int]

    @classmethod
    def build(cls, tokenizer, image_transform: ImageTransform, llm_family: str):
        info = attach_special_tokens(tokenizer, llm_family)
        return cls(
            tokenizer=tokenizer,
            image_transform=image_transform,
            image_token_id=info["image_token_id"],
            terminator_ids=info["terminator_ids"],
        )

    # -- text -------------------------------------------------------------

    def tokenize(self, text: str, add_special_tokens: bool = False) -> List[int]:
        return self.tokenizer.encode(text, add_special_tokens=add_special_tokens)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self.tokenizer.decode(ids, skip_special_tokens=skip_special_tokens)

    # -- vision -----------------------------------------------------------

    def process_frames(self, frames: Sequence[np.ndarray]) -> np.ndarray:
        """list of (H, W, 3) uint8 frames -> (F, S, S, 3) float32."""
        return self.image_transform.batch(frames)

    # -- combined ---------------------------------------------------------

    def __call__(
        self,
        text: str,
        videos: Optional[Sequence[Sequence[np.ndarray]]] = None,
        images: Optional[Sequence[np.ndarray]] = None,
    ) -> Dict[str, Any]:
        """Returns {"input_ids": (L,) int32, "pixels": (F, S, S, 3) | None}.

        `text` must contain one `<image>` per frame (the caller expands
        `<image>` per frame count, matching the reference collator's
        placeholder expansion).
        """
        pixels = None
        if videos is not None:
            frames: List[np.ndarray] = [f for clip in videos for f in clip]
            pixels = self.process_frames(frames)
        elif images is not None:
            pixels = self.process_frames(list(images))
        ids = np.asarray(self.tokenize(text), np.int32)
        n_placeholder = int((ids == self.image_token_id).sum())
        if pixels is not None and n_placeholder != pixels.shape[0]:
            raise ValueError(
                f"{n_placeholder} <image> placeholders but {pixels.shape[0]} frames"
            )
        return {"input_ids": ids, "pixels": pixels}
