"""Host-side image preprocessing for the vision towers.

Replaces the torchvision transform pipeline (reference:
timeviper/model/vit/base_vision.py:186-262, timeviper/data/
image_processing.py). Pure numpy — this is input-pipeline work and stays on
the host; the device sees ready (F, H, W, 3) float arrays.

Three resize strategies (base_vision.py:223-262):
* resize-naive — bicubic resize straight to (S, S) (the default used by all
  released configs),
* resize-crop  — resize shortest side then center-crop,
* letterbox    — pad to square with the normalization-mean fill, then resize.

Normalization constants per family: SigLIP uses mean=std=0.5; DINOv2 uses
ImageNet stats (timm data_cfg; base_vision.py:146-161).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

NORM_STATS = {
    "siglip": (SIGLIP_MEAN, SIGLIP_STD),
    "dinov2": (IMAGENET_MEAN, IMAGENET_STD),
    "internvideo2": (IMAGENET_MEAN, IMAGENET_STD),
}


def _resize_bicubic(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Bicubic resize via PIL (host-side; matches torchvision semantics)."""
    from PIL import Image

    h, w = out_hw
    arr = img
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    return np.asarray(
        Image.fromarray(arr).resize((w, h), Image.BICUBIC), dtype=np.uint8
    )


@dataclass(frozen=True)
class ImageTransform:
    """Per-backbone transform: resize → rescale → normalize."""

    image_size: int
    mean: Tuple[float, float, float]
    std: Tuple[float, float, float]
    resize_strategy: str = "resize-naive"

    def __call__(self, frame: np.ndarray) -> np.ndarray:
        """frame: (H, W, 3) uint8 -> (S, S, 3) float32 normalized."""
        S = self.image_size
        if self.resize_strategy == "resize-naive":
            img = _resize_bicubic(frame, (S, S))
        elif self.resize_strategy == "resize-crop":
            h, w = frame.shape[:2]
            scale = S / min(h, w)
            nh, nw = int(round(h * scale)), int(round(w * scale))
            img = _resize_bicubic(frame, (nh, nw))
            top, left = (nh - S) // 2, (nw - S) // 2
            img = img[top : top + S, left : left + S]
        elif self.resize_strategy == "letterbox":
            h, w = frame.shape[:2]
            side = max(h, w)
            fill = tuple(int(255 * m) for m in self.mean)
            canvas = np.empty((side, side, 3), np.uint8)
            canvas[..., 0], canvas[..., 1], canvas[..., 2] = fill
            top, left = (side - h) // 2, (side - w) // 2
            canvas[top : top + h, left : left + w] = frame
            img = _resize_bicubic(canvas, (S, S))
        else:
            raise ValueError(self.resize_strategy)
        x = img.astype(np.float32) / 255.0
        x = (x - np.asarray(self.mean, np.float32)) / np.asarray(
            self.std, np.float32
        )
        return x

    def batch(self, frames: Sequence[np.ndarray]) -> np.ndarray:
        """list of (H, W, 3) uint8 -> (F, S, S, 3) float32.

        Uses the native threaded C++ path (data/native.py) when available
        and all frames share one shape under resize-naive; PIL otherwise.
        """
        import os

        frames = list(frames)
        if (
            self.resize_strategy == "resize-naive"
            and len(frames) > 1
            and all(f.shape == frames[0].shape for f in frames)
            and frames[0].dtype == np.uint8
            # thread-parallel native path pays off with real core counts;
            # single-threaded PIL (fixed-point SIMD) wins on tiny hosts
            and (os.cpu_count() or 1) >= 4
        ):
            from timeviper_tpu_torch.data.native import (
                native_available,
                preprocess_frames_native,
            )

            if native_available():
                return preprocess_frames_native(
                    np.stack(frames), self.image_size, self.mean, self.std
                )
        return np.stack([self(f) for f in frames], axis=0)


def transform_for_family(
    family: str, image_size: int, resize_strategy: str = "resize-naive"
) -> ImageTransform:
    mean, std = NORM_STATS[family]
    return ImageTransform(image_size, mean, std, resize_strategy)


def smart_resize(
    height: int,
    width: int,
    factor: int = 28,
    min_pixels: int = 56 * 56,
    max_pixels: int = 14 * 14 * 4 * 1280,
) -> Tuple[int, int]:
    """Qwen2-VL-style factor-aligned resize target (reference
    timeviper/data/image_processing.py:107-142): round H/W to multiples of
    `factor` while keeping the pixel count within [min_pixels, max_pixels]."""
    import math

    if max(height, width) / min(height, width) > 200:
        raise ValueError("absolute aspect ratio must be smaller than 200")
    h_bar = max(factor, round(height / factor) * factor)
    w_bar = max(factor, round(width / factor) * factor)
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = math.floor(height / beta / factor) * factor
        w_bar = math.floor(width / beta / factor) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar
