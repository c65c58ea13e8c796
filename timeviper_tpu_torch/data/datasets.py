"""Training datasets: media load w/ retry, conversation build, tokenize,
label masking, task variants, packing, YAML-config factory (the port's own
copy of timeviper_tpu/data/datasets.py, which imports no JAX; tests/
test_torch_host_pipeline.py holds the two equal).

Re-design of the reference pipeline (timeviper/data/data.py:46-734).
Differences by design:

* Items come out as numpy dicts shaped for `plan_fusion` (static fusion
  plans) rather than torch BatchFeatures.
* Packing emits `txt_seq_lens` exactly like PackedDataset (data.py:570) so
  the fused row gets per-sample segment ids (SSD `seq_idx` + block-diag
  attention).
* Corrupt-sample retry substitutes a random item, up to `num_tries`
  (data.py:208-220).

Label masking follows the separator rule (data.py:418-443): split the token
stream at separator-token positions; alternate spans are user (IGNORE) vs
assistant (supervised); with no system prompt, parity flips.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from timeviper_tpu_torch.data.conversation import CONV_TEMPLATES, ChatTemplate
from timeviper_tpu_torch.data.templates import (
    CAPTION_USER_TEMPLATES,
    TIMESTAMP_PROMPT,
    TVG_USER_TEMPLATES,
)

IGNORE_INDEX = -100
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_VIDEO_TOKEN = "<video>"
TOKEN_SEP = "\n"


def mask_labels_by_separator(
    input_ids: np.ndarray, sep_id: int, has_system: bool
) -> np.ndarray:
    """Separator-alternation label masking (reference data.py:428-441)."""
    labels = np.full_like(input_ids, IGNORE_INDEX)
    sep_idxs = np.nonzero(input_ids == sep_id)[0].tolist()
    skip = 0 if has_system else 1
    for i in range(len(sep_idxs)):
        if i % 2 == skip:
            continue
        start = sep_idxs[i] + 1
        end = sep_idxs[i + 1] + 1 if i + 1 < len(sep_idxs) else len(input_ids)
        labels[start:end] = input_ids[start:end]
    return labels


@dataclass
class DatasetConfig:
    json_path: str
    data_path: str = ""
    format: str = "conversation"  # caption | tvg | dvc | conversation[_packed]
    sampling: str = "uniform"
    num_frames: int = 16
    fps: float = 1.0
    min_frames: int = 4
    max_frames: int = 256
    max_txt_seq_len: int = 32768
    pack_size: int = 1
    split: Tuple[int, int] = (0, -1)  # [start, end) over the item list
    use_template: bool = True
    num_tries: int = 5


class BaseMultimodalDataset:
    """Loads media, builds the conversation, tokenizes, masks labels."""

    def __init__(
        self,
        cfg: DatasetConfig,
        processor,
        template: ChatTemplate,
        video_loader: Optional[Callable] = None,
    ) -> None:
        self.cfg = cfg
        self.processor = processor
        self.template = template
        self.video_loader = video_loader
        with open(cfg.json_path) as f:
            data = json.load(f)
        s, e = cfg.split
        if e == -1:
            e = len(data)
        self.data: List[Dict] = data[s:e]
        self.sep_id = processor.tokenizer.convert_tokens_to_ids(template.sep)

    def __len__(self) -> int:
        return len(self.data)

    # -- media -----------------------------------------------------------

    def _load_media(self, item: Dict) -> Tuple[np.ndarray, float, int]:
        """Returns (frames (F,H,W,3) uint8, duration_sec, num_frames)."""
        if self.video_loader is not None:
            return self.video_loader(item, self.cfg)
        from timeviper_tpu_torch.data.video import load_video

        path = os.path.join(self.cfg.data_path, item.get("video", item.get("image", "")))
        frames, ts, meta = load_video(
            path,
            sampling=self.cfg.sampling,
            fps=self.cfg.fps,
            num_frames=self.cfg.num_frames,
            min_frames=self.cfg.min_frames,
            max_frames=self.cfg.max_frames,
        )
        return frames, meta.duration, frames.shape[0]

    # -- conversation ----------------------------------------------------

    def build_conversation(
        self, item: Dict, num_frames: int
    ) -> List[Tuple[str, str]]:
        """Default: pass item["conversations"] through, splicing the frame
        placeholders into the first human turn (data.py:273-306)."""
        token_str = DEFAULT_IMAGE_TOKEN * num_frames
        messages: List[Tuple[str, str]] = []
        for i, sentence in enumerate(item["conversations"]):
            role = "user" if sentence["from"] == "human" else "assistant"
            value = sentence["value"]
            if sentence["from"] == "human" and DEFAULT_IMAGE_TOKEN in value:
                value = value.replace(DEFAULT_IMAGE_TOKEN, token_str)
            elif i == 0 and sentence["from"] == "human":
                value = f"{token_str}{TOKEN_SEP}{value}"
            messages.append((role, value))
        return messages

    # -- item processing -------------------------------------------------

    def process_item(self, item: Dict) -> Dict[str, Any]:
        frames, duration, nf = self._load_media(item)
        messages = self.build_conversation(
            dict(item, duration=round(duration, 1)), nf
        )
        prompt = self.template.render(messages)
        enc = self.processor(prompt, videos=[list(frames)] if nf else None)
        ids = enc["input_ids"][: self.cfg.max_txt_seq_len]
        labels = mask_labels_by_separator(
            ids, self.sep_id, bool(self.template.system)
        )
        # never supervise the image placeholders
        labels = np.where(ids == self.processor.image_token_id, IGNORE_INDEX,
                          labels)
        return {
            "input_ids": ids,
            "labels": labels,
            "pixels": enc["pixels"],
            "duration": duration,
        }

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        """Retry w/ random substitution on corrupt samples (data.py:208-220)."""
        for attempt in range(self.cfg.num_tries):
            try:
                return self.process_item(self.data[idx])
            except Exception as e:  # noqa: BLE001 — data corruption guard
                if attempt == self.cfg.num_tries - 1:
                    raise
                import warnings

                warnings.warn(
                    f"sample {idx} failed ({type(e).__name__}: {e}); retrying "
                    f"with a random substitute [{attempt + 1}/{self.cfg.num_tries}]"
                )
                idx = random.randrange(len(self.data))
        raise RuntimeError("unreachable")


class CaptioningDataset(BaseMultimodalDataset):
    """Caption items {"video", "caption"} (reference data.py:451-466)."""

    def build_conversation(self, item, num_frames):
        token_str = DEFAULT_IMAGE_TOKEN * num_frames
        template = random.choice(CAPTION_USER_TEMPLATES)
        user = f"{token_str}{TOKEN_SEP}{template.format('video')}"
        return [("user", user), ("assistant", item["caption"])]


class TemporalVideoGroundingDataset(BaseMultimodalDataset):
    """TVG items with timestamped answers (reference data.py:469-500)."""

    def build_conversation(self, item, num_frames):
        token_str = DEFAULT_IMAGE_TOKEN * num_frames
        ts_prompt = TIMESTAMP_PROMPT.format(item["duration"], num_frames)
        template = (
            random.choice(TVG_USER_TEMPLATES) if self.cfg.use_template else "{}"
        )
        messages: List[Tuple[str, str]] = []
        for i, sentence in enumerate(item["conversations"]):
            role = "user" if sentence["from"] == "human" else "assistant"
            value = sentence["value"]
            if i % 2 == 0 and sentence["from"] == "human":
                value = value.replace(DEFAULT_IMAGE_TOKEN, "")
                value = f"{token_str}{TOKEN_SEP}{ts_prompt}{template.format(value)}"
            messages.append((role, value))
        return messages


class DenseVideoCaptioningDataset(BaseMultimodalDataset):
    """DVC: timestamp preamble, conversations untemplated (data.py:503-527)."""

    def build_conversation(self, item, num_frames):
        token_str = DEFAULT_IMAGE_TOKEN * num_frames
        ts_prompt = TIMESTAMP_PROMPT.format(item["duration"], num_frames)
        messages: List[Tuple[str, str]] = []
        for i, sentence in enumerate(item["conversations"]):
            role = "user" if sentence["from"] == "human" else "assistant"
            value = sentence["value"]
            if i % 2 == 0 and sentence["from"] == "human":
                value = value.replace(DEFAULT_IMAGE_TOKEN, "")
                value = f"{token_str}{TOKEN_SEP}{ts_prompt}{value}"
            messages.append((role, value))
        return messages


class PackedDataset:
    """N consecutive conversations -> one packed row; emits `txt_seq_lens`
    (reference data.py:535-590)."""

    def __init__(self, dataset: BaseMultimodalDataset, pack_size: int):
        self.dataset = dataset
        self.pack_size = pack_size
        idxs = list(range(len(dataset)))
        self.packed_indices = [
            idxs[i : i + pack_size] for i in range(0, len(idxs), pack_size)
        ]

    def __len__(self) -> int:
        return len(self.packed_indices)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        items = [self.dataset[i] for i in self.packed_indices[idx]]
        pixels = [it["pixels"] for it in items if it["pixels"] is not None]
        return {
            "input_ids": np.concatenate([it["input_ids"] for it in items]),
            "labels": np.concatenate([it["labels"] for it in items]),
            "pixels": np.concatenate(pixels, axis=0) if pixels else None,
            "txt_seq_lens": [len(it["input_ids"]) for it in items],
        }


DATASET_CLASSES = {
    "caption": CaptioningDataset,
    "tvg": TemporalVideoGroundingDataset,
    "dvc": DenseVideoCaptioningDataset,
    "conversation": BaseMultimodalDataset,
}


def create_dataset(
    cfg: DatasetConfig,
    processor,
    template: ChatTemplate,
    video_loader=None,
):
    """Factory dispatch on `format` (+`_packed` wraps in PackedDataset),
    reference DatasetFactory semantics (data.py:673-734)."""
    fmt = cfg.format
    packed = fmt.endswith("_packed")
    if packed:
        fmt = fmt[: -len("_packed")]
    ds = DATASET_CLASSES[fmt](cfg, processor, template, video_loader)
    if packed and cfg.pack_size > 1:
        return PackedDataset(ds, cfg.pack_size)
    return ds


def load_data_from_config(
    yaml_path: str, processor, template_name: str = "nano_base",
    video_loader=None,
):
    """YAML data config -> concatenated dataset list (data.py:733-734).

    YAML schema mirrors the reference: a `datasets:` list of entries with
    `format`, `json_path`, `data_path`, sampling params, `pack_size`,
    `split` (§5.6 mechanism 3).
    """
    import yaml

    with open(yaml_path) as f:
        spec = yaml.safe_load(f)
    template = CONV_TEMPLATES[template_name]
    out = []
    for entry in spec["datasets"]:
        split = tuple(entry.get("split", (0, -1)))
        cfg = DatasetConfig(
            json_path=entry["json_path"],
            data_path=entry.get("data_path", ""),
            format=entry.get("format", "conversation"),
            sampling=entry.get("sampling", "uniform"),
            num_frames=int(entry.get("num_frames", 16)),
            fps=float(entry.get("fps", 1.0)),
            min_frames=int(entry.get("min_frames", 4)),
            max_frames=int(entry.get("max_frames", 256)),
            max_txt_seq_len=int(entry.get("max_txt_seq_len", 32768)),
            pack_size=int(entry.get("pack_size", 1)),
            split=split,
            use_template=bool(entry.get("use_template", True)),
        )
        out.append(create_dataset(cfg, processor, template, video_loader))
    return out


class ConcatDataset:
    def __init__(self, datasets: Sequence[Any]):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1]) if len(self.datasets) else 0

    def __getitem__(self, idx):
        d = int(np.searchsorted(self.offsets, idx, side="right"))
        prev = int(self.offsets[d - 1]) if d else 0
        return self.datasets[d][idx - prev]
