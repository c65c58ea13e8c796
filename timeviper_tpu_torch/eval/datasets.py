"""Evaluation datasets: per-datatype prompt building + frame loading.

Re-design of the reference eval datasets (eval/vllm_inference/
data/__init__.py:386-569): each item becomes a prompt string with one
`<image>` per sampled frame, model-ready pixels, and the scoring metadata.
Resumability (skip finished qids) and zigzag job sharding match the
reference (evaluate.py:320-332; data/__init__.py:342-371).

Prompt formats (must match for score parity):
* MCQ — question + options + "Please provide your answer by stating the
  letter followed by the full option." with answer prompt "Best Option: ("
  injected at generation (data/__init__.py:470-506).
* TVG — timestamp preamble + grounding instruction w/ example format
  (data/__init__.py:509-529, template index -6 == the "'start to end'
  seconds. A specific example" variant).
* Caption — DVC event-listing instruction, or AuroraCap per-style prompt
  (data/__init__.py:532-553).
"""

from __future__ import annotations

import random
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from timeviper_tpu_torch.data.conversation import ChatTemplate
from timeviper_tpu_torch.data.templates import TIMESTAMP_PROMPT
from timeviper_tpu_torch.eval.scoring import zigzag_split

MCQ_SUFFIX = (
    "Please provide your answer by stating the letter followed by the full "
    "option."
)
MCQ_ANSWER_PROMPT = "Best Option: ("

TVG_INSTRUCTION = (
    "Localize the visual content described by the given textual query {} in "
    "the video, and output the start and end timestamps in seconds. The "
    "output format of the predicted timestamp should be like: 'start to "
    "end' seconds. A specific example is : 20.8 to 30.0 seconds'."
)

DVC_INSTRUCTION = (
    "Localize a series of activity events in the video, output the start "
    "and end timestamp for each event, and describe each event with "
    "sentences. The output format of each predicted event should be like: "
    "start - end seconds, event description. A specific example is: 90 - "
    "102 seconds, spread margarine on two slices of white bread in the "
    "video."
)

AURORACAP_PROMPTS = {
    "detailed": (
        "Please imagine the video based on the sequence of frames, and "
        "provide a faithfully detailed description of this video in more "
        "than three sentences."
    ),
    "background": (
        "Summarize the background of the video, including details about "
        "the location, objects, weather, and time."
    ),
    "short": "Write a one-sentence summary of the video.",
    "main_object": (
        "Describe the main subject, including their attributes and "
        "movements throughout the video."
    ),
    "camera": (
        "Summarize the camera actions and changes in shooting angles "
        "during the video."
    ),
}


@dataclass
class EvalSampleConfig:
    fps: float = 1.0
    min_frames: int = 32
    max_frames: int = 256
    sampling: str = "fps"  # "fps" | "uniform"
    num_frames: int = 64   # for uniform


def build_user_prompt(item: Dict[str, Any], datatype: str, num_frames: int) -> str:
    if datatype == "mcq":
        return "\n".join(
            [item["question"], "\n".join(item["options"]), MCQ_SUFFIX]
        )
    if datatype == "tg":
        ts = TIMESTAMP_PROMPT.format(item["duration"], num_frames)
        return f"{ts} {TVG_INSTRUCTION.format(item['sentence'])}"
    if datatype == "caption":
        if str(item.get("qid", "")).startswith("auroracap"):
            return AURORACAP_PROMPTS[item["task_type"]]
        ts = TIMESTAMP_PROMPT.format(item["duration"], num_frames)
        return f"{ts} {DVC_INSTRUCTION}"
    raise ValueError(datatype)


# decoded-clip LRU: 256 frames x 224^2 x 3 uint8 ~ 38 MB per entry
VIDEO_CACHE_SIZE = 8
_VIDEO_CACHE: "OrderedDict[tuple, np.ndarray]" = OrderedDict()


class EvalDataset:
    """Iterates benchmark records -> model inputs + scoring metadata."""

    def __init__(
        self,
        records: Sequence[Dict[str, Any]],
        datatype: str,
        processor,
        template: ChatTemplate,
        sample_cfg: EvalSampleConfig = EvalSampleConfig(),
        curr_idx: int = 0,
        total_idx: int = 1,
        finished_qids: Optional[set] = None,
        video_loader=None,
    ) -> None:
        records = list(records)
        if total_idx > 1:
            records = zigzag_split(records, curr_idx, total_idx)
        if finished_qids:
            records = [r for r in records if r["qid"] not in finished_qids]
        self.records = records
        self.datatype = datatype
        self.processor = processor
        self.template = template
        self.cfg = sample_cfg
        self.video_loader = video_loader

    def __len__(self) -> int:
        return len(self.records)

    def _load_frames(self, item) -> np.ndarray:
        if self.video_loader is not None:
            return self.video_loader(item, self.cfg)
        # benchmarks ask many questions about one video; cache decoded
        # clips (the reference's LimitedSizeSharedDict, eval/vllm_inference/
        # data/__init__.py:112 — ours is in-process, eval is one process)
        key = (item["video"], self.cfg.sampling, self.cfg.fps,
               self.cfg.num_frames, self.cfg.min_frames, self.cfg.max_frames)
        cached = _VIDEO_CACHE.get(key)
        if cached is not None:
            _VIDEO_CACHE.move_to_end(key)
            return cached
        from timeviper_tpu_torch.data.video import load_video

        frames, _, _ = load_video(
            item["video"],
            sampling=self.cfg.sampling,
            fps=self.cfg.fps,
            num_frames=self.cfg.num_frames,
            min_frames=self.cfg.min_frames,
            max_frames=self.cfg.max_frames,
        )
        _VIDEO_CACHE[key] = frames
        while len(_VIDEO_CACHE) > VIDEO_CACHE_SIZE:
            _VIDEO_CACHE.popitem(last=False)
        return frames

    def video_key(self, idx: int) -> str:
        """Identity of the video behind item `idx` — the prefix-cache key
        (same video + same sampling config => same visual prefix)."""
        return str(self.records[idx]["video"])

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        item = self.records[idx]
        frames = self._load_frames(item)
        nf = frames.shape[0]
        user = build_user_prompt(item, self.datatype, nf)
        prompt = self.template.prompt_for_generation(
            "<image>" * nf + "\n" + user
        )
        enc = self.processor(prompt, videos=[list(frames)])
        out = {
            "input_ids": enc["input_ids"],
            "pixels": enc["pixels"],
            "qid": item["qid"],
            "duration": item.get("duration"),
            "task_type": item.get("task_type"),
        }
        if self.datatype == "mcq":
            out["target"] = item["answer"]
            out["options"] = [chr(65 + i) for i in range(len(item["options"]))]
        elif self.datatype == "tg":
            out["target"] = item["timestamp"]
        else:
            out["target"] = item["answer"]
        return out
