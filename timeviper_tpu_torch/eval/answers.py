"""Answer extraction from generated text, per datatype.

Matches the reference's regex semantics exactly so scores are comparable
(reference: evaluate.py:252-299, eval/vllm_inference/utils.py:68-83):

* tg — last "X to/and Y" match (falling back to an <answer>...</answer> span)
  parsed as [start, end] floats,
* mcq — first character (or the one after "("), mapped A->0,
* caption — DVC "start - end seconds, description" lines parsed into
  timestamps + captions.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

_TG_SPAN = re.compile(r"(\d+\.?\d*) (to|and) (\d+\.?\d*)")
_TG_ANSWER_TAG = re.compile(r"<answer>(.*?)</answer>")

# dataset name -> datatype (reference eval/vllm_inference/utils.py:68-83)
DATASET_TYPES: Dict[str, str] = {
    "activitynet": "tg",
    "charades": "tg",
    "tvgbench": "tg",
    "tvgbench_filter": "tg",
    "videomme": "mcq",
    "egoschema": "mcq",
    "mlvu": "mcq",
    "longvideobench": "mcq",
    "lvbench": "mcq",
    "tempcompass": "mcq",
    "mvbench": "mcq",
    "cgbench": "mcq",
    "auroracap": "caption",
    "youcook2": "caption",
}


def get_dataset_type(dataset_name: str) -> str:
    return DATASET_TYPES[dataset_name]


def extract_tg(text: str) -> List[Optional[float]]:
    matches = _TG_SPAN.findall(text)
    if not matches:
        tag = _TG_ANSWER_TAG.search(text)
        if tag:
            matches = _TG_SPAN.findall(tag.group(1).strip())
        if not matches:
            return [None, None]
    last = matches[-1]
    try:
        return [float(last[0]), float(last[2])]
    except ValueError:
        return [None, None]


def extract_mcq(text: str) -> Optional[int]:
    try:
        letter = text[1] if text[0] == "(" else text[0]
    except Exception:
        letter = "A"
    return ord(letter) - ord("A")


# --- DVC prediction parsing (reference eval_dvc.py:605-783 semantics) ---
#
# The reference recovers (timestamps, captions) from free-form generated
# text in two passes: a paragraph-level sweep over "N - M" / "Start time:
# N ... End time: M" layouts (extract_time_from_para, eval_dvc.py:655-726),
# then a per-sentence pass that splits on "seconds" and widens single
# timestamps / mm:ss stamps into +-20 s windows (extract_time_part,
# eval_dvc.py:605-653). Scores are only comparable if the parse is
# identical, so these match the reference behavior exactly — validated
# against the live functions in tests/test_answers_parity.py.

_PARA_TIME = r"(?:from\s*)?(\d+\.*\d*)\s*(?:-|to)\s*(\d+\.*\d*)"
_PARA_SPAN = r"((?:from\s*)?\d+\.*\d*\s*(?:-|to)\s*\d+\.*\d*)"
_MMSS = re.compile(r"\d+\.*\d*:\d+\.*\d*")
_RANGE = re.compile(r"\d+\.*\d*\s*-\s*\d+\.*\d*")
_PLAIN_NUM = re.compile(r"\d+\.*\d*(?!\.)")
_DVC_RADIUS = 20


def _extract_time_part(time_part: str) -> List[str]:
    """Normalize one sentence's time fragment to ["S - E"] strings
    (reference extract_time_part, eval_dvc.py:605-653): explicit ranges
    pass through; a single "m:ss" stamp becomes a +-20 s window; "m:ss to
    m:ss" converts to seconds; a lone number widens to +-20 s; two loose
    numbers pair up."""
    out = _RANGE.findall(time_part)
    if not out:
        if time_part.count(":") == 1:
            t = _MMSS.findall(time_part)[0]
            sec = int(t.split(":")[0]) * 60 + int(t.split(":")[1])
            if sec > _DVC_RADIUS:
                out = [f"{sec - _DVC_RADIUS} - {sec + _DVC_RADIUS}"]
            else:
                out = [f"{sec} - {sec + 2 * _DVC_RADIUS}"]
        elif time_part.count(":") == 2:
            start, end = _MMSS.findall(time_part)
            s = int(start.split(":")[0]) * 60 + int(start.split(":")[1])
            e = int(end.split(":")[0]) * 60 + int(end.split(":")[1])
            out = [f"{s} - {e}"]
    if not out:
        nums = _PLAIN_NUM.findall(time_part)
        if len(nums) == 1:
            t = float(nums[0])
            if t > _DVC_RADIUS:
                out = [f"{t - _DVC_RADIUS} - {t + _DVC_RADIUS}"]
            else:
                out = [f"{t} - {t + 2 * _DVC_RADIUS}"]
        elif len(nums) == 2:
            out = [f"{nums[0]} - {nums[1]}"]
        else:
            out = nums
    return out


def _extract_time_from_para(paragraph: str) -> Tuple[list, list]:
    """Paragraph-level timestamp sweep (reference extract_time_from_para,
    eval_dvc.py:655-726). Known reference defect NOT reproduced: its
    'start time X, end time Y' branch keeps timestamps as string tuples
    and hits a stray pdb.set_trace() (eval_dvc.py:705-717); here that
    branch converts to floats and never drops into a debugger."""
    paragraph = paragraph.lower()
    timestamps: list = []
    captions: list = []

    time_matches = re.findall(_PARA_TIME, paragraph, re.IGNORECASE)
    if time_matches:
        timestamps = [[float(s), float(e)] for s, e in time_matches]
        rest = paragraph
        for span in re.findall(_PARA_SPAN, paragraph, re.IGNORECASE):
            rest = rest.replace(span, "\n")
        captions = rest.replace("seconds", "").split("\n")

    if not timestamps:
        starts = re.findall(
            r"(?:start(?:ing)? time: (\d+\.*\d*)(?:s| seconds)?)",
            paragraph, re.DOTALL | re.IGNORECASE)
        ends = re.findall(
            r"(?:end(?:ing)? time: (\d+\.*\d*)(?:s| seconds)?)",
            paragraph, re.DOTALL | re.IGNORECASE)
        if starts and ends:
            timestamps = [[float(s), float(e)]
                          for s, e in zip(starts, ends)]
            captions = re.findall(r"description: (.*)", paragraph)
            if not captions:
                captions = re.findall(r"\*\s*(.*)", paragraph)

    if not timestamps:
        pairs = re.findall(
            r"start time (\d+\.*\d*), end time (\d+\.*\d*)", paragraph)
        if pairs:
            timestamps = [[float(s), float(e)] for s, e in pairs]
            for s, e in pairs:
                paragraph = paragraph.replace(
                    f"start time {s}, end time {e}", "\n")
            captions = paragraph.split("\n")

    captions = [c.strip().strip(", ").rstrip() for c in captions
                if len(c) > 5]
    n = min(len(timestamps), len(captions))
    return timestamps[:n], captions[:n]


def parse_dvc_prediction(caption: str) -> Tuple[list, list]:
    """(timestamps, captions) from a generated DVC paragraph (reference
    parse_dvc_prediction, eval_dvc.py:728-783): paragraph-level sweep
    first, then per-sentence "…seconds, …" parsing."""
    timestamps, sents = _extract_time_from_para(caption)

    if not timestamps:
        caps: List[str] = []
        if "\n" in caption:
            caps = [c for c in caption.split("\n") if len(c) > 7]
        if len(caps) <= 1:
            caps = [c + "." for c in caption.split(". ") if len(c) > 7]
        for cap in caps:
            try:
                parts = [p.strip(",") for p in cap.split("seconds")]
                extracted = _extract_time_part(parts[0])
                if not extracted:
                    continue
                time_part = extracted[0]
                stime = round(float(time_part.split("-")[0].strip()), 2)
                etime = round(float(time_part.split("-")[1].strip()), 2)
                timestamps.append([stime, etime])
                sents.append(parts[-1].strip())
            except Exception:
                continue

    return timestamps, sents


def extract_dvc(text: str) -> Dict[str, list]:
    """Parse a DVC prediction into the {"timestamps", "captions"} record
    the scorers consume (reference evaluate.py:290-297)."""
    timestamps, captions = parse_dvc_prediction(text)
    return {"timestamps": timestamps, "captions": captions}


def extract_answer(output_string: str, datatype: str):
    if datatype == "tg":
        return extract_tg(output_string)
    if datatype == "mcq":
        return extract_mcq(output_string)
    if datatype == "caption":
        return extract_dvc(output_string)
    raise ValueError(f"Unsupported datatype: {datatype}")
