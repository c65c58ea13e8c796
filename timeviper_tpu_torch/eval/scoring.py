"""Benchmark scoring: IoU/R1 for TVG, accuracy splits for MCQ.

Matches the reference aggregation semantics (eval/vllm_inference/
eval_all.py:62-236): mIoU + R1@{0.3,0.5,0.7} for grounding; accuracy with
per-duration and per-task-type splits for MCQ benchmarks; prediction records
are resumable jsonl shards.
"""

from __future__ import annotations

import json
import os
import re
from collections import defaultdict
from typing import Any, Dict, List

import numpy as np

from timeviper_tpu_torch.eval.answers import get_dataset_type

TVG_DATASETS = ("activitynet", "charades", "tvgbench", "tvgbench_filter")
DURATION_SPLIT_DATASETS = ("videomme", "longvideobench")
TASKTYPE_SPLIT_DATASETS = ("lvbench", "mlvu", "cgbench")


def compute_IoU(pred: List[float], gt: List[float]) -> float:
    """Temporal IoU of [start, end] windows (eval_all.py:62-83)."""
    p0, p1 = float(pred[0]), float(pred[1])
    g0, g1 = float(gt[0]), float(gt[1])
    inter = max(0.0, min(p1, g1) - max(p0, g0))
    union = max(0.0, max(p1, g1) - min(p0, g0))
    return inter / union if union > 0 else 0.0


def mcq_is_correct(pred_text: str, gt: int) -> int:
    """Fallback text-level MCQ match (eval_all.py:86-92)."""
    letter = chr(gt + ord("A"))
    matches = re.findall(r"([A-Z]\.)", pred_text)
    if matches:
        return int(matches[0][0] == letter)
    return int(bool(pred_text) and pred_text[0] == letter)


def read_prediction_shards(data_dir: str) -> List[dict]:
    preds = []
    for fname in sorted(os.listdir(data_dir)):
        if "jsonl" not in fname or "score" in fname:
            continue
        with open(os.path.join(data_dir, fname)) as f:
            preds += [json.loads(line) for line in f if line.strip()]
    return preds


def load_scored_data(data_dir: str, dataset_name: str) -> Dict[str, Any]:
    """Score every prediction record (eval_all.py:95-149)."""
    if dataset_name == "auroracap":
        from timeviper_tpu_torch.eval.judges import score_auroracap

        return score_auroracap(data_dir)
    if dataset_name == "youcook2":
        from timeviper_tpu_torch.eval.dvc import evaluate_youcook2_dvc

        return {"__aggregate__": evaluate_youcook2_dvc(
            read_prediction_shards(data_dir))}
    preds = read_prediction_shards(data_dir)
    datatype = get_dataset_type(dataset_name)
    out: Dict[str, Any] = {}
    for rec in preds:
        if datatype == "tg":
            score = (
                compute_IoU(rec["pred"], rec["target"])
                if rec.get("pred") and None not in rec["pred"]
                else 0.0
            )
        elif datatype == "mcq":
            if rec.get("pred") is not None:
                score = int(rec["pred"] == rec["target"])
            else:
                score = mcq_is_correct(rec.get("output_text", ""), rec["target"])
        else:
            raise NotImplementedError(dataset_name)
        if dataset_name in DURATION_SPLIT_DATASETS:
            out[rec["qid"]] = {
                "score": score,
                "duration": rec.get("duration"),
                "task_type": rec.get("task_type"),
            }
        elif dataset_name in TASKTYPE_SPLIT_DATASETS:
            out[rec["qid"]] = {"score": score, "task_type": rec.get("task_type")}
        else:
            out[rec["qid"]] = score
    return out


def calc_score(scored: Dict[str, Any], dataset_name: str) -> Dict[str, Any]:
    """Aggregate per-qid scores to the benchmark metric (eval_all.py:152-236)."""
    data = list(scored.values())
    if not data:
        return {}
    if "__aggregate__" in scored:  # youcook2: already corpus-level
        return scored["__aggregate__"]
    if dataset_name == "auroracap":
        scores = defaultdict(lambda: {"total": 0, "score": 0.0, "acc": 0.0})
        for itm in data:
            for key in ("total", itm.get("task_type")):
                scores[key]["score"] += itm["score"]
                scores[key]["acc"] += itm["acc"]
                scores[key]["total"] += 1
        return {
            k: {"score": round(v["score"] / v["total"], 2),
                "acc": round(v["acc"] / v["total"] * 100, 2),
                "total": v["total"]}
            for k, v in scores.items()
        }
    if dataset_name in TVG_DATASETS:
        vals = [float(v) for v in data]
        scores: Dict[str, Any] = {"mIoU": float(np.mean(vals)) * 100}
        for th in (0.3, 0.5, 0.7):
            scores[f"IoU R1@{th}"] = (
                sum(1 for v in vals if v > th) / len(vals) * 100.0
            )
        scores["avg"] = sum(scores.values()) / len(scores)
        return scores
    if dataset_name in DURATION_SPLIT_DATASETS:
        scores = {"total": {"correct": 0, "total": 0}}
        for itm in data:
            for key in ("total", itm.get("duration"), itm.get("task_type")):
                if key is None:
                    continue
                scores.setdefault(key, {"correct": 0, "total": 0})
                scores[key]["correct"] += itm["score"]
                scores[key]["total"] += 1
        for key in scores:
            t = scores[key]["total"]
            scores[key]["avg"] = round(scores[key]["correct"] / t * 100, 2) if t else 0.0
        return scores
    if dataset_name in TASKTYPE_SPLIT_DATASETS:
        scores = defaultdict(lambda: {"correct": 0, "total": 0})
        for itm in data:
            tts = itm.get("task_type")
            tts = tts if isinstance(tts, list) else [tts]
            for tt in tts:
                scores["total"]["correct"] += itm["score"]
                scores["total"]["total"] += 1
                scores[tt]["correct"] += itm["score"]
                scores[tt]["total"] += 1
        return {
            k: dict(v, avg=round(v["correct"] / v["total"] * 100, 2))
            for k, v in scores.items()
        }
    correct = sum(float(v) for v in data)
    return {
        "correct": correct,
        "total": len(data),
        "avg": round(correct / len(data) * 100, 2),
    }


def zigzag_split(data: list, curr_idx: int, total_idx: int) -> list:
    """Balanced job sharding: split into 2*total chunks, take chunk curr and
    its mirror (2*total-1-curr) so early/late-video cost differences average
    out (reference data/__init__.py:342-371)."""
    n = len(data)
    parts = 2 * total_idx
    if parts <= 0 or n == 0:
        return []
    chunk = -(-n // parts)
    out = []
    for idx in (curr_idx, parts - 1 - curr_idx):
        st, ed = idx * chunk, min(n, (idx + 1) * chunk)
        if st < ed:
            out.extend(data[st:ed])
    return out
