"""Dense video captioning metrics: SODA_c + dvc precision/recall.

Re-implementation of the reference DVC scoring (eval/vllm_inference/
eval_dvc.py:27-258, 780-840; itself following github.com/fujiso/SODA):

* temporal IoU matrix between predicted and GT event segments,
* caption similarity matrix via a pluggable scorer — METEOR, like the
  reference (eval/metrics/meteor.py:21-35): the jar when java+METEOR_JAR
  are available, else the pure-Python METEOR (eval/meteor_py.py),
* SODA's monotonic dp assignment over IoU·similarity, F-scored.
"""

from __future__ import annotations

import shutil
from typing import Dict, List, Sequence

import numpy as np

from timeviper_tpu_torch.eval.cider import CiderScorer


def segment_iou_matrix(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(n_gt, n_pred) IoU of [start, end] segments (eval_dvc.py:27-45)."""
    if len(pred) == 0 or len(gt) == 0:
        return np.zeros((len(gt), max(len(pred), 1)))
    inter_l = np.maximum(gt[:, None, 0], pred[None, :, 0])
    inter_r = np.minimum(gt[:, None, 1], pred[None, :, 1])
    inter = np.maximum(0.0, inter_r - inter_l)
    union = (
        (gt[:, 1] - gt[:, 0])[:, None]
        + (pred[:, 1] - pred[:, 0])[None, :]
        - inter
    )
    return np.where(union > 0, inter / union, 0.0)


def dp_assignment(scores: np.ndarray):
    """Monotonic (order-preserving) assignment maximizing the score sum —
    iterative DP, same recurrence as the reference's recursive version
    (eval_dvc.py:188-227) without the recursion-depth limit."""
    m, n = scores.shape
    dp = np.zeros((m, n))
    path = np.zeros((m, n), np.int8)  # 0: up, 1: left, 2: diag-match
    for i in range(m):
        for j in range(n):
            up = dp[i - 1, j] if i > 0 else -1.0
            left = dp[i, j - 1] if j > 0 else -1.0
            diag = (dp[i - 1, j - 1] if i > 0 and j > 0 else 0.0) + scores[i, j]
            if i == 0 and j == 0:
                states = [-1.0, -1.0, scores[i, j]]
            else:
                states = [up, left, diag]
            k = int(np.argmax(states))
            dp[i, j] = states[k]
            path[i, j] = k
    # backtrack matched pairs
    pairs = []
    i, j = m - 1, n - 1
    while i >= 0 and j >= 0:
        if path[i, j] == 2:
            pairs.append((i, j))
            i, j = i - 1, j - 1
        elif path[i, j] == 0:
            i -= 1
        else:
            j -= 1
    return float(dp[m - 1, n - 1]), pairs[::-1]


class TokenF1Scorer:
    """df-free sentence similarity: mean clipped 1/2-gram F1. The METEOR
    stand-in for SODA's similarity matrix — CIDEr's per-call IDF degenerates
    when every ref in the tiny per-video gts dict is identical."""

    def compute_score(self, res, gts):
        import numpy as np

        from timeviper_tpu_torch.eval.cider import _ngrams, tokenize

        ids = list(res.keys())
        scores = np.zeros((len(ids),))
        for k, i in enumerate(ids):
            c = _ngrams(tokenize(res[i][0]), 2)
            sims = []
            for ref in gts[i]:
                r = _ngrams(tokenize(ref), 2)
                per_n = []
                for n in (1, 2):
                    overlap = sum(
                        min(cnt, r[n][g]) for g, cnt in c[n].items()
                    )
                    nc, nr = sum(c[n].values()), sum(r[n].values())
                    p = overlap / nc if nc else 0.0
                    rec = overlap / nr if nr else 0.0
                    per_n.append(2 * p * rec / (p + rec) if p + rec else 0.0)
                sims.append(sum(per_n) / len(per_n))
            scores[k] = max(sims) if sims else 0.0
        return float(scores.mean()) if len(ids) else 0.0, scores


def get_caption_scorer(prefer: str = "auto"):
    """METEOR similarity, like the reference (eval_dvc.py uses the
    meteor-1.5 jar). Order: the jar itself when java + METEOR_JAR exist
    (bit-exact with the reference), else the pure-Python METEOR
    (eval/meteor_py.py — same algorithm, exact+stem stages). Token-F1 only
    on explicit prefer="f1"."""
    if prefer == "f1":
        return TokenF1Scorer()
    if prefer in ("auto", "meteor") and shutil.which("java"):
        try:
            from timeviper_tpu_torch.eval.meteor import MeteorScorer

            return MeteorScorer()
        except Exception:
            pass
    from timeviper_tpu_torch.eval.meteor_py import MeteorPyScorer

    return MeteorPyScorer()


def soda_c(
    pred_segments: Sequence[np.ndarray],
    gt_segments: Sequence[np.ndarray],
    pred_captions: Sequence[Sequence[str]],
    gt_captions: Sequence[Sequence[str]],
    scorer=None,
    iou_threshold: float = 0.0,
) -> float:
    """Corpus SODA_c: per video, dp-match IoU·caption-similarity, F1,
    averaged (eval_dvc.py:230-258 w/ one annotation split)."""
    scorer = scorer or get_caption_scorer()
    fs = []
    for ps, gs, pc, gc in zip(pred_segments, gt_segments, pred_captions,
                              gt_captions):
        ps, gs = np.asarray(ps, float).reshape(-1, 2) if len(ps) else np.zeros((0, 2)), \
            np.asarray(gs, float).reshape(-1, 2)
        if len(ps) == 0 or len(gs) == 0:
            fs.append(0.0)
            continue
        iou = segment_iou_matrix(ps, gs)  # (n_gt, n_pred)
        res = {str(i): [c] for i, c in enumerate(pc)}
        sim = np.zeros((len(gc), len(pc)))
        for gi, g in enumerate(gc):
            gts = {str(i): [g] for i in range(len(pc))}
            _, per = scorer.compute_score(res, gts)
            sim[gi] = np.nan_to_num(np.asarray(per))
        iou = np.where(iou < iou_threshold, 0.0, iou)
        max_score, _ = dp_assignment(iou * sim)
        n_g, n_p = iou.shape
        p = max_score / n_p
        r = max_score / n_g
        fs.append(2 * p * r / (p + r) if (p + r) > 0 else 0.0)
    return float(np.mean(fs)) if fs else 0.0


def evaluate_youcook2_dvc(pred_data: List[dict]) -> Dict[str, float]:
    """Score jsonl prediction records for YouCook2 (eval_dvc.py:780-840).

    Records: {"qid", "pred": {"timestamps", "captions"},
              "target": [{"segment", "sentence", "id"}...]}.
    """
    pred_segments, gt_segments = [], []
    pred_captions, gt_captions = [], []
    paras_pred, paras_gt = [], []
    for item in pred_data:
        gt_segments.append(np.array([x["segment"] for x in item["target"]],
                                    float))
        gt_caps = [x["sentence"] + "." for x in item["target"]]
        gt_captions.append(gt_caps)
        paras_gt.append([" ".join(gt_caps)])
        pred_segments.append(np.array(item["pred"]["timestamps"], float))
        pred_captions.append(list(item["pred"]["captions"]))
        paras_pred.append(". ".join(item["pred"]["captions"]))

    scorer = get_caption_scorer()
    out = {
        "SODA_c": round(
            soda_c(pred_segments, gt_segments, pred_captions, gt_captions,
                   scorer) * 100, 2),
        "n_videos": len(pred_data),
        "n_preds": round(float(np.mean([len(p) for p in pred_captions])), 1)
        if pred_captions else 0.0,
    }
    # paragraph-level CIDEr (evaluate_para analog)
    from timeviper_tpu_torch.eval.cider import cider_score

    out["Para_CIDEr"] = round(cider_score(paras_pred, paras_gt) , 1)
    return out
