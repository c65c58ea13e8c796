"""External-judge scoring paths: EgoSchema submission + AuroraCap LLM judge.

Reference equivalents: EgoSchema's online submission upload
(eval_all.py:239-279) and AuroraCap's sglang LLM-judge scoring
(eval_auroracap.py:29-100). Both depend on external services; here the
submission file is produced locally (upload happens wherever there is
network) and the VDC judge is a pluggable callable with an OpenAI-style
HTTP default.
"""

from __future__ import annotations

import json
import os
import re
from typing import Callable, Dict, List, Optional


def egoschema_submission(
    prediction_dir: str, out_path: Optional[str] = None
) -> Dict[str, int]:
    """Collect EgoSchema predictions into the {qid: answer_idx} payload the
    validation server expects (eval_all.py:259-279). Returns the payload and
    writes it next to the shards."""
    from timeviper_tpu_torch.eval.scoring import read_prediction_shards

    payload: Dict[str, int] = {}
    for rec in read_prediction_shards(prediction_dir):
        qid = str(rec["qid"]).replace("egoschema_", "")
        pred = rec.get("pred")
        if pred is None:
            continue
        payload[qid] = int(pred)
    out_path = out_path or os.path.join(prediction_dir, "egoschema_submission.json")
    with open(out_path, "w") as f:
        json.dump(payload, f)
    return payload


EGOSCHEMA_API_URL = "https://validation-server.onrender.com/api/upload/"


def egoschema_upload(payload: Dict[str, int],
                     api_url: str = EGOSCHEMA_API_URL) -> dict:
    """POST the {video_id: answer_idx} payload to the EgoSchema validation
    server (reference eval_all.py:239-256). Run this wherever network
    egress exists: `python -c "from timeviper_tpu_torch.eval.judges import *;
    egoschema_upload(json.load(open('egoschema_submission.json')))"`.
    Returns the server's JSON (or an {"status": "error", ...} record)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        api_url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            text = resp.read().decode()
        try:
            return json.loads(text)
        except ValueError:
            return {"status": "success", "response_text": text}
    except (urllib.error.URLError, OSError) as e:
        return {"status": "error", "message": str(e),
                "details": f"Failed to upload data to {api_url}"}


VDC_JUDGE_PROMPT = (
    "You are an intelligent chatbot designed for evaluating the quality of "
    "generative outputs for video-based detailed captions. Your task is to "
    "compare the predicted caption with the correct caption and determine "
    "if they match meaningfully. Consider synonyms and paraphrases as "
    "valid. Provide your evaluation as a matched score where the score is "
    "an integer value between 0 and 5, with 5 indicating the highest "
    "meaningful match. Respond with a JSON object: "
    '{{"score": <int>, "pred": "yes" or "no"}}.\n'
    "Correct caption: {gt}\nPredicted caption: {pred}"
)


def openai_style_judge(endpoint: str, model: str = "default",
                       api_key: str = "") -> Callable[[str, str], dict]:
    """Judge callable hitting an OpenAI-compatible /chat/completions server
    (the reference boots an sglang server for this role)."""
    import urllib.request

    def judge(pred: str, gt: str) -> dict:
        body = json.dumps({
            "model": model,
            "messages": [{
                "role": "user",
                "content": VDC_JUDGE_PROMPT.format(gt=gt, pred=pred),
            }],
            "temperature": 0.0,
        }).encode()
        req = urllib.request.Request(
            endpoint.rstrip("/") + "/chat/completions", data=body,
            headers={"Content-Type": "application/json",
                     **({"Authorization": f"Bearer {api_key}"} if api_key
                        else {})},
        )
        with urllib.request.urlopen(req, timeout=120) as resp:
            text = json.load(resp)["choices"][0]["message"]["content"]
        m = re.search(r"\{.*\}", text, re.DOTALL)
        out = json.loads(m.group(0)) if m else {}
        return {"score": float(out.get("score", 0)),
                "acc": 1.0 if str(out.get("pred", "no")).lower() == "yes"
                else 0.0}

    return judge


def score_auroracap(
    prediction_dir: str,
    judge: Optional[Callable[[str, str], dict]] = None,
) -> Dict[str, dict]:
    """Per-qid {score, acc, task_type} via the judge (eval_auroracap.py
    semantics). With no judge configured (`VDC_JUDGE_ENDPOINT` unset), falls
    back to the token-F1 similarity as a proxy so offline runs still rank."""
    from timeviper_tpu_torch.eval.dvc import TokenF1Scorer
    from timeviper_tpu_torch.eval.scoring import read_prediction_shards

    if judge is None:
        endpoint = os.environ.get("VDC_JUDGE_ENDPOINT")
        if endpoint:
            judge = openai_style_judge(
                endpoint, os.environ.get("VDC_JUDGE_MODEL", "default"),
                os.environ.get("VDC_JUDGE_API_KEY", ""))
    scorer = TokenF1Scorer()
    out: Dict[str, dict] = {}
    for rec in read_prediction_shards(prediction_dir):
        pred = rec.get("output_text", "")
        gt = rec.get("target", "")
        if judge is not None:
            r = judge(pred, gt)
        else:
            _, scores = scorer.compute_score({"0": [pred]}, {"0": [gt]})
            r = {"score": float(scores[0]) * 5.0,
                 "acc": 1.0 if scores[0] > 0.3 else 0.0}
        task = str(rec["qid"]).split("|")[1] if "|" in str(rec["qid"]) else "?"
        out[rec["qid"]] = {**r, "task_type": task}
    return out
