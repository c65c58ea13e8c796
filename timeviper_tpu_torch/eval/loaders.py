"""Benchmark annotation loaders — 14 video benchmarks normalized to one
record schema.

Re-implementation of the reference's per-benchmark normalizers
(eval/vllm_inference/data/data_loader.py:22-589). Every loader yields dicts:

  {"video": path, "question": str?, "options": ["A. ...", ...]?,
   "answer": int|str|list?, "sentence": str? (TVG), "timestamp": [s, e]?,
   "duration": float|str|None, "task_type": str?, "qid": str,
   "video_start": float?, "video_end": float?}

`data_root` defaults to ./dataset/<name> like the reference; pass your own.
Heavy deps (pandas, datasets/parquet) import lazily per loader so the rest
of the framework never needs them.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional


def _find_video(base: str, stem: str, exts=("mp4", "mkv", "webm")) -> str:
    for ext in exts:
        p = os.path.join(base, f"{stem}.{ext}")
        if os.path.exists(p):
            return p
    return os.path.join(base, f"{stem}.{exts[0]}")


def _lettered(options: List[str]) -> List[str]:
    return [f"{chr(65 + i)}. {o}" for i, o in enumerate(options)]


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def _read_jsonl(path: str):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------------------
# Temporal video grounding (tg)
# ---------------------------------------------------------------------------


def load_activitynet(root="./dataset/activitynet", split="val") -> List[dict]:
    """val/test split of ActivityNet Captions STG (data_loader.py:22-52)."""
    data = _read_json(
        f"{root}/annotations/sentence_temporal_grounding/{split}.json"
    )
    out, qid = [], 0
    for vid, meta in data.items():
        vpath = _find_video(f"{root}/videos", vid)
        for ts, sent in zip(meta["timestamps"], meta["sentences"]):
            out.append({
                "video": vpath, "duration": meta["duration"],
                "timestamp": ts, "sentence": sent.strip(),
                "qid": f"activitynet_{qid}",
            })
            qid += 1
    return out


def load_charades(root="./dataset/charades", split="test") -> List[dict]:
    """Charades-STA; builds the json cache from the txt+csv annotations on
    first run (data_loader.py:55-102)."""
    jpath = f"{root}/Charades_anno/Charades_sta_{split}.json"
    if not os.path.exists(jpath):
        import pandas as pd

        df = pd.read_csv(f"{root}/Charades_anno/Charades_v1_{split}.csv")
        durations = dict(zip(df["id"], df["length"]))
        data: Dict[str, dict] = {}
        with open(f"{root}/Charades_anno/Charades_sta_{split}.txt") as f:
            for line in f:
                if not line.strip():
                    continue
                meta, sent = line.split("##")
                vid, s, e = meta.split(" ")
                entry = data.setdefault(
                    vid, {"duration": durations[vid], "timestamps": [],
                          "sentences": []}
                )
                entry["timestamps"].append([float(s), float(e)])
                entry["sentences"].append(sent)
        with open(jpath, "w") as f:
            json.dump(data, f)
    else:
        data = _read_json(jpath)
    out, qid = [], 0
    for vid, meta in data.items():
        vpath = os.path.join(f"{root}/Charades_v1", f"{vid}.mp4")
        for ts, sent in zip(meta["timestamps"], meta["sentences"]):
            out.append({
                "video": vpath, "duration": meta["duration"],
                "timestamp": ts, "sentence": sent.strip(),
                "qid": f"charades_{qid}",
            })
            qid += 1
    return out


def load_tvgbench(root="./dataset/trainval", split="default") -> List[dict]:
    """TVGBench json with 'start-end' answers (data_loader.py:241-304)."""
    out = []
    # qid counts EMITTED records only — items skipped for a missing video
    # do not advance it (data_loader.py:263-301 increments after the skip)
    for itm in _read_json(f"{root}/tvgbench.json"):
        if not os.path.exists(itm["path"]):
            continue
        s, e = itm["answer"].split("-")
        src = os.path.splitext(os.path.basename(itm.get("source", "tvg")))[0]
        src = src.replace(".", "_").replace("-", "_")
        out.append({
            "video": itm["path"], "duration": itm["duration"],
            "timestamp": [float(s), float(e)], "sentence": itm["question"],
            "qid": f"{src}_{len(out)}",
            "video_start": itm["start"], "video_end": itm["end"],
        })
    return out


def load_tvgbench_filter(root="", split="") -> List[dict]:
    """Pre-filtered TVGBench records; `split` is the json path
    (data_loader.py:105-133)."""
    return [
        {
            "video": m["video"], "duration": m["duration"],
            "timestamp": m["timestamp"], "sentence": m["sentence"],
            "pred": m.get("pred"), "qid": m["qid"],
            "video_start": m.get("video_start"),
            "video_end": m.get("video_end"),
        }
        for m in _read_json(split)
    ]


# ---------------------------------------------------------------------------
# Multiple-choice QA (mcq)
# ---------------------------------------------------------------------------


def load_mlvu(root="dataset/mlvu/MLVU", split="default") -> List[dict]:
    """MLVU task-dir layout; MCQ tasks only (data_loader.py:136-176)."""
    taskdirs = {
        "plotQA": "1_plotQA", "findNeedle": "2_needle", "ego": "3_ego",
        "count": "4_count", "order": "5_order",
        "anomaly_reco": "6_anomaly_reco",
        "topic_reasoning": "7_topic_reasoning", "subPlot": "8_sub_scene",
        "summary": "9_summary",
    }
    out = []
    jdir = f"{root}/json"
    for fname in sorted(os.listdir(jdir)):
        for qid, itm in enumerate(_read_json(os.path.join(jdir, fname))):
            if "candidates" not in itm:
                continue
            tt = itm["question_type"]
            out.append({
                "video": os.path.join(root, "video", taskdirs[tt], itm["video"]),
                "question": itm["question"],
                "options": _lettered(itm["candidates"]),
                "answer": itm["candidates"].index(itm["answer"]),
                "duration": itm["duration"], "task_type": tt,
                "qid": f"mlvu|{tt}|{qid}",
            })
    return out


def load_longvideobench(root="dataset/longvideobench", split="test") -> List[dict]:
    """LVB val/test (test ships no answers) (data_loader.py:179-212)."""
    fname = "lvb_val.json" if split == "val" else "lvb_test_wo_gt.json"
    buckets = {"15": "very short", "60": "short", "600": "medium",
               "3600": "long"}
    return [
        {
            "video": os.path.join(f"{root}/videos", itm["video_path"]),
            "question": itm["question"],
            "options": _lettered(itm["candidates"]),
            "answer": itm.get("correct_choice"),
            "duration": buckets[str(itm["duration_group"])],
            "task_type": itm["question_category"],
            "qid": f"longvideobench_{itm['id']}",
        }
        for itm in _read_json(f"{root}/{fname}")
    ]


def load_lvbench(root="./dataset/lvbench", split="default") -> List[dict]:
    """LVBench jsonl; options embedded in the question text
    (data_loader.py:215-238)."""
    out = []
    for itm in _read_jsonl(f"{root}/data/video_info.meta.jsonl"):
        vpath = os.path.join(f"{root}/all_videos", itm["key"] + ".mp4")
        for qa in itm["qa"]:
            question, *options = qa["question"].split("\n")
            out.append({
                "video": vpath, "question": question, "options": options,
                "answer": ord(qa["answer"]) - ord("A"), "duration": None,
                "task_type": qa["question_type"],
                "qid": f"lvbench_{qa['uid']}",
            })
    return out


def load_videomme(root="./dataset/videomme", split="default") -> List[dict]:
    """Video-MME parquet; optional duration filter (data_loader.py:307-335)."""
    import datasets as hfd

    data = hfd.load_dataset(
        "parquet", split="test", data_dir=f"{root}/videomme", streaming=True
    )
    out = []
    for itm in data:
        if split not in ("default", "test") and itm["duration"] != split:
            continue
        out.append({
            "video": os.path.join(f"{root}/data", itm["videoID"] + ".mp4"),
            "question": itm["question"],
            "options": [op.strip() for op in itm["options"]],
            "answer": ord(itm["answer"]) - ord("A"),
            "duration": itm["duration"], "task_type": itm["task_type"],
            "qid": f"videomme_{itm['question_id']}",
        })
    return out


def load_egoschema(root="./dataset/egoschema", split="default") -> List[dict]:
    """EgoSchema parquet (MC or Subset) (data_loader.py:338-363)."""
    import datasets as hfd

    subdir = "Subset" if split == "subset" else "MC"
    data = hfd.load_dataset(
        "parquet", split="test", data_dir=f"{root}/{subdir}", streaming=True
    )
    return [
        {
            "video": os.path.join(f"{root}/videos", itm["video_idx"] + ".mp4"),
            "question": itm["question"],
            "options": [op[2:].strip() for op in itm["option"]],
            "answer": itm["answer"], "duration": None,
            "qid": f"egoschema_{itm['question_idx']}",
        }
        for itm in data
    ]


def load_tempcompass(root="./dataset/tempcompass", split="multi-choice") -> List[dict]:
    """TempCompass; 4 sub-splits with different option encodings
    (data_loader.py:366-410)."""
    if split == "default":
        split = "multi-choice"
    out = []
    for key, dims in _read_json(f"{root}/questions/{split}.json").items():
        vpath = os.path.join(f"{root}/videos", key + ".mp4")
        for dim, items in dims.items():
            for idx, itm in enumerate(items):
                q, options, answer = itm["question"], [], itm["answer"]
                if split == "yes_no":
                    options = ["yes", "no"]
                    answer = options.index(answer)
                elif split == "caption_matching":
                    lines = q.split("\n")
                    q = lines[0]
                    options = [":".join(l.split(":")[1:]).strip()
                               for l in lines[1:]]
                    answer = options.index(
                        ":".join(answer.split(":")[1:]).strip())
                elif split == "multi-choice":
                    lines = q.split("\n")
                    q = lines[0]
                    options = [l[2:].strip() for l in lines[1:]]
                    answer = ord(answer[0]) - ord("A")
                out.append({
                    "video": vpath, "question": q, "options": options,
                    "answer": answer, "duration": None,
                    "qid": f"tempcompass|{split}|{key}|{dim}|{idx}",
                })
    return out


def load_mvbench(root="./dataset/mvbench", split="default") -> List[dict]:
    """MVBench 20 tasks, per-task video roots; pre-split clips when
    start/end given (data_loader.py:413-479)."""
    videodirs = {
        "action_sequence": "video/star/Charades_v1_480/",
        "action_prediction": "video/star/Charades_v1_480/",
        "action_antonym": "video/ssv2_video/",
        "fine_grained_action": "video/Moments_in_Time_Raw/videos/",
        "unexpected_action": "video/FunQA_test/test/",
        "object_existence": "video/clevrer/video_validation/",
        "object_interaction": "video/star/Charades_v1_480/",
        "object_shuffle": "video/perception/videos/",
        "moving_direction": "video/clevrer/video_validation/",
        "action_localization": "video/sta/sta_video/",
        "scene_transition": "video/scene_qa/video/",
        "action_count": "video/perception/videos/",
        "moving_count": "video/clevrer/video_validation/",
        "moving_attribute": "video/clevrer/video_validation/",
        "state_change": "video/perception/videos/",
        "fine_grained_pose": "video/nturgbd/",
        "character_order": "video/perception/videos/",
        "egocentric_navigation": "video/vlnqa/",
        "episodic_reasoning": "video/tvqa/output_videos/",
        "counterfactual_inference": "video/clevrer/video_validation/",
    }
    out = []
    jdir = f"{root}/json"
    for fname in sorted(os.listdir(jdir)):
        task = fname.split(".")[0]
        vdir = os.path.join(root, videodirs[task])
        for qid, itm in enumerate(_read_json(os.path.join(jdir, fname))):
            rec = {
                "video": os.path.join(vdir, itm["video"]),
                "question": itm["question"],
                "options": _lettered(itm["candidates"]),
                "answer": itm["candidates"].index(itm["answer"]),
                "duration": None, "qid": f"mvbench|{task}|{qid}",
            }
            if "start" in itm and "end" in itm:
                stem = itm["video"].split(".mp4")[0]
                clip = (f"{stem}_{str(itm['start']).replace('.', '-')}"
                        f"_{str(itm['end']).replace('.', '-')}.mp4")
                rec["video"] = os.path.join(vdir, "split", clip)
            else:
                if "start" in itm:
                    rec["video_start"] = itm["start"]
                if "end" in itm:
                    rec["video_end"] = itm["end"]
            out.append(rec)
    return out


def load_cgbench(root="./dataset/cgbench", split="default") -> List[dict]:
    """CG-Bench full/mini (data_loader.py:483-514)."""
    fname = "cgbench_mini.json" if split == "subset" else "cgbench.json"
    return [
        {
            "video": os.path.join(f"{root}/cg_videos_720p",
                                  itm["video_uid"] + ".mp4"),
            "question": itm["question"],
            "options": _lettered(itm["choices"]),
            "answer": ord(itm["right_answer"]) - ord("A"),
            "duration": itm["duration"], "task_type": itm["sub_category"],
            "qid": f"cgbench|{itm['qid']}",
        }
        for itm in _read_json(f"{root}/{fname}")
    ]


# ---------------------------------------------------------------------------
# Captioning (caption)
# ---------------------------------------------------------------------------


def load_auroracap(root="./dataset/auroracap", split="default") -> List[dict]:
    """VDC-1k; 5 caption styles per video (data_loader.py:517-549)."""
    tasks = (
        ["background", "camera", "detailed", "main_object", "short"]
        if split == "default" else [split]
    )
    out = []
    for itm in _read_jsonl(f"{root}/VDC_1k.jsonl"):
        vpath = os.path.join(f"{root}/videos/videos", itm["video_name"])
        for task in tasks:
            out.append({
                "video": vpath, "answer": itm[f"{task}_caption"],
                "qid": f"auroracap|{task}|{itm['video_id']}",
                "task_type": task,
            })
    return out


def load_youcook2(root="./dataset/youcook2", split="val") -> List[dict]:
    """YouCook2 DVC segments (data_loader.py:552-589)."""
    fname = (
        "youcookii_annotations_test_segments_only.json" if split == "test"
        else "youcookii_annotations_trainval.json"
    )
    db = _read_json(f"{root}/annotations/{fname}")["database"]
    split_map = {"train": "training", "val": "validation", "test": "testing"}
    if split in ("train", "val"):
        db = {k: v for k, v in db.items() if v["subset"] == split_map[split]}
    out = []
    for vid, itm in db.items():
        base = f"{root}/raw_videos/{itm['subset']}/{itm['recipe_type']}"
        out.append({
            "video": _find_video(base, vid),
            "duration": itm["duration"],
            "answer": itm["annotations"],
            "qid": f"youcook2|{vid}",
        })
    return out


BENCHMARKS: Dict[str, Callable[..., List[dict]]] = {
    "activitynet": load_activitynet,
    "charades": load_charades,
    "tvgbench": load_tvgbench,
    "tvgbench_filter": load_tvgbench_filter,
    "mlvu": load_mlvu,
    "longvideobench": load_longvideobench,
    "lvbench": load_lvbench,
    "videomme": load_videomme,
    "egoschema": load_egoschema,
    "tempcompass": load_tempcompass,
    "mvbench": load_mvbench,
    "cgbench": load_cgbench,
    "auroracap": load_auroracap,
    "youcook2": load_youcook2,
}


def load_benchmark(
    name: str, data_root: Optional[str] = None, split: str = "default"
) -> List[dict]:
    loader = BENCHMARKS[name]
    # loaders carry their own per-benchmark default splits
    kwargs = {} if split == "default" else {"split": split}
    if data_root is not None:
        kwargs["root"] = data_root
    return loader(**kwargs)
