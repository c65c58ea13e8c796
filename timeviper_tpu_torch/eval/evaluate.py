"""Evaluation CLI: per-benchmark generate loop with resumable jsonl shards
(counterpart of timeviper_tpu/eval/evaluate.py, the same flags).

The reference evaluate.py:43-703's flags (--dataset_name, --curr_idx /
--total_idx sharding, fps / frame clamps, resume by scanning output jsonls);
generation runs on the card (or `--device`) through the port's
bucketed-prefill Generator (models/generate.py), questions on a cached
video prefix (`--prefix_cache`) or the slot-batched ServingEngine
(`--use_serving_engine`). `--mesh_seq N` shards each prefill's sequence
(and the encode's frames) over N ranks, launched by torchrun, each on its
own card, NCCL between them (gloo for `--device cpu`);
every rank runs the loop and rank 0 alone writes the answers.
`--mesh_model N` shards the weights over N ranks instead (tensor
parallelism, parallel/tensor_parallel.py); the two together raise.

Usage:
  python -m timeviper_tpu_torch.eval.evaluate --checkpoint CKPT --dataset_name \
      videomme --output_dir results/videomme [--curr_idx 0 --total_idx 1]
  torchrun --nproc_per_node N -m timeviper_tpu_torch.eval.evaluate ... --mesh_seq N
  torchrun --nproc_per_node N -m timeviper_tpu_torch.eval.evaluate ... --mesh_model N

Then score:
  python -m timeviper_tpu_torch.eval.evaluate --score_only --dataset_name \
      videomme --output_dir results/videomme
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

from timeviper_tpu_torch.eval.answers import extract_answer, get_dataset_type
from timeviper_tpu_torch.eval.datasets import (
    EvalDataset,
    EvalSampleConfig,
    MCQ_ANSWER_PROMPT,
)
from timeviper_tpu_torch.eval.loaders import load_benchmark
from timeviper_tpu_torch.eval.scoring import calc_score, load_scored_data


def get_args(argv=None):
    p = argparse.ArgumentParser(description="TimeViper evaluation (PyTorch + CUDA)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="VLM checkpoint dir (the reference's torch .bin/.pt/.safetensors)")
    p.add_argument("--dataset_name", type=str, required=True)
    p.add_argument("--split", type=str, default="default")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--curr_idx", type=int, default=0)
    p.add_argument("--total_idx", type=int, default=1)
    p.add_argument("--fps", type=float, default=1.0)
    p.add_argument("--min_frames", type=int, default=32)
    p.add_argument("--max_frames", type=int, default=256)
    p.add_argument("--max_new_tokens", type=int, default=128)
    p.add_argument("--conv_template", type=str, default="nano_base")
    p.add_argument("--use_pdrop", action="store_true")
    p.add_argument("--mesh_seq", type=int, default=1,
                   help="sequence-shard prefill over this many ranks "
                        "(torchrun --nproc_per_node N)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="tensor-parallel shards of the weights over this many "
                        "ranks (torchrun --nproc_per_node N)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of the model (default: the CUDA card)")
    p.add_argument("--use_serving_engine", "--use_vllm_inference",
                   action="store_true", dest="use_serving_engine",
                   help="batch generation through the continuous-batching "
                        "engine (the reference's --use_vllm_inference analog; "
                        "both spellings accepted)")
    p.add_argument("--serving_slots", type=int, default=4)
    p.add_argument("--prefix_cache", action="store_true",
                   help="reuse the video prefill across questions on the "
                        "same video (models/prefix_cache.py) — multi-"
                        "question benchmarks (VideoMME: 3 q/video) skip "
                        "the repeated vision encode + 80k-token prefill")
    p.add_argument("--speculative", type=str, default=None,
                   choices=["ngram"],
                   help="prompt-lookup speculative decoding for the "
                        "greedy batch-1 decode loop (models/speculative"
                        ".py): drafts from the prompt's own n-grams, "
                        "token-identical output. Ignored by "
                        "--use_serving_engine (its lockstep multi-slot "
                        "decode is documented batch-1-out-of-scope, "
                        "docs/SERVING.md)")
    p.add_argument("--n_draft", type=int, default=7,
                   help="drafted tokens per speculative verify pass")
    p.add_argument("--suffix_budget", type=int, default=1024,
                   help="max question-suffix tokens a cached prefix absorbs")
    p.add_argument("--score_only", action="store_true")
    p.add_argument("--limit", type=int, default=0,
                   help="debug: cap the number of items")
    return p.parse_args(argv)


def scan_finished(output_dir: str) -> set:
    """Resume: qids already present in any shard (evaluate.py:320-332)."""
    done = set()
    if not os.path.isdir(output_dir):
        return done
    for fname in os.listdir(output_dir):
        if "jsonl" not in fname or "score" in fname:
            continue
        with open(os.path.join(output_dir, fname)) as f:
            for line in f:
                try:
                    done.add(json.loads(line)["qid"])
                except Exception:
                    continue
    return done


def score(args) -> dict:
    scored = load_scored_data(args.output_dir, args.dataset_name)
    result = calc_score(scored, args.dataset_name)
    out_path = os.path.join(args.output_dir, "scores.json")
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))
    return result


def main(argv=None):
    args = get_args(argv)
    if args.score_only:
        return score(args)

    from timeviper_tpu_torch.models.api import load_pretrained_vlm  # heavy imports lazy

    mesh, writer = None, True
    if args.mesh_seq > 1 or args.mesh_model > 1:
        import torch.distributed as dist

        from timeviper_tpu_torch.parallel.sharding import make_mesh
        from timeviper_tpu_torch.utils.dist import initialize_distributed

        initialize_distributed("gloo" if args.device == "cpu" else "nccl")
        mesh = make_mesh(data=1, seq=args.mesh_seq, model=args.mesh_model)
        writer = dist.get_rank() == 0  # rank 0 alone writes the answers

    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(
        args.output_dir, f"{args.curr_idx}_of_{args.total_idx}.jsonl"
    )
    finished = scan_finished(args.output_dir)
    if mesh is not None:  # every rank resumes from the same answers
        dist.barrier()

    model = load_pretrained_vlm(
        args.checkpoint,
        conv_template=args.conv_template,
        max_new_tokens=args.max_new_tokens,
        use_pdrop=args.use_pdrop,
        mesh=mesh,
        speculative=args.speculative,
        n_draft=args.n_draft,
        device=args.device,
    )
    datatype = get_dataset_type(args.dataset_name)
    records = load_benchmark(args.dataset_name, args.data_root, args.split)
    if args.limit:
        records = records[: args.limit]
    ds = EvalDataset(
        records, datatype, model.processor, model.template,
        EvalSampleConfig(fps=args.fps, min_frames=args.min_frames,
                         max_frames=args.max_frames),
        curr_idx=args.curr_idx, total_idx=args.total_idx,
        finished_qids=finished,
    )

    answer_prompt = MCQ_ANSWER_PROMPT if datatype == "mcq" else None

    def record(f, item, text):
        if datatype == "mcq" and answer_prompt:
            text = "(" + text
        rec = {
            "qid": item["qid"],
            "pred": extract_answer(text, datatype),
            "target": item["target"],
            "output_text": text,
            "duration": item.get("duration"),
            "task_type": item.get("task_type"),
        }
        f.write(json.dumps(rec) + "\n")
        f.flush()

    t_start = time.perf_counter()
    with open(out_path if writer else os.devnull, "a") as f:
        if args.use_serving_engine:
            from timeviper_tpu_torch.serving import Request, ServingEngine

            ans_ids = (model.processor.tokenize(answer_prompt)
                       if answer_prompt else [])
            # the cache in the weights' type: an f32 model's engine decodes
            # as its Generator does
            eng = ServingEngine(
                model.model, model.arch,
                terminator_ids=model.processor.terminator_ids,
                num_slots=args.serving_slots,
                max_len=32768, max_new_tokens=args.max_new_tokens,
                cache_dtype=model.model.llm_backbone.embeddings.weight.dtype,
                mesh=mesh,
            )
            # batch in slot-count waves; vision encode happens in prefill
            wave = args.serving_slots * 2
            for s in range(0, len(ds), wave):
                items = [ds[i] for i in range(s, min(s + wave, len(ds)))]
                reqs = [
                    Request(
                        request_id=s + j,
                        input_ids=list(it["input_ids"]) + list(ans_ids),
                        pixels=it["pixels"],
                        image_token_id=model.processor.image_token_id,
                        max_new_tokens=args.max_new_tokens,
                    )
                    for j, it in enumerate(items)
                ]
                for it, req in zip(items, eng.run(reqs)):
                    toks = [t for t in req.output_ids
                            if t not in model.processor.terminator_ids]
                    record(f, it, model.processor.decode(toks).strip())
        elif args.prefix_cache:
            from timeviper_tpu_torch.models.generate import (
                split_prompt_at_last_image,
            )

            img_id = model.processor.image_token_id
            pkey, pstate = None, None
            hits = 0
            # group questions by video so every repeat is a cache hit even
            # when the benchmark interleaves videos (records carry qids —
            # output order never matters for scoring or resume)
            order = sorted(range(len(ds)),
                           key=lambda i: (ds.video_key(i), i))
            for i in order:
                item = ds[i]
                ids = list(item["input_ids"])
                if img_id not in ids:
                    record(f, item, model.generate(
                        ids, answer_prompt=answer_prompt))
                    continue
                pre_ids, suf_ids = split_prompt_at_last_image(ids, img_id)
                key = (ds.video_key(i), len(pre_ids))
                if key != pkey:
                    pstate = model.prefill_video_prefix(
                        pre_ids, item["pixels"],
                        suffix_budget=args.suffix_budget)
                    pkey = key
                else:
                    hits += 1
                try:
                    text = model.generate(
                        suf_ids, answer_prompt=answer_prompt, prefix=pstate)
                except ValueError:
                    # e.g. a question longer than suffix_budget: pay one
                    # full prefill for this item instead of aborting a
                    # multi-hour eval run
                    text = model.generate(
                        ids, pixels=item["pixels"],
                        answer_prompt=answer_prompt)
                record(f, item, text)
            print(f"prefix-cache hits: {hits}/{len(ds)}")
        else:
            for i in range(len(ds)):
                item = ds[i]
                text = model.generate(
                    item["input_ids"], pixels=item["pixels"],
                    answer_prompt=answer_prompt,
                )
                record(f, item, text)
    elapsed = time.perf_counter() - t_start
    if not writer:
        return
    with open(os.path.join(args.output_dir, "timing_summary.txt"), "a") as f:
        f.write(
            f"shard {args.curr_idx}/{args.total_idx}: {len(ds)} items in "
            f"{elapsed:.1f}s ({elapsed / max(len(ds), 1):.2f} s/item)\n"
        )


if __name__ == "__main__":
    main()
