#!/usr/bin/env python3
"""Drive the PyTorch port of TimeViper once on one CUDA card: the two
microbenchmarks, serving, a checkpoint written, loaded and chatted with,
the training CLI run on it (heterogeneous rows, then the remat policies,
QLoRA and the layer-streamed offload trainer), long video (a streamed clip-by-clip prefill, the
chunked long-context forward and questions on a cached prefix), the
slot-batched serving engine, pdrop with TransV, speculative decoding, LoRA
training (with the vision tower trained too), int8 serving with the fused
kernels, then serving with the InternVideo2 tower (bf16, then int8) and
with the two-tower DINOv2 + SigLIP encoder, the Qwen2.5-7B backbone
(serving, speculative decoding, LoRA training, W8A8), and last
sequence-parallel serving on one NCCL rank and two gloo ranks, and the
training half of parallelism (tensor, data and FSDP, and the gradient
through the sequence-parallel prefill) on the same.

    python3 chip_smoke.py

Phases, each of which raises on failure (there is no fallback anywhere):

1. device: a CUDA card must be present; print its name and power limit;
   TF32 off for matmuls and convolutions.
2. build: compile csrc/*.cu (one nvcc per source, all started together) into
   one library; print the seconds and each kernel's registers and spills,
   and for the Hopper kernels (K9, K2, K6, K3, K10a on csrc/attn_sm90.cuh,
   K2-bwd, K4 and K1 on its pieces, and K7) their entry names, ptxas's notes
   and K10a's, K2-bwd's, K4's and K1's dynamic shared memory a block.
3. kernels: each hand-written kernel against its plain PyTorch version at the
   main paths' shapes, in bf16, with its max error, its time, the plain
   version's, one PyTorch library call's where one computes the same function
   (a yardstick the port never calls) and its bound on the card; K7 and K8,
   calls of microseconds, are timed by their profiler device time with the
   L2 flushed. The backward kernels (K4, K2-bwd) also give bitwise-equal
   gradients on a repeat, and K1, K5, K7, K9, K2, K2-bwd, K6, K3 and K10a the
   same SHA-256 on a repeat (the attention kernels', K4's, K1's and K7's
   lines also give the launch plan, the achieved TFLOP/s and the share of the
   bound). K1 runs at L 4,096 with segments and at L 8,192 with the 256-frame
   prefill's left pad, its device time split by pass; K7 at batch 1 and 8,
   its plan the blocks, the cluster and the state bytes in flight. K4 runs
   at L 4,096 with segments and a final-state cotangent, and at the training
   rows' 1,064 and 4,136 tokens, its device time split by pass; K5's line
   gives its conv stage's device time and that stage's share of its bytes
   bound. K2 runs with segment ids (its
   library yardstick SDPA with a boolean mask, which takes SDPA's masked
   backend), without them (SDPA's flash backend with is_causal), with its
   row log-sum-exp (held against the plain one) and at each tile of the K2
   microbenchmark's sweep; K2-bwd takes that forward's log-sum-exp, with
   segment ids and without, against SDPA's backward alone (the masked and
   the flash backend; the forward runs once outside the timed call), and
   its device time is split by kernel (dq, dkv). K3 runs at SigLIP's
   shape and at DINOv2-L's (hd 64, T 734); K10a at 8 frames for 1, 2 and 4
   heads a block, with the exp and without it. Each output's SHA-256 is printed, to
   compare the kernels' bits across runs and machines. Last, the qwen2
   backbones' GQA groups (Hq / Hkv 28 / 4, 16 / 2 and 12 / 2: blocks of 1, 8
   and 2 query heads): K2 at L 4,096 segmented and not, and K9 at 1 and 40
   rows x 8,448 keys at 28 / 4 (the qwen2.5-7b decode step and a question);
   K2-bwd at the three groups at L 4,096, segmented and not (qwen2 training),
   against SDPA's backward alone; K9 at the speculative verify's shapes, 8
   queries x an 8,448-row prefix and the 8 x 8 causal own block, at 32 / 8
   and 28 / 4. Last, K2-bwd's non-causal mode (TransV's cross-attention
   backward, given K9's output and row log-sum-exp m + log(l)): 32 text rows
   x 205, 820 and 819 dropped tokens at 32 / 8 and 28 / 4, B 2, 1,000 x 820
   and 4,096 x 4,096, against SDPA's non-causal backward alone. Last, K3's
   and K6's LSE variants (the row log-sum-exp to 1e-4) and the ViT attention
   backward (csrc/vit_attn_bwd.cu, which replaces no Pallas kernel: the JAX
   package differentiates its oracle) at 64 SigLIP frames (T 729, hd 72,
   the fused qkv and its fused gradient), 8 DINOv2-L frames (T 734, hd 64)
   and 16 InternVideo2 clips (T 1,025, hd 88, v a column slice), against
   its plain version (the formulas in f32 from the kernel's own output and
   LSE) and, at 8 SigLIP frames, autograd through the plain f32 forward;
   SDPA's backward alone beside it; bitwise repeatable.
3b. microbenchmarks: K2 at L 81,920 at each tile against plain f32
   attention on the last 256 query rows of heads 0-3 and the first 256 of
   heads 28-31; then bench/microbench_vit_attn.py at 256 frames (K3, K10a,
   SDPA, the qkv projections) and bench/microbench_flash.py at L 81,920 (K2
   at each tile, SDPA), their JSON printed, K10a's launches counted.
4. serving: TimeViper-9B (SigLIP-SO400M-384 + ToMe-16 MLP + Nemotron-H 9B,
   all 52 layers) with random bf16 weights from a seeded CUDA generator, three
   greedy requests through Generator.generate (text only, 64 frames, 256
   frames) and a repeat of the second; the forward kernels' launch counters
   must grow. The kernels are held against their plain versions on the
   inputs the 64-frame request gave them, and the 64-frame request is run
   once more with the plain versions as a reference for its first logits.
   The fused kernels (K5, K7, K8) are switched off here, as by default.
4b. checkpoint: the same 9B (its f32 tensors of ndim >= 2, the Mamba conv
   taps and the position table, first rounded to bf16 values, as the
   loader's cast takes them) written as a reference checkpoint (config.json
   and bf16 .bin shards of ~2 GB in the names train/convert.py reads, under
   a temporary directory) and loaded onto the card through
   models/api.py:load_vlm_weights: every tensor bitwise the built one, the
   load's seconds, GB/s, card memory above what was held (one copy of the
   model at most) and the host's peak RSS printed. Then, with a word-level
   tokenizer (WordTokenizer) and the nano_base template: 64 synthetic
   1280x720 frames through the ported host preprocessing (seconds,
   frames/s), TimeViperModel.chat and a question on prefill_video_prefix,
   K1, K2, K3 and K9 launched; the greedy tokens and texts those of the
   built model's Generator on the same ids and pixels. The loaded model is
   freed.
4c. the training CLI, on 4b's checkpoint (with a word-level Hugging Face
   tokenizer written beside it): timeviper_tpu_torch.train.cli.main on the
   9B, a YAML of two datasets of one 32- and one 64-frame clip (MJPG AVI
   files written and decoded by OpenCV; synthetic frames in place of
   data/video.py:load_video where no backend is found, and a line says so),
   so every batch of 2 is heterogeneous; LoRA rank 8 with the projector,
   4 steps, a checkpoint every 2. Each step's s and peak GiB; K1, K2,
   K2-bwd, K3 and K4 launched; the final artifacts reloaded (the LoRA
   factors bitwise from lora_state.npz); the first batch's heterogeneous
   loss within 1e-2 relative of its rows' static one-row losses, both on
   the same visual embeddings.
4d. remat policies: the CLI's LoRA'd 9B at 4,136 tokens under "full",
   "scan", "dots" and "dots_scan": the first step's gradient cosine with
   "full" (0.9999), the K1 / K2 forward launches in a step, 1 warm-up and 3
   timed steps, peak GiB; then bench_all.py's 52-layer cell (hidden 2,048,
   8,192 tokens, every parameter's gradient) under "full" and "dots_scan".
4e. QLoRA on the 9B's backbone at 4,096 tokens, rank 16: 4 steps on the
   bf16 base, the same factors again on the int8 base (quantize_params_int8
   keeps them), 4 steps; step s, peak GiB, the base's bytes by part, the
   first losses against each other; the int8 base holds fewer bytes.
4f. offload: train/offload.py:StreamedTrainer at the TPU row's shape (3
   layers M*-, hidden 4,096, vocab 2,048, f32 masters and moments on the
   host, 1,024 tokens): 1 warm-up and 3 timed steps, tokens/s, the pinned
   copies' GB/s, the device time split into copies and compute, the host's
   AdamW s; the loss falls.
5. long video, on the same bf16 model: (a) 1,024 frames streamed as four
   256-frame clips of 4,096 tokens, the first through nano_forward with the
   cache filled, the next three through
   models/prefix_cache.py:nano_forward_continue (K1 from the carried states,
   K9 twice per attention layer: exactly 8 launches a clip), whose last-row
   logits are held against one nano_forward over all 16,384 tokens and
   against models/longctx.py:nano_forward_longctx in chunks of 4,096 rows;
   (b) Generator.prefill_prefix on 8 text tokens + 1,016 frames (bucket
   16,384, suffix budget 512), three questions of 12, 40 and 300 tokens
   through generate(prefix=...), the 40-token one held against generate()
   of the whole prompt, and the prefix's cache bitwise unchanged (a SHA-256
   of every K/V buffer and Mamba state before and after); (c) K9 on the
   inputs one attention layer of the 4th clip gave it and K1 on a Mamba
   layer of the 2nd clip (a carried initial state), each against its plain
   version.
5b. the serving engine, on the same bf16 model: serving/engine.py with 8
   slots of 16,384 rows, 4 decode steps a sync, chunks of 2,048 tokens,
   greedy; 15 requests (10 text prompts of 20-900 tokens, batched by bucket
   in the first round; two of 64 frames; a 6,000-token prompt in three
   chunks; two questions on a prefill_prefix of 8 tokens + 256 frames). Every
   request served; first-token logits against Generator.generate (cosine
   0.999); >= 95% of the tokens the argmax of one nano_forward over prompt
   and output of an f32 copy of the backbone; K1, K2, K3 and K9 launched; output tokens/s, rounds and the
   largest gap between rounds, with chunked prefill on and then off.
5c. pdrop and TransV, on the same bf16 model with the JAX package's pdrop
   setting (bench_all.py:377: "uni_14_0.8-attn_18_0.6", CrossAttention;
   the merge modules from a generator of their own, tanh(alpha) = 0.5,
   q_proj scaled to cross-attention logits of std 1; before and after the
   scaling, the 64-frame first logits of the kernels, the plain versions,
   the plain versions one ulp off and an f32 copy, on one keep set, the
   scaled kernel run within a cosine of 0.99 of the f32 one):
   (a) the 64- and 256-frame requests through generate(use_pdrop=True), K1,
   K2, K3 and K9 launched; the rows after each stage (8,192 -> 7,372 ->
   6,553 at 256 frames) and each attention layer's kv_len (8,192 for layer
   7, 6,553 for 18, 29, 40); the first logits (cosine 0.99) and the attn
   stage's keep set (at least 99% overlap) against a run with every plain
   version; K1 and K2 against their plain versions on the path's own inputs
   at each row count (8,192, 7,372, 6,553; 2,048, 1,843, 1,638 at 64
   frames); the 256-frame prefill with and without pdrop in turns; (b) the
   1,016-frame prefix of phase 5 through prefill_prefix(use_pdrop=True) and
   its 40-token question, and nano_forward_longctx with the stages against
   one pdrop nano_forward of the same 16,304 rows (cosine 0.999); (c)
   ServingEngine(pdrop_frames=64), 8 slots: a text-only request and 8 of 64
   frames, each request's tokens those of the offline Generator or, where
   they part, within MISS_GAP_LIMIT of an f32 teacher-forcing pdrop
   forward's argmax; (d) K9 on the TransV calls the paths made (32 suffix
   rows x 820 / 819 dropped tokens at prefill, 1 x 820 / 819 per decode
   step, B 8 in the engine) against its plain version and SDPA.
5d. speculative decoding (models/speculative.py, n_draft 7), on the same
   bf16 9B: the plain and the speculative greedy loop on a text and a
   64-frame prompt with repeated n-grams (32 tokens; tokens/s of each, drafts
   proposed and accepted, verify passes, partial commits; where the tokens
   part, each speculative token within MISS_GAP_LIMIT of the f32 teacher-
   forcing argmax; K1 and K9 launched exactly as the prefill and the rounds
   make them); a speculative question on a PrefixState of 8 tokens + 64
   frames, the prefix's SHA-256 unchanged; the successor rig (one-hot
   embeddings, a shifted lm_head over a cycle of 64 ids, every out_proj /
   o_proj / down_proj zeroed): every draft accepted and the cycle's tokens,
   tokens/s against the plain loop, then one wrong id in the prompt's cycle
   (a partial commit, the same tokens); one verify of 8 rows and one partial
   commit of 4 on the model's own prefill cache of the 64-frame prompt
   against 8 decode steps from copies of it (each row's logits to a cosine
   of 0.999, the caches after both within SPEC_CACHE_TOL, a step after the
   commit, the cache before the verify unchanged), K1's 8- and 4-row calls
   from the carried states and K9's verify and commit blocks against their
   plain versions, and the K/V copy a continuation makes timed against the
   verify.
6. training: LoRA (rank 8, alpha 16) on the same 9B with the projector
   unfrozen, through Trainer.train: four steps on one repeated row of 64
   frames + 40 text tokens (labels on the last 32), then one step on a row of
   256 frames (4,136 tokens). Every loss finite, the 4th below the 1st, every
   kernel of the path launched (K1, K2, K3 forward, K4, K2-bwd). K1 / K4 and
   K2 / K2-bwd are held against their plain versions on the inputs and output
   cotangents the first step gave the first Mamba and attention layer, and
   the first step's loss and LoRA gradient against a run with the plain
   versions swapped in.
   Then the same model trains with pdrop and TransV (PDROP; merge modules as
   in 5c, tanh(alpha) 0.5, q_proj tempered; trainable_modules
   "projector,merge", use_pdrop): four steps on a 64-frame row whose 12
   question tokens carry no labels (1,064 -> 859 -> 654 rows) and one on a
   256-frame row (4,136 -> 3,316 -> 2,497). Every loss finite, the 4th below
   the 1st; K1, K2, K3, K4, K9, K2-bwd and its non-causal mode launched, K9
   and the non-causal mode exactly twice a step; on the first step's own
   inputs and cotangents, K1 / K4 and K2 / K2-bwd at every row count (1,064,
   859, 654), K3 on the tower's first call and the non-causal mode on the
   first TransV call against their plain versions; the first step's
   gradients on the same keep sets, by group (LoRA factors, projector, merge
   q/k/v/o_proj, alpha), against every plain version but K3, cosine 0.99
   each, every merge group's norm non-zero. K3 is the same on both sides of
   that gate: no gradient passes the frozen tower, and one bf16 ulp at its
   place moves ~300 of the 1,024 visual tokens wholly (a discrete choice
   downstream), which the bisection printed beside the gate shows: every
   kernel, each kernel alone among plain versions and the plain versions
   under rounding noise, each against every plain version, with how far
   TransV's inputs and the visual tokens moved. Step s and peak memory
   beside the plain LoRA steps'.
6b. tower training, on the same 9B: LoRA plus trainable_modules=
   "vision_backbone,projector" at vision_lr 2e-5, four Trainer steps at
   1,064 tokens (64 frames; the tower is not recomputed, so 256 frames would
   not fit); K3 (its LSE variant) and the backward kernel exactly one launch
   a tower block and step; losses and grad norms finite, peak memory under
   80 GB (printed with the card and its power limit); before them the first
   step's gradients by group (LoRA, projector, the tower's blocks in thirds,
   its embeddings) against the same step with the backward's plain version,
   K3's forward on both sides, cosine 0.99.
7. int8 serving: the training model is freed and the same seeded bf16
   weights are made again; the ViT and the 9B are quantized to W8A8 as
   bench.py does (train/quantize.py), calibrated on one 64-frame clip, and the
   Mamba in_proj leaves fused. The three requests run with the fusions off
   (TIMEVIPER_FUSED_CONV, TIMEVIPER_FUSED_DECODE, TIMEVIPER_VIT_FUSED_LN = 0)
   and then on. With them on, every Mamba prefill goes through K5 (and none
   through K1), every Mamba decode step through K7 and every LayerNorm of the
   tower through K8: the counts must be exactly that. K5, K7 and K8 are held
   against their plain versions on the inputs the 64-frame request gave them;
   the fused run's first logits against the unfused int8 run's and against a
   run with every kernel's plain version; the tower's features and visual
   tokens of 16 frames are compared across fused, unfused, plain versions and
   the bf16 model. Encode, prefill and decode times of both configurations
   are printed, then the text and 256-frame requests run off, on, on, off.
   Then the JAX package's pdrop serving mix (bench_all.py:348-410) on this
   W8A8 model with the fusions on: the merge modules quantized and
   calibrated on one pdrop prefill, 8 requests x 64 frames, 16 new tokens,
   through ServingEngine(pdrop_frames=64), run twice; output tokens/s; K5,
   K7, K8 and K9 launched.
8. InternVideo2 serving: the int8 model is freed; internvideo2-1b-16-224px +
   tome_mlp-16 + nano-9b-v2 (39 blocks of width 1408, clips of 4 frames merged
   jointly to 64 tokens) with random bf16 weights from the seed, the three
   requests at 224 px. Every encode chunk launches K6 once per block (39) and
   K3 never; K6 is held against its plain version on the q, k and (strided) v
   of the 64-frame request's first layer, and that request's first logits
   against a run with every plain version. Then the model is quantized W8A8
   as in phase 7 (every tower linear, the tubelet embedding too, under
   TIMEVIPER_VIT_INT8_MXU), calibrated on the 64 frames, and serves the
   64-frame request: K6 39 times a chunk, first logits against the plain
   versions with the int8 limit (cosine 0.98).
9. DINOv2 + SigLIP serving: dinosiglip-vit-so-384px + nano-9b-v2, each tower
   with its own ToMe-16 projector, 32 tokens a frame; the text and 64-frame
   requests. Every encode chunk launches K3 23 + 26 times; the first logits
   are held against the plain versions as above.
10. Qwen2: qwen2.5-7b-instruct + siglip-vit-so400m-384px + tome_mlp-16, all 28
   layers, random bf16 weights from the seed (the other models freed first):
   (a) the three requests with the kernels and with every plain version
   (first-logit cosine 0.99; K2 exactly 28 launches a prefill, K9 28 a decode
   step: the Generator's qwen2 decode attention is K9's non-causal mode);
   (b) a 40-token question on a cached prefix of 8 tokens + 256 frames
   (prefill_prefix, generate(prefix=...): K9 twice a layer in the
   continuation) against the whole prompt; (c) pdrop
   "uni_14_0.8-attn_21_0.6" with TransV (tanh(alpha) 0.5, q_proj tempered as
   in 5c) on the 64- and 256-frame requests: the rows after each stage
   (8,192 -> 7,372 -> 6,553), each layer's kv_len, the first logits on one
   keep set against the plain versions, and the attn keep set against
   theirs, within 2 points of how far one ulp on the visual features moves
   the plain versions' own set (or of 99%); (d)
   ServingEngine with 4 slots, a text request and four of 64 frames, each
   the offline Generator's tokens or within MISS_GAP_LIMIT of an f32
   teacher-forcing argmax; (e) phase 5d on this model; (f) LoRA (rank 8)
   with the projector unfrozen, four steps at 1,064 tokens and one at 4,136
   through Trainer.train: losses and grad norms finite, the 4th loss below
   the 1st, K2-bwd launched at pack 1 and held against its plain version on
   a layer's own inputs, the first step's LoRA gradient against the plain K2
   and K2-bwd (cosine above 0.99); step s and peak memory; then pdrop
   training as in phase 6 with docs/USAGE.md's "uni_14_0.8-attn_21_0.6" (K2,
   K3, K9, K2-bwd and its non-causal mode); (g) the weights made again from
   the seed in W8A8 (tower and backbone, q/k/v with their biases; calibrated
   on one 64-frame clip): the 64-frame request (K2 28 launches, K9 28 a
   decode step) against (a)'s bf16 one, first-logit cosine 0.98; a 32-token
   question on a cached prefix of 8 tokens + 64 frames against that whole
   prompt; a 2-slot engine. The launches of (a), (e) and (f) add to the
   kernels line.
11. sequence-parallel serving (parallel/seq_parallel.py), the 9B made
   again from the seed: (a) one NCCL rank in this process,
   nano_prefill_seq_parallel(fill_cache=True) on the 256-frame row with K1
   and then with the fused conv (K5 with halo rows), against the one-card
   prefill (first-logit cosine 0.99, each cache tensor's SP_CACHE_COS); (b) the
   model freed here, two ranks spawned on cuda:0 over gloo (the card holds
   the 9B twice; every collective staged through the host), rank 0 holding
   the one-card references: Generator(mesh=make_mesh(seq=2)) on the
   256-frame request (the encode frame-sharded on K3, the prefill on K1 and
   K9, 16 tokens on K7; tokens equal or within MISS_GAP_LIMIT of the
   one-card teacher-forcing argmax), the seq-2 decode caches of that
   request and of the 16,384-token row (the Mamba states, conv windows and
   K/V rows, each tensor's cosine SP_CACHE_COS) against the one-card
   prefill's, the sharded scan after the seam on inputs that carry a state
   across it against the one-card K1 (SP_SEAM_GAP, which the span's scan
   alone must miss), the ring prefill at 16,384 tokens,
   pdrop uni_14_0.8-attn_18_0.6 with TransV (a kv_valid cache; the one-card
   run replays the sharded keep sets) and a question on its prefix, and a
   3-request ServingEngine(mesh=); each rank's first K1, K9, K3 and K7 calls
   against their plain versions; every rank's tokens equal. Seconds, peak
   GiB and the bytes handed to the collectives are printed, none of them a
   multi-card speed.
12. the training half of parallelism (parallel/tensor_parallel.py), the 9B
   made again from the seed with LoRA rank 8 (lora_b drawn off zero) and the
   projector trainable: one-card references first (the first step's loss
   and gradients on one 1,064-token row and on two, the 256-frame request's
   first logits, tokens and greedy margins with the fusions on, the
   gradient of the mean square of the last 8 logits of a 4,096-token packed
   row), then (a) one NCCL rank, a (1, 1, 1) mesh: the Trainer's first step
   through the mesh code (loss, gradient cosines by group MESH_ONE_COS and
   norm ratios MESH_ONE_NORM);
   then the model freed and two gloo ranks spawned on cuda:0, each building
   its whole model in turn and keeping its shard: (d) seq 2, that gradient
   through nano_prefill_seq_parallel (each block checkpointed; K1 / K4 on
   the spans; the span's queries against the gathered K/V through
   SpanAttnFn, K9 forward and K2-bwd's two modes backward, each on its
   first call against its plain version), (b) model 2, the same model
   sharded (H 64, G 4, Hq / Hkv 16 / 4 a rank): one LoRA step's gradients
   (by group cosine MESH_GRAD_COS and norm ratio MESH_GRAD_NORM, which
   must refuse the gradients x2 and x1/2; loss MESH_LOSS_RTOL; K1 / K4 and
   K2 / K2-bwd on their first
   calls against their plain versions) and the 256-frame request through
   Generator(mesh=) with the fusions on (first-logit cosine MESH_ONE_COS;
   tokens equal or parting where the one-card margin is below
   MISS_GAP_LIMIT; K5, K7, K8 and K3 on their first calls against their
   plain versions), (c) data 2 with the frozen base FSDP-split: one step on
   the two rows, a row a rank (as (b)). Each rank's step seconds, peak GiB,
   bytes handed to the collectives and launches are printed beside the card;
   none of them is a multi-card speed.

The line before the last is one JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Needs the CUDA toolkit (nvcc) and no network.

    python3 chip_smoke.py --profile

also profiles the bf16 encode of the 256-frame request, one more training
step on the 256-frame row after the checks, and the int8 256-frame request
with the fusions off and on (torch.profiler; device time by kernel name and
the device's busy share).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
import hashlib
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

if __name__ == "__main__" and not (Path(__file__).resolve().parent
                                   / "timeviper_tpu_torch").is_dir():
    # refuse before the seconds of importing torch
    sys.exit("chip_smoke: run it from a checkout of the repository")

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing

sys.path.insert(0, str(Path(__file__).resolve().parent))

from timeviper_tpu_torch.config import NanoConfig, VLMConfig  # noqa: E402
from timeviper_tpu_torch.bench import device_ms, microbench_flash, microbench_vit_attn  # noqa: E402
from timeviper_tpu_torch.data.fusion import IGNORE_INDEX  # noqa: E402
from timeviper_tpu_torch.data.loader import collate  # noqa: E402
from timeviper_tpu_torch.models import internvideo2 as iv2_mod  # noqa: E402
from timeviper_tpu_torch.models import longctx as longctx_mod  # noqa: E402
from timeviper_tpu_torch.models import nano as nano_mod  # noqa: E402
from timeviper_tpu_torch.models import pdrop as pdrop_mod  # noqa: E402
from timeviper_tpu_torch.models import prefix_cache as pc_mod  # noqa: E402
from timeviper_tpu_torch.models import qwen2 as qwen2_mod  # noqa: E402
from timeviper_tpu_torch.models import vit as vit_mod  # noqa: E402
from timeviper_tpu_torch.models import vlm as vlm_mod  # noqa: E402
from timeviper_tpu_torch.models.api import build_arch  # noqa: E402
from timeviper_tpu_torch.models.generate import (  # noqa: E402
    Generator,
    pick_bucket,
    split_prompt_at_last_image,
)
from timeviper_tpu_torch.models.longctx import nano_forward_longctx  # noqa: E402
from timeviper_tpu_torch.models.nano import NanoModel, nano_forward  # noqa: E402
from timeviper_tpu_torch.models.pdrop import (  # noqa: E402
    init_merge_modules,
    make_pdrop_spec,
)
from timeviper_tpu_torch.models.prefix_cache import (  # noqa: E402
    forward_continue,
    nano_forward_continue,
)
from timeviper_tpu_torch.models.vlm import (  # noqa: E402
    decode_step,
    encode_visual,
    init_vlm_params,
    llm_forward,
    vlm_forward,
    vlm_loss,
)
from timeviper_tpu_torch.ops import _cuda  # noqa: E402
from timeviper_tpu_torch.ops import attention as attn_mod  # noqa: E402
from timeviper_tpu_torch.ops import flash_attention as flash_mod  # noqa: E402
from timeviper_tpu_torch.ops import ssd_kernel as ssd_kernel_mod  # noqa: E402
from timeviper_tpu_torch.ops.block_attention import (  # noqa: E402
    BLOCK_ROWS,
    block_attn_lse,
    block_attn_lse_plain,
    block_attn_plan,
    row_lse,
)
from timeviper_tpu_torch.ops.block_attention import gqa_pack  # noqa: E402
from timeviper_tpu_torch.ops.decode_fused import (  # noqa: E402
    fused_mamba_decode,
    fused_mamba_decode_plain,
)
from timeviper_tpu_torch.ops.flash_attention import (  # noqa: E402
    FLASH_BWD_TILE,
    FLASH_TILE,
    FLASH_TILES,
    cross_attention_bwd,
    cross_attention_bwd_plain,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_plain,
    flash_lse_plain,
)
from timeviper_tpu_torch.ops.headgrid_attention import (  # noqa: E402
    HEADGRID_TILE,
    headgrid_attention,
    headgrid_attention_plain,
    pad_heads,
)
from timeviper_tpu_torch.ops.int8_linear import Int8Linear  # noqa: E402
from timeviper_tpu_torch.ops.layernorm import fused_ln, fused_ln_plain  # noqa: E402
from timeviper_tpu_torch.ops.ssd import _process_dt, ssd_chunked  # noqa: E402
from timeviper_tpu_torch.ops.ssd_kernel import (  # noqa: E402
    fwd_blocks,
    fwd_plan,
    kernel_chunk,
    ssd_conv_scan_fused,
    ssd_conv_scan_fused_plain,
    ssd_scan,
    ssd_scan_bwd,
    ssd_scan_bwd_plain,
    ssd_scan_fwd,
)
from timeviper_tpu_torch.ops import vit_attention as vit_attention_mod  # noqa: E402
from timeviper_tpu_torch.ops.vit_attention import (  # noqa: E402
    VIT_ATTN_BLOCK_ROWS,
    VIT_BWD_TILE,
    VIT_QKV_BLOCK_ROWS,
    vit_attention,
    vit_attention_bwd,
    vit_attention_bwd_plain,
    vit_attention_lse_plain,
    vit_attention_plain,
    vit_attention_qkv,
    vit_attention_qkv_bwd,
    vit_attention_qkv_bwd_plain,
    vit_attention_qkv_lse_plain,
    vit_attention_qkv_plain,
)
from timeviper_tpu_torch.parallel import seq_parallel as sp_mod  # noqa: E402
from timeviper_tpu_torch.parallel import sharding as sharding_mod  # noqa: E402
from timeviper_tpu_torch.parallel.seq_parallel import nano_prefill_seq_parallel  # noqa: E402
from timeviper_tpu_torch.parallel.sharding import make_mesh  # noqa: E402
from timeviper_tpu_torch.serving import Request, ServingEngine  # noqa: E402
from timeviper_tpu_torch.train.lora import add_lora  # noqa: E402
from timeviper_tpu_torch.train.optim import OptimConfig  # noqa: E402
from timeviper_tpu_torch.train.quantize import (  # noqa: E402
    calibrate_act_scales,
    fuse_decode_in_proj,
    quantize_params_int8,
)
from timeviper_tpu_torch.train.step import grad_step, trainable_params  # noqa: E402
from timeviper_tpu_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

DEV = torch.device("cuda")
SEED = 0
IMAGE_TOKEN = 131000  # an id inside the 131072 vocabulary that no text id uses
MAX_NEW = 16
# phase 5b: the largest gap, under the f32 teacher-forcing reference, between
# a row's argmax logit and the engine's token where they differ. Sound runs
# missed only at near-ties, with gaps of at most 4.9e-2 (NVIDIA H100 80GB
# HBM3, 700 W); a slot that attends over the wrong keys misses by more.
MISS_GAP_LIMIT = 0.1
# pdrop / TransV on the 9B as the JAX package benchmarks it (bench_all.py:377):
# uniform keep of 80% before layer 14, then 60% of the original visual
# tokens ranked by layer 18's attention; TransV gated at tanh(alpha) = 0.5
# (alpha starts at 0, where a broken cross-attention would pass every check)
PDROP = dict(use_pdrop=True, pdrop_type="uni_14_0.8-attn_18_0.6", merge_module="CrossAttention")
PDROP_ALPHA = math.atanh(0.5)
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
FUSIONS = ("TIMEVIPER_FUSED_CONV", "TIMEVIPER_FUSED_DECODE", "TIMEVIPER_VIT_FUSED_LN")
# the qwen2 backbones' (query heads, KV heads): qwen2.5-7b, qwen2.5-3b, qwen2-1.5b
QWEN2_GQA = ((28, 4), (16, 2), (12, 2))

# Per kernel: its source, the TPU kernel it replaces (file:line) and its
# tolerance, relative to the plain result's largest magnitude. Forward: both
# sides read the same bf16 inputs, round their output to bf16 (2^-8
# relative) and sum in f32 in other orders; both attentions round their
# probabilities to bf16 before the PV product. Backward: the kernels also
# feed bf16-rounded decay, probability and dS tiles to the tensor cores where
# the plain versions multiply in f32, and each gradient sums many of them.
KERNELS = {
    "ssd_fwd": dict(source="timeviper_tpu_torch/csrc/ssd_fwd.cu",
                    replaces="timeviper_tpu/ops/ssd_pallas.py:52", rel_tol=1e-2),
    # K2: o as the other forward kernels; its row log-sum-exp (the variant
    # that returns it), f32 sums of bf16 logits in other orders, to 1e-4
    "flash_fwd": dict(source="timeviper_tpu_torch/csrc/flash_fwd.cu",
                      replaces="timeviper_tpu/ops/flash_pallas.py:39", rel_tol=(1e-2, 1e-4)),
    # K3 and K6: o as the other forward kernels; their LSE variants' row
    # log-sum-exp as K2's, to 1e-4
    "vit_attn_qkv": dict(source="timeviper_tpu_torch/csrc/vit_attn_qkv.cu",
                         replaces="timeviper_tpu/ops/vit_attention.py:197", rel_tol=(1e-2, 1e-4)),
    "vit_attn": dict(source="timeviper_tpu_torch/csrc/vit_attn.cu",
                     replaces="timeviper_tpu/ops/vit_attention.py:76", rel_tol=(1e-2, 1e-4)),
    "ssd_bwd": dict(source="timeviper_tpu_torch/csrc/ssd_bwd.cu",
                    replaces="timeviper_tpu/ops/ssd_pallas.py:482", rel_tol=3e-2),
    # the ViT attention backward (a trainable tower): no Pallas kernel in the
    # JAX package, which differentiates its jnp oracle off the TPU (the
    # dispatcher at :318); as K2-bwd, bf16 P and dS tiles on the tensor cores
    "vit_attn_bwd": dict(source="timeviper_tpu_torch/csrc/vit_attn_bwd.cu",
                         replaces="timeviper_tpu/ops/vit_attention.py:318", rel_tol=3e-2),
    "flash_bwd": dict(source="timeviper_tpu_torch/csrc/flash_bwd.cu",
                      replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:941",
                      rel_tol=3e-2),
    # K2-bwd's non-causal, rectangular mode (TransV's cross-attention
    # backward; the bundled kernels with causal=False): as its causal mode
    "flash_bwd_noncausal": dict(source="timeviper_tpu_torch/csrc/flash_bwd.cu",
                                replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:941",
                                rel_tol=3e-2),
    # K5 reads the same bf16 raw streams as its plain version and rounds the
    # convolved streams to bf16 as it does; from there the K1 argument holds
    "ssd_conv_fwd": dict(source="timeviper_tpu_torch/csrc/ssd_fwd.cu",
                         replaces="timeviper_tpu/ops/ssd_pallas.py:981", rel_tol=1e-2),
    # K7 and K8: f32 arithmetic on both sides in other orders, bf16 outputs;
    # K8's int8 codes may differ by 1 at ties (at most 0.1% of them)
    "decode_fused": dict(source="timeviper_tpu_torch/csrc/decode_fused.cu",
                         replaces="timeviper_tpu/ops/decode_fused.py:39", rel_tol=1e-2),
    "layernorm": dict(source="timeviper_tpu_torch/csrc/layernorm.cu",
                      replaces="timeviper_tpu/ops/layernorm.py:37", rel_tol=1e-2),
    # K9: o (bf16) against its own largest value,
    # with no floor (|o| <= 1 and about 0.015 over 12k random keys), and the
    # f32 row statistics l and m of bf16 logits, summed in other orders, to
    # 1e-4: a mask that dropped 64 of 12,288 keys moves l by 0.5%
    "block_attn": dict(source="timeviper_tpu_torch/csrc/block_attn.cu",
                       replaces="timeviper_tpu/parallel/seq_parallel.py:187",
                       rel_tol=(1e-2, 1e-4, 1e-4), floor=0.0),
    # K10a: bf16 probabilities and sums of them in f32 on both sides, as K3;
    # against its own largest value with no floor (its outputs, averages of
    # 729 values of v, stay far below 1)
    "headgrid_attn": dict(source="timeviper_tpu_torch/csrc/headgrid_attn.cu",
                          replaces="scripts/microbench_vit_attn.py:65", rel_tol=1e-2,
                          floor=0.0),
}
WRAPPERS = {"ssd_fwd": ssd_scan, "flash_fwd": flash_attention,
            "vit_attn_qkv": vit_attention_qkv, "ssd_bwd": ssd_scan_bwd,
            "flash_bwd": flash_attention_bwd, "flash_bwd_noncausal": cross_attention_bwd,
            "ssd_conv_fwd": ssd_conv_scan_fused,
            "decode_fused": fused_mamba_decode, "layernorm": fused_ln,
            "vit_attn": vit_attention, "block_attn": block_attn_lse,
            "headgrid_attn": headgrid_attention, "vit_attn_bwd": vit_attention_bwd}
SERVING = ("ssd_fwd", "flash_fwd", "vit_attn_qkv")
TRAINING = SERVING + ("ssd_bwd", "flash_bwd")
# five pdrop training steps of two stages, each stage's TransV one K9 forward
# and one backward in K2-bwd's non-causal mode
TRANSV_TRAIN_LAUNCHES = {"block_attn": 10, "flash_bwd_noncausal": 10}
FUSED = ("ssd_conv_fwd", "decode_fused", "layernorm")
# where the model calls each forward kernel, and the kernel's plain version
ROUTES = {"ssd_fwd": (nano_mod, "ssd_scan"), "flash_fwd": (nano_mod, "flash_attention"),
          "vit_attn_qkv": (vit_mod, "encoder_attention_qkv"),
          "ssd_conv_fwd": (nano_mod, "ssd_conv_scan_fused"),
          "decode_fused": (nano_mod, "fused_mamba_decode"), "layernorm": (vit_mod, "fused_ln"),
          "vit_attn": (iv2_mod, "encoder_attention"),
          "block_attn": (attn_mod, "block_attn_lse")}  # K9 as TransV's cross_attention
CALLS = {name: getattr(mod, attr) for name, (mod, attr) in ROUTES.items()}
PLAIN = {"ssd_fwd": ssd_chunked, "flash_fwd": flash_attention_plain,
         "vit_attn_qkv": vit_attention_qkv_plain, "ssd_conv_fwd": ssd_conv_scan_fused_plain,
         "decode_fused": fused_mamba_decode_plain, "layernorm": fused_ln_plain,
         "vit_attn": vit_attention_plain, "block_attn": block_attn_lse_plain}


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_ms(fn, iters: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name: str, got, want) -> float:
    """Max abs error of the kernel output(s) against the plain one(s); raises
    past the kernel's tolerance (relative to the plain result's largest
    magnitude, and for the forward kernels to at least 1 unless the kernel
    names its own floor; one tolerance for all outputs or one each). int8
    codes may differ by 1 at no more than 0.1% of elements. A -inf of the
    plain result (K9's m of a row that saw no key) must be one of the
    kernel's too."""
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    floor = KERNELS[name].get("floor", 0.0 if "_bwd" in name else 1.0)
    tols = KERNELS[name]["rel_tol"]
    worst, parts = 0.0, []
    for i, (g, w) in enumerate(pairs):
        if g is None or w is None:  # an input with no gradient on one side
            continue
        if g.dtype == torch.int8:
            d = (g.int() - w.int()).abs()
            share = (d != 0).float().mean().item()
            if d.max().item() > 1 or share > 1e-3:
                raise AssertionError(f"{name}: output {i}: int8 codes off by up to "
                                     f"{d.max().item()} at {share:.2e} of elements")
            parts.append(f"int8 codes off by <= {d.max().item()} at {share:.2e}")
            continue
        g, w = g.float(), w.float()
        dead = torch.isneginf(w)
        if not torch.equal(torch.isneginf(g), dead):
            raise AssertionError(f"{name}: output {i}: -inf where the plain one has none, "
                                 "or the other way round")
        g, w = g.masked_fill(dead, 0.0), w.masked_fill(dead, 0.0)
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite kernel output {i}")
        err = (g - w).abs().max().item()
        scale = max(w.abs().max().item(), floor)
        tol = tols[i] if isinstance(tols, tuple) else tols
        if err > tol * scale:
            raise AssertionError(f"{name}: output {i}: max abs error {err:.3e} > "
                                 f"{tol} x {scale:.3e}")
        worst = max(worst, err)
        parts.append(f"{err:.2e}/{scale:.2e}")
    if len(parts) > 1 or any("int8" in part for part in parts):
        log(f"[compare] {name}, max abs error / largest plain magnitude per output: "
            + ", ".join(parts))
    return worst


def bound(flops: float, moved: float, peak: float = PEAK_BF16_FLOPS):
    """The least time (ms) the card could take: the larger of the operations
    over the peak rate for their type (the bf16 tensor cores by default) and
    the bytes over the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, moved / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def segments(L: int, pad: int, cut: int) -> torch.Tensor:
    """A left pad of -1, segment 0 up to `cut`, segment 1 after: the
    Generator's pad plus one packed boundary."""
    seq = torch.zeros(1, L, dtype=torch.int32, device=DEV)
    seq[:, :pad] = -1
    seq[:, cut:] = 1
    return seq


def causal_pairs(seq: torch.Tensor) -> int:
    """(query, key) pairs a causal, segment-equality mask keeps in one row of
    contiguous segments: the work this run's data needs."""
    _, counts = torch.unique_consecutive(seq[0], return_counts=True)
    return sum(c * (c + 1) // 2 for c in counts.tolist())


def ssd_flops(L, H, P, G, N, cs, backward=False) -> float:
    """The chunked algorithm's products, the causal half of each chunk tile
    counted once: C.B^T, (C.B^T * decay) x, chunk states, C . inbound state;
    the backward recomputes C.B^T and adds dM, M^T dy, dCB B, dCB^T C and
    five P x N products."""
    nc = -(-L // cs)
    if backward:
        return nc * (G * cs * cs * N + H * cs * cs * (2 * P + 2 * N) + 10 * H * cs * P * N)
    return nc * (G * cs * cs * N + H * cs * cs * P + 4 * H * cs * P * N)


def k1_plan(L: int, G: int, R: int, cs: int) -> str:
    """K1's launch at one batch row of L rows: its two product kernels'
    blocks (chunk_scan's tiles that start before L), warpgroups, head slices
    and shared memory a block."""
    kc = kernel_chunk(cs)
    n_sm = torch.cuda.get_device_properties(DEV).multi_processor_count
    s_state, s_scan = fwd_plan(1, L, G, R, kc, n_sm)
    (scan_t, scan_smem), (state_t, state_smem) = fwd_blocks()
    return (f"chunk_scan {-(-L // 64) * G * s_scan} blocks of {scan_t // 128} warpgroups "
            f"(head slices {s_scan}), {scan_smem} B of shared memory a block; chunk_state "
            f"{-(-L // kc) * G * s_state} blocks of {state_t // 128} warpgroups (head slices "
            f"{s_state}), {state_smem} B")


def sdpa(q, k, v, seq=None, causal=True, flash=False):
    """torch's scaled_dot_product_attention, the library yardstick (timed
    here, called nowhere in the port), on (B, L, H, D) inputs: the KV heads
    repeated for GQA and the layout changed once, outside the timed call; the
    causal and segment mask given as a boolean mask, which takes SDPA's
    masked backend. `flash`: causal with no segments as is_causal, on
    contiguous inputs, forced to SDPA's flash backend. Returns (call,
    inputs)."""
    rep = q.shape[2] // k.shape[2]
    inputs = (q.transpose(1, 2), k.repeat_interleave(rep, 2).transpose(1, 2),
              v.repeat_interleave(rep, 2).transpose(1, 2))
    if flash:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        inputs = tuple(x.contiguous() for x in inputs)

        def flash_call(*qkv):
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                return torch.nn.functional.scaled_dot_product_attention(*(qkv or inputs),
                                                                        is_causal=True)

        return flash_call, inputs
    mask = None
    if causal:
        L = q.shape[1]
        mask = torch.ones(L, L, dtype=torch.bool, device=DEV).tril()
        if seq is not None:
            mask = mask & (seq[0][:, None] == seq[0][None, :])

    def call(*qkv):
        return torch.nn.functional.scaled_dot_product_attention(*(qkv or inputs),
                                                                attn_mask=mask)

    return call, inputs


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {smi}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    path = _cuda.build()
    _cuda.lib()
    log(f"[build] {path.relative_to(Path(__file__).resolve().parent)} in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {_cuda.build_seconds:.1f} s)")
    sm90 = False  # inside the log of a source built on csrc/attn_sm90.cuh
    for line in _cuda.build_log.splitlines():
        if line.startswith("=="):
            sm90 = line[3:] in ("block_attn.cu", "vit_attn.cu", "flash_fwd.cu",
                                "vit_attn_qkv.cu", "headgrid_attn.cu", "flash_bwd.cu",
                                "vit_attn_bwd.cu",
                                "ssd_bwd.cu", "ssd_fwd.cu", "decode_fused.cu")
        if (line.startswith("==") or "registers" in line or "spill" in line
                or sm90 and ("entry function" in line or "warning" in line.lower()
                             or "(C75" in line)):  # ptxas's wgmma notes
            log(f"[build]   {line.strip()}")
    lib = _cuda.lib()
    log(f"[build] dynamic shared memory a block: K2-bwd dkv {lib.tv_flash_bwd_smem(0)} B, dq "
        f"{lib.tv_flash_bwd_smem(1)} B (tile {FLASH_BWD_TILE}); K10a (tile {HEADGRID_TILE}) hpp "
        f"1 {lib.tv_headgrid_smem(1)} B, hpp 2 and 4 {lib.tv_headgrid_smem(2)} B; K4 dc / db "
        f"{lib.tv_ssd_bwd_smem()} B; ViT attention backward dkv / dq at hd 72, 64, 88 "
        f"{', '.join(f'{lib.tv_vit_attn_bwd_smem(0, h)} / {lib.tv_vit_attn_bwd_smem(1, h)} B' for h in (72, 64, 88))}"
        f"; K1 chunk_scan / chunk_state "
        f"{' / '.join(f'{smem} B ({threads} threads)' for threads, smem in fwd_blocks())}")


def kernel_ms(fn, iters: int = 5) -> dict:
    """Device time (ms) of one call by kernel name (torch.profiler), for a
    call that launches several kernels; the largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / iters / 1e3) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    return dict(rows)


def kernel_split(fn, iters: int = 5) -> str:
    return ", ".join(f"{key[:60]} {ms:.4f}" for key, ms in kernel_ms(fn, iters).items())


def kernel_cases(g: torch.Generator):
    """Inputs at the main paths' shapes: (name, kernel call, plain call,
    library call or None, (operations, bytes)[, options]). The plain version
    of a backward kernel, and its library call, run the forward too: they
    compute the gradients from the inputs alone. Options: `variant` names one
    of several cases of a kernel, `main` marks the one its line in the
    kernels record gives, `peak` the operations' peak rate, `device` times
    the calls by their device time with a cold L2 (ms-scale calls are timed
    by CUDA events around a loop), `repeat` asks a second call for the same
    bits, and `launch` describes the kernel's launch (its line then gives
    the achieved TFLOP/s and the share of the bound)."""
    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=DEV) * scale).to(torch.bfloat16)

    def f32(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=DEV) * scale

    # K1 / K4: one Mamba layer of the 9B at L = 4096 (16 chunks of 256), with
    # a left pad and a packed boundary
    L, H, P, G, N, cs = 4096, 128, 64, 8, 128, 256
    x, dt = randn(1, L, H, P), randn(1, L, H, scale=0.5)
    Bm, Cm = randn(1, L, G, N), randn(1, L, G, N)
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=DEV)
    D = torch.ones(H, dtype=torch.float32, device=DEV)
    dtb = torch.log(torch.expm1(torch.full((H,), 0.01, device=DEV)))
    seq = segments(L, 300, 2500)
    ssd_kw = dict(chunk_size=cs, D=D, dt_bias=dtb, seq_idx=seq)
    y, final = ssd_scan(x, dt, A, Bm, Cm, **ssd_kw)
    yield ("ssd_fwd", lambda: ssd_scan(x, dt, A, Bm, Cm, **ssd_kw),
           lambda: ssd_chunked(x, dt, A, Bm, Cm, **ssd_kw), None,
           (ssd_flops(L, H, P, G, N, cs), nbytes(x, dt, Bm, Cm, seq, y, final)),
           dict(variant=f"segmented, L {L}", repeat=True, split=True,
                launch=k1_plan(L, G, H // G, cs)))
    # K1 at L 8,192 with the Generator's left pad of 8,192 - 4,136 rows (the
    # 256-frame prefill's bucket), from a generator of its own so that the
    # other kernels' inputs (and their printed SHA-256) stay as they were
    g8 = torch.Generator(device=DEV).manual_seed(SEED + 11)
    L8 = 8192
    r8 = lambda *shape, scale=1.0: (torch.randn(  # noqa: E731
        *shape, generator=g8, device=DEV) * scale).to(torch.bfloat16)
    x8, dt8, B8, C8 = r8(1, L8, H, P), r8(1, L8, H, scale=0.5), r8(1, L8, G, N), r8(1, L8, G, N)
    kw8 = dict(ssd_kw, seq_idx=segments(L8, L8 - 4136, L8))
    y8, final8 = ssd_scan(x8, dt8, A, B8, C8, **kw8)
    yield ("ssd_fwd", lambda: ssd_scan(x8, dt8, A, B8, C8, **kw8),
           lambda: ssd_chunked(x8, dt8, A, B8, C8, **kw8), None,
           (ssd_flops(L8, H, P, G, N, cs), nbytes(x8, dt8, B8, C8, kw8["seq_idx"], y8, final8)),
           dict(variant=f"L {L8}, a left pad of {L8 - 4136} rows", main=False, repeat=True,
                split=True, launch=k1_plan(L8, G, H // G, cs)))
    del x8, dt8, B8, C8, y8, final8, kw8

    # K4 on the same layer with a final-state cotangent (the main case), then
    # at the LoRA training rows' lengths (64 and 256 frames: ragged last
    # chunks, no segment ids, no final-state cotangent)
    from timeviper_tpu_torch.ops.ssd_kernel import bwd_head_slices

    n_sm = torch.cuda.get_device_properties(DEV).multi_processor_count
    g4 = torch.Generator(device=DEV).manual_seed(SEED + 10)
    for L4 in (L, 1064, 4136):
        main = L4 == L
        # the training shapes draw from a generator of their own, so that the
        # other kernels' inputs (and their printed SHA-256) stay as they were
        r4 = randn if main else (lambda *shape, scale=1.0: (torch.randn(
            *shape, generator=g4, device=DEV) * scale).to(torch.bfloat16))
        x4, dt4, B4, C4 = ((x, dt, Bm, Cm) if main else
                           (r4(1, L4, H, P), r4(1, L4, H, scale=0.5),
                            r4(1, L4, G, N), r4(1, L4, G, N)))
        seq4 = seq if main else None
        dy = r4(1, L4, H, P)
        dfin = torch.randn(1, H, P, N, generator=g, device=DEV) if main else None
        _, _, states = ssd_scan_fwd(x4, dt4, A, B4, C4, cs, D, dtb, (0.0, float("inf")), seq4,
                                    None, keep_states=True)
        args = (x4, dt4, A, B4, C4, D, dtb, seq4)
        outs = ssd_scan_bwd(*args, states, dy, dfin, cs)
        nc, T = -(-L4 // cs), cs // 64
        S = bwd_head_slices(nc, cs, G, H // G, 1, n_sm)
        plan = (f"dc and db {nc * T * G * S} blocks each of 2 warpgroups, a 64-row tile of "
                f"a chunk, a group and a slice of {H // G // S} heads (S {S}), "
                f"{_cuda.lib().tv_ssd_bwd_smem()} B of shared memory")
        yield ("ssd_bwd", lambda args=args, states=states, dy=dy, dfin=dfin:
               ssd_scan_bwd(*args, states, dy, dfin, cs),
               lambda args=args, dy=dy, dfin=dfin: ssd_scan_bwd_plain(*args, dy, dfin, cs), None,
               (ssd_flops(L4, H, P, G, N, cs, backward=True),
                nbytes(x4, dt4, B4, C4, seq4, states, dy, dfin, *outs)),
               dict(variant="segmented, final-state cotangent, L 4096" if main else
                    f"training row, L {L4}", main=main, launch=plan, split=True))
        del states, outs, args, dy

    # K2 / K2-bwd: one attention layer of the 9B at L = 4096, same segments
    # (the main case: the paths pass ids, -1 for left pads); then without
    # segments, against SDPA's flash backend; then with the row log-sum-exp
    # that K2-bwd takes
    Hq, Hkv, hd = 32, 8, 128
    q, k, v = randn(1, L, Hq, hd), randn(1, L, Hkv, hd), randn(1, L, Hkv, hd)
    pairs = causal_pairs(seq)
    out, lse = flash_attention_fwd(q, k, v, seq, with_lse=True)
    lib, lib_inputs = sdpa(q, k, v, seq)
    pack = gqa_pack(Hq, Hkv)

    def k2_plan(tile):
        blocks = -(-L * pack // tile[0]) * (Hq // pack)
        return (f"{blocks} blocks of {tile[0]} (row, head) pairs ({tile[0] // pack} tokens x "
                f"{pack} heads), {tile[1]} keys a tile")

    yield ("flash_fwd", lambda: flash_attention(q, k, v, segment_ids=seq),
           lambda: flash_attention_plain(q, k, v, segment_ids=seq), lib,
           (4 * Hq * hd * pairs, nbytes(q, k, v, seq, out)),
           dict(variant="segmented; library: SDPA with a boolean mask (masked backend)",
                repeat=True, launch=k2_plan(FLASH_TILE)))
    yield ("flash_fwd", lambda: flash_attention(q, k, v),
           lambda: flash_attention_plain(q, k, v), sdpa(q, k, v, flash=True)[0],
           (4 * Hq * hd * L * (L + 1) // 2, nbytes(q, k, v, out)),
           dict(variant="unsegmented; library: SDPA flash backend, is_causal", main=False,
                repeat=True, launch=k2_plan(FLASH_TILE)))
    yield ("flash_fwd", lambda: flash_attention_fwd(q, k, v, seq, with_lse=True),
           lambda: (flash_attention_plain(q, k, v, segment_ids=seq), flash_lse_plain(q, k, seq)),
           None, (4 * Hq * hd * pairs, nbytes(q, k, v, seq, out, lse)),
           dict(variant="segmented, with the row log-sum-exp", main=False, repeat=True))
    do = randn(1, L, Hq, hd)

    def sdpa_bwd(call, inputs):
        """SDPA's backward alone: its forward runs once, with grad, here;
        the call times autograd.grad through that graph."""
        leaves = [t.detach().requires_grad_() for t in inputs]
        out_l, g_l = call(*leaves), do.transpose(1, 2).contiguous()
        return lambda: torch.autograd.grad(out_l, leaves, g_l, retain_graph=True)

    # K2-bwd's launch plan: the dK/dV kernel's blocks and their query walk,
    # the dQ kernel's blocks as K2's
    kb, qt, rows_q, kt = FLASH_BWD_TILE
    bwd_plan = (f"dkv {Hkv * -(-L // kb)} blocks of {kb} keys, each walking {Hq // Hkv} "
                f"heads' {qt}-query tiles from its diagonal; dq "
                f"{-(-L * pack // rows_q) * (Hq // pack)} blocks of {rows_q} (row, head) pairs "
                f"({rows_q // pack} tokens x {pack} heads), {kt} keys a tile")
    out_u, lse_u = flash_attention_fwd(q, k, v, None, with_lse=True)
    for segmented in (True, False):
        sq, o_, l_ = (seq, out, lse) if segmented else (None, out_u, lse_u)
        yield ("flash_bwd", lambda sq=sq, o_=o_, l_=l_: flash_attention_bwd(q, k, v, o_, do, l_, sq),
               lambda sq=sq: flash_attention_bwd_plain(q, k, v, do, sq),
               sdpa_bwd(lib, lib_inputs) if segmented else sdpa_bwd(*sdpa(q, k, v, flash=True)),
               (10 * Hq * hd * (pairs if segmented else L * (L + 1) // 2),
                nbytes(q, k, v, o_, do, l_, sq, q, k, v)),
               dict(variant="segmented; library: SDPA's backward alone, masked backend"
                    if segmented else "unsegmented; library: SDPA flash backend's backward "
                    "alone, is_causal", main=segmented, repeat=True, launch=bwd_plan,
                    split=True))
    del out_u, lse_u
    # K2 at each tile of the microbenchmark's sweep (phase 3b), same inputs
    for tile in FLASH_TILES:
        yield ("flash_fwd",
               lambda tile=tile: flash_attention_fwd(q, k, v, seq, False, tile)[0],
               lambda: flash_attention_plain(q, k, v, segment_ids=seq), lib,
               (4 * Hq * hd * pairs, nbytes(q, k, v, seq, out)),
               dict(variant=f"tile {tile[0]} x {tile[1]}", main=False, launch=k2_plan(tile)))
    del lib, lib_inputs

    # K3: one SigLIP-SO400M layer over 8 frames (the main case), and one
    # DINOv2-L layer (1 + 4 registers + 729 patches, hd 64) over 8 frames
    F_, T, nh, vhd = 8, 729, 16, 72
    for T3, hd3 in ((T, vhd), (734, 64)):
        qkv = randn(F_, T3, 3 * nh * hd3)
        vq, vk, vv = qkv.reshape(F_, T3, 3, nh, hd3).unbind(2)
        yield ("vit_attn_qkv", lambda qkv=qkv, hd3=hd3: vit_attention_qkv(qkv, nh, hd3),
               lambda qkv=qkv, hd3=hd3: vit_attention_qkv_plain(qkv, nh, hd3),
               sdpa(vq, vk, vv, causal=False)[0],
               (4 * F_ * nh * T3 * T3 * hd3, nbytes(qkv) * 4 // 3),
               dict(variant=f"T {T3}, hd {hd3}", main=hd3 == vhd, repeat=True,
                    launch=f"{-(-T3 // VIT_QKV_BLOCK_ROWS) * nh * F_} blocks of "
                           f"{VIT_QKV_BLOCK_ROWS} rows"))
        del qkv, vq, vk, vv

    # K10a: the ViT microbenchmark's head-grid kernel on one SigLIP layer over
    # 8 frames, heads padded from 72 to 128 columns, at each hpp with and
    # without the exp; N(0, 1) inputs (the script's N(0, 0.3) make the
    # softmax nearly flat); the library yardstick is SDPA on the padded q, k
    # and v with hd 72's scale
    qkv = pad_heads(randn(F_, T, 3 * nh * vhd), nh, vhd).contiguous()
    lib_in = [x.transpose(1, 2).contiguous() for x in qkv.reshape(F_, T, 3, nh, 128).unbind(2)]

    def lib10():
        return torch.nn.functional.scaled_dot_product_attention(*lib_in, scale=vhd ** -0.5)

    rows10, keys10 = HEADGRID_TILE
    for hpp in (1, 2, 4):
        for do_exp in (True, False):
            yield ("headgrid_attn",
                   lambda hpp=hpp, e=do_exp: headgrid_attention(qkv, nh, hpp, vhd ** -0.5, e),
                   lambda e=do_exp: headgrid_attention_plain(qkv, nh, vhd ** -0.5, do_exp=e),
                   lib10 if do_exp else None,
                   (4 * F_ * nh * T * T * 128, nbytes(qkv) * 4 // 3),
                   dict(variant=f"hpp {hpp}, exp {'on' if do_exp else 'off'}",
                        main=hpp == 2 and do_exp, repeat=True,
                        launch=f"{-(-T // rows10) * (nh // hpp) * F_} blocks of {rows10} rows x "
                               f"{hpp} heads in turn, {keys10} keys a tile"))
    del qkv, lib_in

    # K6: one InternVideo2 layer over 16 clips (64 frames); q and k as the
    # q/k norms give them, v a column slice of the fused qkv projection
    B6, T6, H6, hd6 = 16, 1025, 16, 88
    qkv = randn(B6, T6, 3 * H6 * hd6)
    cq, ck = randn(B6, T6, H6, hd6), randn(B6, T6, H6, hd6)
    cv = qkv[..., 2 * H6 * hd6:].view(B6, T6, H6, hd6)
    out = vit_attention(cq, ck, cv)
    yield ("vit_attn", lambda: vit_attention(cq, ck, cv), lambda: vit_attention_plain(cq, ck, cv),
           sdpa(cq, ck, cv, causal=False)[0],
           (4 * B6 * H6 * T6 * T6 * hd6, nbytes(cq, ck, out) + cv.numel() * cv.element_size()),
           dict(repeat=True, launch=f"{-(-T6 // VIT_ATTN_BLOCK_ROWS) * H6 * B6} blocks of "
                                    f"{VIT_ATTN_BLOCK_ROWS} rows"))
    del qkv, cq, ck, cv, out

    # K5: K1's layer with the conv fused in, on raw streams that are column
    # slices of one in-projection output (the fused in_proj leaf's layout)
    di, gn = H * P, G * N
    proj = randn(1, L, 2 * di + 2 * gn + H)
    xr = proj[..., di:2 * di].reshape(1, L, H, P)
    Br = proj[..., 2 * di:2 * di + gn].reshape(1, L, G, N)
    Cr = proj[..., 2 * di + gn:2 * di + 2 * gn].reshape(1, L, G, N)
    dtr = proj[..., 2 * di + 2 * gn:]
    conv = {"wx": f32(di, 4, scale=0.3), "bx": f32(di, scale=0.1), "wB": f32(gn, 4, scale=0.3),
            "bB": f32(gn, scale=0.1), "wC": f32(gn, 4, scale=0.3), "bC": f32(gn, scale=0.1)}
    y, final = ssd_conv_scan_fused(xr, dtr, A, Br, Cr, conv, **ssd_kw)
    # its conv stage reads the raw streams and writes the convolved ones once
    conv_bytes = 2 * nbytes(xr, Br, Cr) + nbytes(seq, *conv.values())
    yield ("ssd_conv_fwd", lambda: ssd_conv_scan_fused(xr, dtr, A, Br, Cr, conv, **ssd_kw),
           lambda: ssd_conv_scan_fused_plain(xr, dtr, A, Br, Cr, conv, **ssd_kw), None,
           (ssd_flops(L, H, P, G, N, cs),
            nbytes(xr, dtr, Br, Cr, seq, y, final, *conv.values())),
           dict(repeat=True, stage=("conv_kernel", conv_bytes)))
    del proj, xr, Br, Cr, dtr, y, final

    # K7: one decode step of a 9B Mamba layer at batch 1 and 8; xr and the
    # gate are column slices of the fused in_proj row
    K, Hd = 4, 128
    for bsz in (1, 8):
        row = randn(bsz, 2 * di + 2 * gn + Hd)
        dtf = _process_dt(randn(bsz, Hd), dtb, (0.0, float("inf")))
        dec = (row[:, di:2 * di], randn(bsz, gn), randn(bsz, gn), dtf, row[:, :di],
               randn(bsz, di, K), f32(bsz, Hd, P, N, scale=0.3), f32(di, K, scale=0.3),
               f32(di, scale=0.1), torch.log(torch.arange(1, Hd + 1, device=DEV).float()),
               D, 1 + f32(di, scale=0.1))
        dkw = dict(n_groups=G, head_dim=P, eps=1e-5)
        out = fused_mamba_decode(*dec, **dkw)
        # csrc/decode_fused.cu's fixed plan: 128 channels a block, a group a cluster
        cluster = di // G // 128
        plan = (f"{G * bsz * cluster} blocks of 128 channels in clusters of {cluster}, "
                f"{128 * min(N, 128) * 4} B of state in flight a block")
        yield ("decode_fused", lambda dec=dec: fused_mamba_decode(*dec, **dkw),
               lambda dec=dec: fused_mamba_decode_plain(*dec, **dkw), None,
               (6 * bsz * di * N, nbytes(*dec, *out)),
               dict(variant=f"B {bsz}", main=bsz == 1, peak=PEAK_F32_FLOPS, device=True,
                    repeat=True, launch=plan))
        del out

    # K8: the tower's norm over 8 frames x 729 rows x 1152, all four variants;
    # the library yardstick (the bf16 variants) is x + out, then F.layer_norm
    Dv = 1152
    xn, resn = randn(8, 729, Dv), randn(8, 729, Dv)
    wn, bn = 1 + f32(Dv, scale=0.1), f32(Dv, scale=0.1)
    inv = torch.tensor(127.0 / 4.0, device=DEV)
    wb, bb = wn.to(torch.bfloat16), bn.to(torch.bfloat16)
    for residual in (False, True):
        for quant in (False, True):
            kw = dict(residual=resn if residual else None, act_inv=inv if quant else None)
            lib = None
            if not quant and residual:
                lib = lambda: torch.nn.functional.layer_norm(resn + xn, (Dv,), wb, bb, 1e-6)  # noqa: E731
            elif not quant:
                lib = lambda: torch.nn.functional.layer_norm(xn, (Dv,), wb, bb, 1e-6)  # noqa: E731
            # x (and the residual) read, x_new (with a residual) and y written
            moved = nbytes(xn, wn, bn) + (2 * nbytes(xn) if residual else 0) + (
                xn.numel() if quant else nbytes(xn))
            yield ("layernorm", lambda kw=kw: fused_ln(xn, wn, bn, **kw),
                   lambda kw=kw: fused_ln_plain(xn, wn, bn, **kw), lib,
                   (8 * xn.numel(), moved),
                   dict(variant=("residual + " if residual else "") + ("int8" if quant else "bf16"),
                        main=residual and not quant, peak=PEAK_F32_FLOPS, device=True))

    # K9, after the others, so that their timing conditions stay as they were
    # (its plain version holds 6.4 GB of f32 logits): the prefix part of a
    # 4,096-token clip's continuation against 12,288 cached rows, as the path
    # runs it (the headline case), and again with the first 64 rows masked by
    # seg_kv, as a left pad would be; a 256-row question's against 16,384
    # rows, and the 12- and 40-token questions' of phase 5 (32 and 16 key
    # splits); the causal suffix part at 4,096. The library yardstick is SDPA
    # with the same mask (GQA in place)
    for Lq, Lk, causal, masked in ((4096, 12288, False, False), (4096, 12288, False, True),
                                   (256, 16384, False, False), (12, 16384, False, False),
                                   (40, 16384, False, False), (4096, 4096, True, False)):
        q9, k9, v9 = randn(1, Lq, Hq, hd), randn(1, Lk, Hkv, hd), randn(1, Lk, Hkv, hd)
        kw9, keep, pairs9 = dict(causal=causal), None, Lq * (Lq + 1) // 2 if causal else Lq * Lk
        main = Lk == 12288 and not masked
        pack, n_split, _ = block_attn_plan(1, Lq, Lk, Hq, Hkv, causal)
        blocks = -(-Lq * pack // BLOCK_ROWS) * (Hq // pack) * n_split
        if masked:
            seg_kv = torch.zeros(1, Lk, dtype=torch.int32, device=DEV)
            seg_kv[:, :64] = 1
            kw9.update(seg_q=torch.zeros(1, Lq, dtype=torch.int32, device=DEV), seg_kv=seg_kv)
            keep, pairs9 = (seg_kv[0] == 0)[None, None, None], Lq * (Lk - 64)
        out9 = block_attn_lse(q9, k9, v9, **kw9)
        lib_in = [x.transpose(1, 2).contiguous() for x in (q9, k9, v9)]

        def lib9(lib_in=lib_in, keep=keep, causal=causal):
            return torch.nn.functional.scaled_dot_product_attention(
                *lib_in, attn_mask=keep, is_causal=causal, enable_gqa=True)

        yield ("block_attn", lambda q9=q9, k9=k9, v9=v9, kw9=kw9: block_attn_lse(q9, k9, v9, **kw9),
               lambda q9=q9, k9=k9, v9=v9, kw9=kw9: block_attn_lse_plain(q9, k9, v9, **kw9),
               lib9, (4 * Hq * hd * pairs9,
                      nbytes(q9, k9, v9, kw9.get("seg_q"), kw9.get("seg_kv"), *out9)),
               dict(variant=f"{'causal' if causal else 'non-causal'} {Lq} x {Lk}"
                            + (", first 64 keys masked by seg_kv" if masked else ""), main=main,
                    repeat=True, launch=f"{n_split} key split(s), {blocks} blocks, "
                                        f"{pack} heads a block"))
        del q9, k9, v9, out9, lib_in

    # the qwen2 backbones' GQA groups, from a generator of their own (the
    # other cases' inputs and SHA-256 stay as they were): K2 at L 4,096 with
    # the same segments and without, at Hq / Hkv 28 / 4 (qwen2.5-7b: blocks
    # of 1 query head), 16 / 2 (qwen2.5-3b: 8) and 12 / 2 (qwen2-1.5b: 2);
    # K9 at the qwen2.5-7b decode step's 1 row and a question's 40 against
    # 8,448 cached rows (the 256-frame bucket and a 256-row suffix budget)
    gq = torch.Generator(device=DEV).manual_seed(SEED + 12)
    def rq(*shape):
        return torch.randn(*shape, generator=gq, device=DEV).to(torch.bfloat16)

    for Hq2, Hkv2 in QWEN2_GQA:
        q2, k2, v2 = rq(1, L, Hq2, hd), rq(1, L, Hkv2, hd), rq(1, L, Hkv2, hd)
        pack = gqa_pack(Hq2, Hkv2)
        plan2 = (f"{-(-L * pack // FLASH_TILE[0]) * (Hq2 // pack)} blocks of {FLASH_TILE[0]} "
                 f"(row, head) pairs ({FLASH_TILE[0] // pack} tokens x {pack} heads)")
        out2 = flash_attention(q2, k2, v2)
        for sq in (seq, None):
            yield ("flash_fwd", lambda sq=sq, q2=q2, k2=k2, v2=v2: flash_attention(
                       q2, k2, v2, segment_ids=sq),
                   lambda sq=sq, q2=q2, k2=k2, v2=v2: flash_attention_plain(
                       q2, k2, v2, segment_ids=sq),
                   sdpa(q2, k2, v2, sq)[0] if sq is not None else sdpa(q2, k2, v2, flash=True)[0],
                   (4 * Hq2 * hd * (pairs if sq is not None else L * (L + 1) // 2),
                    nbytes(q2, k2, v2, sq, out2)),
                   dict(variant=f"qwen2 Hq/Hkv {Hq2}/{Hkv2}, "
                                + ("segmented; library: SDPA with a boolean mask"
                                   if sq is not None else "unsegmented; library: SDPA flash "
                                   "backend, is_causal"), main=False, repeat=True, launch=plan2))
        del q2, k2, v2, out2
    Hq2, Hkv2 = QWEN2_GQA[0]
    for Lq in (1, 40):
        q9, k9, v9 = rq(1, Lq, Hq2, hd), rq(1, 8448, Hkv2, hd), rq(1, 8448, Hkv2, hd)
        out9 = block_attn_lse(q9, k9, v9)
        pack, n_split, _ = block_attn_plan(1, Lq, 8448, Hq2, Hkv2)
        blocks = -(-Lq * pack // BLOCK_ROWS) * (Hq2 // pack) * n_split
        lib_in = [x.transpose(1, 2).contiguous() for x in (q9, k9, v9)]

        def lib9(lib_in=lib_in):
            return torch.nn.functional.scaled_dot_product_attention(*lib_in, enable_gqa=True)

        yield ("block_attn", lambda q9=q9, k9=k9, v9=v9: block_attn_lse(q9, k9, v9),
               lambda q9=q9, k9=k9, v9=v9: block_attn_lse_plain(q9, k9, v9), lib9,
               (4 * Hq2 * hd * Lq * 8448, nbytes(q9, k9, v9, *out9)),
               dict(variant=f"qwen2 Hq/Hkv {Hq2}/{Hkv2}, non-causal {Lq} x 8448"
                            + (" (the decode step)" if Lq == 1 else ""), main=False,
                    repeat=True, launch=f"{n_split} key split(s), {blocks} blocks, {pack} "
                                        "heads a block"))
        del q9, k9, v9, out9, lib_in
    # K2-bwd at the qwen2 packs (qwen2 LoRA training), as the 9B's rows above
    do2 = None
    for Hq2, Hkv2 in QWEN2_GQA:
        q2, k2, v2 = rq(1, L, Hq2, hd), rq(1, L, Hkv2, hd), rq(1, L, Hkv2, hd)
        do2 = rq(1, L, Hq2, hd)
        pack = gqa_pack(Hq2, Hkv2)
        plan2 = (f"dkv {Hkv2 * -(-L // kb)} blocks of {kb} keys, each walking {Hq2 // Hkv2} "
                 f"heads' {qt}-query tiles; dq {-(-L * pack // rows_q) * (Hq2 // pack)} blocks "
                 f"of {rows_q} (row, head) pairs ({rows_q // pack} tokens x {pack} heads)")
        for sq in (seq, None):
            o2, l2 = flash_attention_fwd(q2, k2, v2, sq, with_lse=True)
            lib2, lib2_in = sdpa(q2, k2, v2, sq) if sq is not None else sdpa(q2, k2, v2,
                                                                             flash=True)
            leaves = [x.detach().requires_grad_() for x in lib2_in]
            lib2_out, lib2_g = lib2(*leaves), do2.transpose(1, 2).contiguous()
            yield ("flash_bwd", lambda sq=sq, q2=q2, k2=k2, v2=v2, o2=o2, l2=l2, do2=do2:
                   flash_attention_bwd(q2, k2, v2, o2, do2, l2, sq),
                   lambda sq=sq, q2=q2, k2=k2, v2=v2, do2=do2:
                   flash_attention_bwd_plain(q2, k2, v2, do2, sq),
                   lambda o=lib2_out, lv=leaves, gg=lib2_g:
                   torch.autograd.grad(o, lv, gg, retain_graph=True),
                   (10 * Hq2 * hd * (pairs if sq is not None else L * (L + 1) // 2),
                    nbytes(q2, k2, v2, o2, do2, l2, sq, q2, k2, v2)),
                   dict(variant=f"qwen2 Hq/Hkv {Hq2}/{Hkv2}, "
                                + ("segmented; library: SDPA's backward alone, masked backend"
                                   if sq is not None else "unsegmented; library: SDPA flash "
                                   "backend's backward alone, is_causal"), main=False,
                        repeat=True, launch=plan2, split=True))
            del o2, l2, lib2_in, leaves, lib2_out, lib2_g
        del q2, k2, v2
    del do2
    # K9 at the speculative verify's shapes (n_draft 7: 8 rows): the 8 queries
    # over an 8,448-row prefix, and their 8 x 8 causal own block, at the 9B's
    # 32 / 8 and qwen2.5-7b's 28 / 4
    for Hq2, Hkv2 in ((32, 8), QWEN2_GQA[0]):
        for Lk, causal in ((8448, False), (8, True)):
            q9, k9, v9 = rq(1, 8, Hq2, hd), rq(1, Lk, Hkv2, hd), rq(1, Lk, Hkv2, hd)
            out9 = block_attn_lse(q9, k9, v9, causal=causal)
            pack, n_split, _ = block_attn_plan(1, 8, Lk, Hq2, Hkv2, causal)
            blocks = -(-8 * pack // BLOCK_ROWS) * (Hq2 // pack) * n_split
            lib_in = [x.transpose(1, 2).contiguous() for x in (q9, k9, v9)]

            def lib9(lib_in=lib_in, causal=causal):
                return torch.nn.functional.scaled_dot_product_attention(
                    *lib_in, is_causal=causal, enable_gqa=True)

            yield ("block_attn",
                   lambda q9=q9, k9=k9, v9=v9, c=causal: block_attn_lse(q9, k9, v9, causal=c),
                   lambda q9=q9, k9=k9, v9=v9, c=causal: block_attn_lse_plain(q9, k9, v9,
                                                                               causal=c),
                   lib9, (4 * Hq2 * hd * (36 if causal else 8 * Lk), nbytes(q9, k9, v9, *out9)),
                   dict(variant=f"verify, Hq/Hkv {Hq2}/{Hkv2}, "
                                + ("causal 8 x 8 (the own block)" if causal
                                   else "non-causal 8 x 8448 (the prefix)"),
                        main=False, repeat=True,
                        launch=f"{n_split} key split(s), {blocks} blocks, {pack} heads a block"))
            del q9, k9, v9, out9, lib_in
    # K2-bwd's non-causal mode (TransV's cross-attention backward), from a
    # generator of its own, last, so that the other cases stay as they were:
    # 32 text rows over the 205 tokens a 64-frame stage drops and the 820 /
    # 819 of a 256-frame one, at the 9B's 32 / 8 and qwen2.5-7b's 28 / 4; B
    # 2; 1,000 x 820 (several tiles on both sides); a whole 4,096 x 4,096
    # layer. It takes K9's output and row log-sum-exp m + log(l); the library
    # yardstick is SDPA's non-causal backward alone (GQA heads repeated)
    gx = torch.Generator(device=DEV).manual_seed(SEED + 15)

    def rx(*shape):
        return torch.randn(*shape, generator=gx, device=DEV).to(torch.bfloat16)

    for Bx, Lq, Lk, (Hqx, Hkvx) in ((1, 32, 820, (32, 8)), (1, 32, 819, (32, 8)),
                                     (1, 32, 205, (32, 8)), (1, 32, 820, QWEN2_GQA[0]),
                                     (1, 32, 819, QWEN2_GQA[0]), (1, 32, 205, QWEN2_GQA[0]),
                                     (2, 32, 820, (32, 8)), (1, 1000, 820, (32, 8)),
                                     (1, 4096, 4096, (32, 8))):
        qx, kx, vx = rx(Bx, Lq, Hqx, hd), rx(Bx, Lk, Hkvx, hd), rx(Bx, Lk, Hkvx, hd)
        dox = rx(Bx, Lq, Hqx, hd)
        ox, lx, mx = block_attn_lse(qx, kx, vx)
        lsex = row_lse(lx, mx)
        packx = gqa_pack(Hqx, Hkvx)
        planx = (f"dkv {Hkvx * -(-Lk // kb) * Bx} blocks of {kb} keys, each walking {Hqx // Hkvx} "
                 f"heads' {-(-Lq // qt)} {qt}-query tiles; dq "
                 f"{-(-Lq * packx // rows_q) * (Hqx // packx) * Bx} blocks of {rows_q} (row, head) "
                 f"pairs ({rows_q // packx} tokens x {packx} heads), {-(-Lk // kt)} {kt}-key tiles")
        libx, libx_in = sdpa(qx, kx, vx, causal=False)
        leaves = [x.detach().requires_grad_() for x in libx_in]
        libx_out, libx_g = libx(*leaves), dox.transpose(1, 2).contiguous()
        yield ("flash_bwd_noncausal",
               lambda a=(qx, kx, vx, ox, dox, lsex): cross_attention_bwd(*a),
               lambda a=(qx, kx, vx, ox, dox): cross_attention_bwd_plain(*a),
               lambda o=libx_out, lv=leaves, gg=libx_g: torch.autograd.grad(o, lv, gg,
                                                                            retain_graph=True),
               (10 * Hqx * hd * Lq * Lk * Bx, nbytes(qx, kx, vx, ox, dox, lsex, qx, kx, vx)),
               dict(variant=f"B {Bx}, {Lq} x {Lk}, Hq/Hkv {Hqx}/{Hkvx}; library: SDPA's "
                            "non-causal backward alone",
                    main=(Bx, Lq, Lk, Hqx) == (1, 32, 820, 32), repeat=True, launch=planx,
                    split=True))
        del qx, kx, vx, dox, ox, lx, mx, lsex, libx_in, leaves, libx_out, libx_g

    # K3's and K6's LSE variants (a trainable tower's forward) and the ViT
    # attention backward (csrc/vit_attn_bwd.cu), from a generator of their
    # own, last: the backward at the tower-training phase's shape (64 frames
    # of SigLIP, T 729, hd 72, 16 heads, q, k, v and their gradient in the
    # fused qkv rows), 8 frames of DINOv2-L (T 734, hd 64) and 16 clips of
    # InternVideo2 (T 1,025, hd 88, v a column slice of the fused qkv), each
    # against its plain version (the same formulas in f32 from the kernel's
    # own output and LSE), SigLIP at 8 frames also against autograd through
    # the plain f32 forward; the library yardstick is SDPA's backward alone
    # at the same head dim
    gv = torch.Generator(device=DEV).manual_seed(SEED + 16)

    def rv(*shape):
        return torch.randn(*shape, generator=gv, device=DEV).to(torch.bfloat16)

    for Fv, Tv, hdv in ((8, 729, 72), (8, 734, 64)):
        qkv = rv(Fv, Tv, 3 * nh * hdv)
        lse_v = vit_attention_qkv(qkv, nh, hdv, lse=True)[1]
        yield ("vit_attn_qkv", lambda qkv=qkv, hdv=hdv: vit_attention_qkv(qkv, nh, hdv, lse=True),
               lambda qkv=qkv, hdv=hdv: vit_attention_qkv_lse_plain(qkv, nh, hdv), None,
               (4 * Fv * nh * Tv * Tv * hdv, nbytes(qkv, lse_v) + nbytes(qkv) // 3),
               dict(variant=f"LSE variant, T {Tv}, hd {hdv}", main=False, repeat=True))
        del qkv, lse_v
    cq, ck = rv(B6, T6, H6, hd6), rv(B6, T6, H6, hd6)
    cv = rv(B6, T6, 3 * H6 * hd6)[..., 2 * H6 * hd6:].view(B6, T6, H6, hd6)
    lse_v = vit_attention(cq, ck, cv, lse=True)[1]
    yield ("vit_attn", lambda: vit_attention(cq, ck, cv, lse=True),
           lambda: vit_attention_lse_plain(cq, ck, cv), None,
           (4 * B6 * H6 * T6 * T6 * hd6, nbytes(cq, ck, cq, lse_v) + cv.numel() * 2),
           dict(variant=f"LSE variant, {B6} clips, T {T6}, hd {hd6}", main=False, repeat=True))
    del cq, ck, cv, lse_v
    lib_v = _cuda.lib()
    for Fv, Tv, hdv, fused, check in ((64, 729, 72, True, "formulas"),
                                      (8, 729, 72, True, "autograd"),
                                      (8, 734, 64, True, "formulas"),
                                      (16, 1025, 88, False, "formulas")):
        qkv, gv_out = rv(Fv, Tv, 3 * nh * hdv), rv(Fv, Tv, nh * hdv)
        shape = (Fv, Tv, nh, hdv)
        if fused:
            qv, kv, vv = qkv.reshape(Fv, Tv, 3, nh, hdv).unbind(2)
            ov, lv = vit_attention_qkv(qkv, nh, hdv, lse=True)
            args = (qkv, ov, gv_out, nh, hdv, lv)
            kern = lambda args=args: (vit_attention_qkv_bwd(*args),)
            if check == "autograd":
                def plain(qkv=qkv, g_=gv_out, hdv=hdv):
                    leaf = qkv.float().requires_grad_()
                    out_p = vit_attention_qkv_plain(leaf, nh, hdv)
                    return torch.autograd.grad(out_p, [leaf], g_.float())[0].to(qkv.dtype),
            else:
                plain = lambda args=args: (vit_attention_qkv_bwd_plain(*args),)
            moved = nbytes(qkv, ov, gv_out, lv, qkv)
        else:
            qv, kv = rv(*shape), rv(*shape)
            vv = qkv[..., 2 * nh * hdv:].view(shape)
            ov, lv = vit_attention(qv, kv, vv, lse=True)
            args = (qv, kv, vv, ov, gv_out.view(shape), lv)
            kern = lambda args=args: vit_attention_bwd(*args)
            plain = lambda args=args: vit_attention_bwd_plain(*args)
            moved = nbytes(qv, kv, ov, gv_out, lv, qv, kv) + 2 * vv.numel() * vv.element_size()
        lib_call, lib_in = sdpa(qv, kv, vv, causal=False)
        leaves = [x.detach().requires_grad_() for x in lib_in]
        lib_out = lib_call(*leaves)
        lib_g = gv_out.view(shape).transpose(1, 2).contiguous()
        blocks = nh * -(-Tv // VIT_BWD_TILE[1]) * Fv
        yield ("vit_attn_bwd", kern, plain,
               lambda o=lib_out, lv_=leaves, gg=lib_g: torch.autograd.grad(o, lv_, gg,
                                                                           retain_graph=True),
               (10 * Fv * nh * Tv * Tv * hdv, moved),
               dict(variant=f"{Fv} {'frames' if fused else 'clips'}, T {Tv}, hd {hdv}, "
                            f"{'fused qkv' if fused else 'v a column slice'}; plain: "
                            f"{'autograd through the f32 forward' if check == 'autograd' else 'the formulas from the kernel output and LSE'}"
                            f"; library: SDPA's backward alone",
                    main=(Fv, Tv) == (64, 729), repeat=True, split=True,
                    launch=f"dq {blocks} blocks of {VIT_BWD_TILE[1]} query rows "
                           f"({lib_v.tv_vit_attn_bwd_smem(1, hdv)} B), dkv {blocks} blocks of "
                           f"{VIT_BWD_TILE[0]} keys ({lib_v.tv_vit_attn_bwd_smem(0, hdv)} B)"))
        del qkv, gv_out, qv, kv, vv, ov, lv, args, lib_in, leaves, lib_out, lib_g


def output_digest(out) -> str:
    """SHA-256 of a kernel's output tensor(s), bytes as they lie on the card."""
    h = hashlib.sha256()
    for x in (out if isinstance(out, tuple) else (out,)):
        if x is not None:
            h.update(x.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def phase_kernels(g: torch.Generator) -> dict:
    results, worst = {}, {}
    for name, kern, plain, library, (flops, moved), *opts in kernel_cases(g):
        opt = opts[0] if opts else {}
        got = kern()
        torch.cuda.synchronize()
        digest = output_digest(got)
        want = plain()
        err = compare(name, got, want)
        worst[name] = max(worst.get(name, 0.0), err)
        if "_bwd" in name:  # no atomics: a repeat gives the same bits
            again = kern()
            if not all(a is None or torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name}: a repeat gave other gradients")
            del again
        if opt.get("repeat"):
            again = output_digest(kern())
            if again != digest:
                raise AssertionError(f"{name}: a repeat gave other bits ({again[:16]})")
        del got, want
        if opt.get("device"):
            ms, plain_ms = device_ms(kern), device_ms(plain, iters=3)
            lib_ms = device_ms(library) if library is not None else None
        else:
            ms = timed_ms(kern)
            plain_ms = timed_ms(plain, iters=2)
            lib_ms = timed_ms(library, iters=3) if library is not None else None
        bound_ms, bound_by = bound(flops, moved, opt.get("peak", PEAK_BF16_FLOPS))
        if opt.get("main", True):
            results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                 bound_ms=bound_ms, bound_by=bound_by, launches=0)
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        label = f"{name} [{opt['variant']}]" if "variant" in opt else name
        how = "device time, cold L2" if opt.get("device") else "CUDA events"
        extra = ""
        if "launch" in opt:
            extra = (f"; {opt['launch']}; {flops / ms / 1e9:.1f} TFLOP/s, "
                     f"{bound_ms / ms:.1%} of the bound")
        if opt.get("repeat"):
            extra += "; a repeat gave the same SHA-256"
        if opt.get("split"):
            extra += f"; device ms by kernel: {kernel_split(kern)}"
        if "stage" in opt:  # one kernel of the call against its own bytes bound
            stage, stage_bytes = opt["stage"]
            stage_ms = sum(v for k, v in kernel_ms(kern).items() if stage in k)
            stage_bound = stage_bytes / PEAK_BYTES * 1e3
            extra += (f"; {stage} {stage_ms:.4f} ms device time, {stage_bound / stage_ms:.1%} "
                      f"of its bytes bound ({stage_bytes:.3e} B, {stage_bound:.4f} ms)")
        log(f"[kernels] {label}: max abs err {err:.3e}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library {lib} ({how}), bound {bound_ms:.4f} ms ({bound_by}: "
            f"{flops:.3e} FLOP, {moved:.3e} B); output SHA-256 {digest[:16]}{extra}")
        torch.cuda.empty_cache()
    for name, err in worst.items():
        results[name]["max_abs_err"] = err
    return results


def sampled_causal_attention(q, k, v, rows: slice, heads: slice) -> torch.Tensor:
    """Plain causal attention in f32 for some query rows of some heads (all of
    one KV head), probabilities rounded to bf16 before P V as the plain
    version rounds them: (1, rows, heads, D) bf16. The whole L^2 of the 80k
    shape is not computable plainly."""
    L, Hq, D = q.shape[1], q.shape[2], q.shape[3]
    rep = Hq // k.shape[2]
    kvh = heads.start // rep
    if (heads.stop - 1) // rep != kvh:
        raise ValueError("sampled heads must share one KV head")
    qs = q[0, rows, heads].float()
    s = torch.einsum("nhd,ld->hnl", qs, k[0, :, kvh].float()) / math.sqrt(D)
    pos = torch.arange(L, device=q.device)
    s = s.masked_fill(pos[None, None, :] > pos[rows][None, :, None], float("-inf"))
    p = torch.softmax(s, dim=-1).to(torch.bfloat16).float()
    return torch.einsum("hnl,ld->nhd", p, v[0, :, kvh].float())[None].to(torch.bfloat16)


def phase_microbench(results: dict) -> None:
    """3b: K2 at the 80k-prefill shape at every tile against plain attention
    on sampled query rows, then both microbenchmarks at full shapes (ViT
    attention at 256 frames with K10a, K2 at L 81,920), their JSON printed
    and K10a's launches counted."""
    L, Hq, Hkv, D = 81920, 32, 8, 128
    g = torch.Generator(device=DEV).manual_seed(SEED + 6)
    q, k, v = ((torch.randn(1, L, h, D, generator=g, device=DEV) * 0.3).to(torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
    samples = ((slice(L - 256, L), slice(0, 4)), (slice(0, 256), slice(28, 32)))
    refs = [sampled_causal_attention(q, k, v, rows, heads) for rows, heads in samples]
    for tile in FLASH_TILES:
        out = flash_attention_fwd(q, k, v, None, False, tile)[0]
        torch.cuda.synchronize()
        errs = [compare("flash_fwd", out[:, rows, heads].contiguous(), want)
                for (rows, heads), want in zip(samples, refs)]
        log(f"[microbench] flash_fwd tile {tile[0]} x {tile[1]} at L {L}: max abs err "
            f"{max(errs):.3e} on the last 256 rows of heads 0-3 and the first 256 of heads "
            f"28-31 against plain f32 attention; output SHA-256 {output_digest(out)[:16]}")
        del out
    del q, k, v, refs
    torch.cuda.empty_cache()

    headgrid_attention.launches = 0
    vit = microbench_vit_attn.run(DEV, frames=256)
    results["headgrid_attn"]["launches"] = headgrid_attention.launches
    log("[microbench] microbench_vit_attn " + json.dumps(vit))
    if headgrid_attention.launches != 4 * (microbench_vit_attn.STEPS + 1):
        raise AssertionError(f"K10a launched {headgrid_attention.launches} times in the ViT "
                             "microbenchmark")
    torch.cuda.empty_cache()
    before = flash_attention.launches
    flash = microbench_flash.run(DEV, seq=L)
    log("[microbench] microbench_flash " + json.dumps(flash))
    if flash_attention.launches - before != len(FLASH_TILES) * (int(os.environ.get(
            "MB_STEPS", 3)) + 1):
        raise AssertionError("K2 launches in the flash microbenchmark")
    log(f"[microbench] K10a at 256 frames: hpp 1 / 2 / 4 "
        + " / ".join(f"{vit[f'hd128_grid_hpp{h}_ms']:.4f}" for h in (1, 2, 4))
        + f" ms, hpp 2 without the exp {vit['hd128_grid_hpp2_noexp_ms']:.4f} ms; bound "
        f"{vit['bound_hd128_ms']:.4f} ms; SDPA at hd 128 {vit['sdpa_hd128_ms']:.4f} ms; K3 "
        f"(hd 72) {vit['current_qkv_ms']:.4f} ms, bound {vit['bound_hd72_ms']:.4f}, SDPA "
        f"{vit['sdpa_hd72_ms']:.4f} ms")
    log(f"[microbench] K2 at L {L}: "
        + ", ".join(f"tile {bq} x {bk} {flash[f'blk_q{bq}_k{bk}_ms']:.2f} ms "
                    f"({flash[f'blk_q{bq}_k{bk}_tfs']:.1f} TFLOP/s)" for bq, bk in FLASH_TILES)
        + f"; bound {flash['bound_ms']:.2f} ms; SDPA {flash['sdpa_ms']:.2f} ms "
        f"({flash['sdpa_tfs']:.1f} TFLOP/s)")
    torch.cuda.empty_cache()


def clone_arg(v):
    """A copy of a kernel's argument with the same strides (K6's v and K1's x
    are strided slices)."""
    if not isinstance(v, torch.Tensor):
        return v
    if v.is_contiguous() or 0 in v.stride():
        return v.detach().clone()
    return torch.empty_strided(v.shape, v.stride(), dtype=v.dtype,
                               device=v.device).copy_(v.detach())


class Capture:
    """Records the first call's inputs of a wrapper while `armed`."""

    def __init__(self, fn):
        self.fn, self.armed, self.args, self.kwargs = fn, False, None, None

    def __call__(self, *args, **kwargs):
        if self.armed and self.args is None:
            self.args = tuple(clone_arg(a) for a in args)
            self.kwargs = {k: clone_arg(v) for k, v in kwargs.items()}
        return self.fn(*args, **kwargs)


def route(calls: dict) -> None:
    """Point the model's calls of each forward kernel at calls[name]."""
    for name, (mod, attr) in ROUTES.items():
        setattr(mod, attr, calls[name])


def use_kernels() -> None:
    route(CALLS)


def use_plain_versions() -> None:
    route(PLAIN)


def capture_all() -> dict:
    caps = {name: Capture(fn) for name, fn in CALLS.items()}
    route(caps)
    return caps


def reset_launches() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def make_requests(arch):
    """The three requests, the same prompts and pixels in every phase: text
    only, 64 frames, 256 frames; 40 text tokens each."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 1)
    size = arch.vision.image_size

    def request(n_frames: int):
        text = torch.randint(10, 130000, (40,), generator=g, device=DEV).tolist()
        ids = text[:8] + [IMAGE_TOKEN] * n_frames + text[8:]
        pixels = (torch.rand(n_frames, size, size, 3, generator=g, device=DEV) * 2 - 1
                  if n_frames else None)
        return ids, pixels

    return [("text", request(0)), ("64 frames", request(64)), ("256 frames", request(256))]


def serve(gen, requests, tag: str, captures=None) -> dict:
    """Each request through Generator.generate; captures armed for the
    64-frame one. Returns {label: GenerationOutput}."""
    outs = {}
    for label, (ids, pixels) in requests:
        for c in (captures or {}).values():
            c.armed = label == "64 frames"
        out = gen.generate(ids, pixels=pixels, image_token_id=IMAGE_TOKEN)
        outs[label] = out
        if not torch.isfinite(out.first_logits).all():
            raise AssertionError(f"{tag} {label}: non-finite first-token logits")
        decode_tps = (out.num_generated - 1) / out.decode_s
        log(f"[{tag}] {label}: bucket {gen._plan_prompt(ids, IMAGE_TOKEN)[1]}, "
            f"encode {out.encode_s:.3f} s, prefill {out.prefill_s:.3f} s, "
            f"decode {decode_tps:.2f} tok/s, {out.num_generated} tokens "
            f"{out.token_ids.tolist()}")
    return outs


def cosine(a, b) -> float:
    return torch.nn.functional.cosine_similarity(a.float().flatten(), b.float().flatten(),
                                                 dim=0).item()


def logits_agree(tag: str, got, want, min_cos: float = 0.99) -> None:
    """bf16 activations through 52 layers: two paths that round at other
    places agree to a cosine of 0.99. With int8 activations a difference
    that moves a value across a rounding boundary moves its int8 code by one
    step of 1/127 of the layer's calibrated range, and the model's random
    weights carry such steps on: the int8 comparisons allow 0.98."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    cos = cosine(got, want)
    log(f"[{tag}] first-token logits max abs diff {err:.3e} (max |logit| "
        f"{want.abs().max().item():.3e}), cosine {cos:.6f}")
    if not (math.isfinite(err) and cos > min_cos):
        raise AssertionError(f"{tag}: first-token logits disagree")


def phase_serving(model, arch, kernel_results: dict, profile: bool = False) -> dict:
    """Returns the bf16 model's first-token logits of the requests and
    `tower` of 16 of the 64 frames, the int8 phase's references. `profile`:
    also profile the 256-frame request's encode."""
    for var in FUSIONS:  # the fused kernels off, as by default
        os.environ[var] = "0"
    gen = Generator(model, arch, terminator_ids=[], max_new_tokens=MAX_NEW)
    requests = make_requests(arch)
    captures = capture_all()
    reset_launches()
    outs = serve(gen, requests, "serve", captures)
    repeat = gen.generate(requests[1][1][0], pixels=requests[1][1][1],
                          image_token_id=IMAGE_TOKEN)
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    use_kernels()
    log(f"[serve] launches during the requests: {launches}")
    if repeat.token_ids.tolist() != outs["64 frames"].token_ids.tolist():
        raise AssertionError("a repeat of the 64-frame request gave other ids")
    for name in SERVING:
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched on the serving path")
        kernel_results[name]["launches"] = launches[name]

    compare_captured(captures, SERVING, "serve", kernel_results)
    del captures
    torch.cuda.empty_cache()
    check_against_plain_run(gen, requests, outs, "serve")
    if profile:
        with torch.no_grad():
            profile_call("bf16 encode of the 256-frame request",
                         lambda: encode_visual(model, arch, requests[2][1][1]))
    return {"logits": {label: o.first_logits for label, o in outs.items()},
            "tower": tower(model, arch, requests[1][1][1][:16])}


@torch.no_grad()
def compare_captured(captures: dict, names, tag: str, kernel_results: dict) -> None:
    """Each kernel against its plain version on the inputs the armed request
    gave its first call."""
    for name in names:
        c = captures[name]
        err = compare(name, CALLS[name](*c.args, **c.kwargs), PLAIN[name](*c.args, **c.kwargs))
        shapes = [tuple(a.shape) for a in c.args if isinstance(a, torch.Tensor)]
        log(f"[{tag}] {name} on the request's own inputs {shapes}: max abs err {err:.3e}")
        kernel_results[name]["max_abs_err"] = max(kernel_results[name]["max_abs_err"], err)


def check_against_plain_run(gen, requests, outs: dict, tag: str, min_cos: float = 0.99) -> None:
    """The 64-frame request again with every kernel's plain version in its
    place, as a reference for the first logits."""
    use_plain_versions()
    try:
        ref = gen.generate(requests[1][1][0], pixels=requests[1][1][1],
                           image_token_id=IMAGE_TOKEN)
    finally:
        use_kernels()
    log(f"[{tag}] 64 frames, kernels vs plain versions: ids kernels "
        f"{outs['64 frames'].token_ids.tolist()} plain {ref.token_ids.tolist()}")
    logits_agree(f"{tag}", outs["64 frames"].first_logits, ref.first_logits, min_cos)


def cache_digest(cache) -> str:
    """SHA-256 of every K/V buffer and Mamba state of a decode cache, and its
    length and valid_from."""
    h = hashlib.sha256(f"{cache['length']} {cache['valid_from']}".encode())
    for lc in cache["layers"]:
        for key in sorted(lc):
            parts = lc[key] if isinstance(lc[key], dict) else {"": lc[key]}
            for name in sorted(parts):
                h.update(parts[name].contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def phase_long_video(model, arch, kernel_results: dict) -> None:
    """(a) 1,024 frames streamed in four clips of 4,096 tokens against one
    prefill of all 16,384 and the chunked long-context forward; (b) three
    questions on a cached 1,016-frame prefix; (c) K9 and K1 (from a carried
    state) on inputs the stream gave them."""
    llm, cfg = model.llm_backbone, arch.llm
    gen = Generator(model, arch, terminator_ids=[], max_new_tokens=MAX_NEW)
    g = torch.Generator(device=DEV).manual_seed(SEED + 5)
    size = arch.vision.image_size
    frames = torch.rand(1024, size, size, 3, generator=g, device=DEV) * 2 - 1
    clip, n_clips = 256 * arch.tokens_per_frame, 4
    per_cont = 2 * cfg.layers_block_type.count("attention")  # 8 on the 9B
    cap9, cap1 = Capture(block_attn_lse), Capture(pc_mod.ssd_scan)
    pc_mod.block_attn_lse, pc_mod.ssd_scan = cap9, cap1
    reset_launches()
    try:
        t0 = time.perf_counter()
        embeds = gen.encode_frames(frames)[None]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.inference_mode():
            out = nano_forward(llm, cfg, inputs_embeds=embeds[:, :clip], fill_cache=True,
                               cache_max_len=n_clips * clip + 256 + MAX_NEW, logits_to_keep=1)
            logits, cache = out["logits"][:, -1], out["cache"]
            del out
            torch.cuda.synchronize()
            clip_s = [time.perf_counter() - t1]
            for i in range(1, n_clips):
                cap1.armed, cap9.armed = i == 1, i == n_clips - 1
                before = block_attn_lse.launches
                t = time.perf_counter()
                logits, cache = nano_forward_continue(llm, cfg, embeds[:, i * clip:(i + 1) * clip],
                                                      cache)
                torch.cuda.synchronize()
                clip_s.append(time.perf_counter() - t)
                if block_attn_lse.launches - before != per_cont:
                    raise AssertionError(f"clip {i + 1}: K9 launched "
                                         f"{block_attn_lse.launches - before} times, not "
                                         f"{per_cont}")
            cap1.armed = cap9.armed = False
            stream_launches = block_attn_lse.launches
            t = time.perf_counter()
            one = nano_forward(llm, cfg, inputs_embeds=embeds, fill_cache=True,
                               cache_max_len=n_clips * clip, logits_to_keep=1)
            torch.cuda.synchronize()
            one_s, t = time.perf_counter() - t, time.perf_counter()
            longctx = nano_forward_longctx(llm, cfg, embeds, chunk_tokens=clip)["logits"][:, -1]
            torch.cuda.synchronize()
            long_s = time.perf_counter() - t
        want = one["logits"][:, -1]
        last_mamba = max(i for i, bt in enumerate(cfg.layers_block_type) if bt == "mamba")
        s_stream = cache["layers"][last_mamba]["ssm_state"]
        s_one = one["cache"]["layers"][last_mamba]["ssm_state"]
        log(f"[long video] 1,024 frames, 4 clips of {clip} tokens: encode {t1 - t0:.3f} s; "
            f"clip prefill / continuations {', '.join(f'{x:.3f}' for x in clip_s)} s "
            f"(stream {sum(clip_s):.3f} s); one-shot prefill of {n_clips * clip} tokens "
            f"{one_s:.3f} s; longctx (chunks of {clip}) {long_s:.3f} s; K9 launches "
            f"{stream_launches} ({per_cont} a continuation)")
        log(f"[long video] layer {last_mamba} ssm_state, streamed vs one-shot: relative error "
            f"{((s_stream - s_one).norm() / s_one.norm()).item():.3e}")
        for tag, got in (("streamed continuation", logits), ("longctx", longctx)):
            logits_agree(f"long video, {tag} vs one-shot", got, want, 0.999)
        del cache, one, longctx, embeds, logits, want, s_stream, s_one
        torch.cuda.empty_cache()

        # (b) questions on a cached prefix of 8 text tokens + 1,016 frames
        text = torch.randint(10, 130000, (8 + 12 + 40 + 300,), generator=g,
                             device=DEV).tolist()
        prefix_ids = text[:8] + [IMAGE_TOKEN] * 1016
        questions = [text[8:20], text[20:60], text[60:]]
        t = time.perf_counter()
        state = gen.prefill_prefix(prefix_ids, pixels=frames[:1016], image_token_id=IMAGE_TOKEN,
                                   suffix_budget=512)
        torch.cuda.synchronize()
        log(f"[long video] prefill_prefix: bucket {state.bucket}, pad {state.pad}, cache "
            f"{state.cache_len} rows, {time.perf_counter() - t:.3f} s with the encode")
        if state.bucket != pick_bucket(8 + 1016 * arch.tokens_per_frame):
            raise AssertionError(f"prefix bucket {state.bucket}")
        digest = cache_digest(state.cache)
        answers = {}
        for q in questions:
            before = block_attn_lse.launches
            o = gen.generate(q, prefix=state)
            if block_attn_lse.launches - before != per_cont:
                raise AssertionError(f"a {len(q)}-token question launched K9 "
                                     f"{block_attn_lse.launches - before} times, not "
                                     f"{per_cont}")
            if not torch.isfinite(o.first_logits).all():
                raise AssertionError(f"{len(q)}-token question: non-finite logits")
            answers[len(q)] = o
            log(f"[long video] question of {len(q)} tokens on the prefix: continuation "
                f"{o.prefill_s:.3f} s, decode {(o.num_generated - 1) / o.decode_s:.2f} tok/s, "
                f"{o.token_ids.tolist()}")
        after = cache_digest(state.cache)
        log(f"[long video] prefix cache SHA-256 before {digest[:16]}, after three questions "
            f"{after[:16]}")
        if after != digest:
            raise AssertionError("the questions changed the prefix's cache")
        whole = gen.generate(prefix_ids + questions[1], pixels=frames[:1016],
                             image_token_id=IMAGE_TOKEN)
        q40 = answers[40]
        log(f"[long video] 40-token question, ids on the prefix {q40.token_ids.tolist()}, "
            f"whole prompt {whole.token_ids.tolist()}; seconds to first token: on the prefix "
            f"{q40.prefill_s:.3f} s, whole prompt {whole.encode_s + whole.prefill_s:.3f} s "
            f"(encode {whole.encode_s:.3f} + prefill {whole.prefill_s:.3f})")
        logits_agree("long video, 40-token question on the prefix vs the whole prompt",
                     q40.first_logits, whole.first_logits, 0.999)
        kernel_results["block_attn"]["launches"] = block_attn_lse.launches
        log(f"[long video] K9 launches in the phase: {block_attn_lse.launches}")
        del state, answers, whole, q40, frames
        torch.cuda.empty_cache()
    finally:
        pc_mod.block_attn_lse, pc_mod.ssd_scan = block_attn_lse, cap1.fn

    # (c) the kernels on the stream's own inputs
    with torch.no_grad():
        err = compare("block_attn", block_attn_lse(*cap9.args, **cap9.kwargs),
                      block_attn_lse_plain(*cap9.args, **cap9.kwargs))
        shapes = [tuple(a.shape) for a in cap9.args]
        log(f"[long video] block_attn on clip 4's first attention layer {shapes}: max abs err "
            f"{err:.3e}; kernel {timed_ms(lambda: block_attn_lse(*cap9.args, **cap9.kwargs)):.4f}"
            f" ms")
        kernel_results["block_attn"]["max_abs_err"] = max(
            kernel_results["block_attn"]["max_abs_err"], err)
        del cap9
        torch.cuda.empty_cache()
        h0 = cap1.kwargs["initial_state"]
        err = compare("ssd_fwd", ssd_scan(*cap1.args, **cap1.kwargs),
                      ssd_chunked(*cap1.args, **cap1.kwargs))
        ms = timed_ms(lambda: ssd_scan(*cap1.args, **cap1.kwargs))
        log(f"[long video] ssd_fwd on clip 2's first Mamba layer "
            f"{[tuple(a.shape) for a in cap1.args]} from a carried state (|h0| max "
            f"{h0.abs().max().item():.3e}): max abs err {err:.3e}; kernel {ms:.4f} ms, plain "
            f"{timed_ms(lambda: ssd_chunked(*cap1.args, **cap1.kwargs), iters=2):.4f} ms; "
            f"device ms by kernel: {kernel_split(lambda: ssd_scan(*cap1.args, **cap1.kwargs))}")
        kernel_results["ssd_fwd"]["max_abs_err"] = max(kernel_results["ssd_fwd"]["max_abs_err"],
                                                       err)
    torch.cuda.empty_cache()


def engine_requests(arch, g: torch.Generator):
    """The engine's request mix, in queue order: (label, Request kwargs, the
    prompt's frames). Text prompts of 20-900 tokens; the first eight fill
    the 8 slots in round one with a bucket of four (128) and one of two
    (512); two of 64 frames (K3); a 6,000-token prompt that runs in chunks;
    two questions of 40 and 300 tokens for the cached prefix."""
    size = arch.vision.image_size

    def text(n):
        return torch.randint(10, 130000, (n,), generator=g, device=DEV).tolist()

    def frames(n):
        return torch.rand(n, size, size, 3, generator=g, device=DEV) * 2 - 1

    def vision(new):
        return ("64 frames", dict(input_ids=text(8) + [IMAGE_TOKEN] * 64 + text(32),
                                  pixels=frames(64), image_token_id=IMAGE_TOKEN,
                                  max_new_tokens=new))

    mix = [(f"text {n}", dict(input_ids=text(n), max_new_tokens=new))
           for n, new in ((20, 8), (40, 16), (60, 24), (100, 32), (300, 12), (400, 40),
                          (700, 20))]
    mix.append(vision(16))
    mix.append(("text 6000, chunked", dict(input_ids=text(6000), max_new_tokens=24)))
    mix += [(f"question {n}", dict(input_ids=text(n), max_new_tokens=new))
            for n, new in ((40, 16), (300, 8))]
    mix.append(vision(48))
    mix += [(f"text {n}", dict(input_ids=text(n), max_new_tokens=new))
            for n, new in ((200, 48), (900, 10), (150, 28))]
    return mix


@torch.inference_mode()
def forced_logits(llm, arch, gen, ids, visual, n: int) -> torch.Tensor:
    """The f32 logits (n, V) of the last n rows of one nano_forward (or
    qwen2_forward) of `llm` over the bucketed, fused row of `ids` and the
    frames' visual tokens (the rows that predict a request's n outputs),
    fused as vlm_forward fuses it."""
    plan, bucket, pad, ids_arr, gather_idx, seq_idx = gen._plan_prompt(ids, IMAGE_TOKEN)
    visual = gen._check_visual(plan, visual)
    text = llm.embeddings(torch.as_tensor(ids_arr, dtype=torch.long, device=DEV))
    src = torch.cat([text, visual.to(text.dtype)])
    fused = src[torch.as_tensor(gather_idx, dtype=torch.long, device=DEV)][None]
    seq = torch.as_tensor(seq_idx, dtype=torch.int32, device=DEV)[None]
    return llm_forward(llm, arch, inputs_embeds=fused, seq_idx=seq,
                       logits_to_keep=n)["logits"][0]


def phase_engine(model, arch, smi: str, kernel_results: dict) -> None:
    """5b: the serving engine on the bf16 9B: 8 slots, 16,384 rows each, 4
    decode steps a sync, chunks of 2,048 tokens, greedy; 15 requests (see
    engine_requests) and a prefix of 8 text tokens + 256 frames. Every
    request served without error; each request's first-token logits against
    Generator.generate on the same request (cosine >= 0.999); >= 95% of the
    engine's tokens the argmax of one nano_forward over prompt + output of an
    f32 copy of the backbone (random weights give near-ties: each miss is
    printed with its top-2 margin, and no miss may lie more than
    MISS_GAP_LIMIT below the row's argmax, so that a fault in one slot cannot
    hide in the pooled share; the bf16 model's own forward, and the
    Generator's greedy tokens, are counted beside it); K1, K2, K3 and K9
    launched. Then the same requests with chunked prefill off,
    for the round gaps."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 7)
    mix = engine_requests(arch, g)
    size = arch.vision.image_size
    prefix_ids = torch.randint(10, 130000, (8,), generator=g, device=DEV).tolist() + [
        IMAGE_TOKEN] * 256
    prefix_px = torch.rand(256, size, size, 3, generator=g, device=DEV) * 2 - 1
    kw = dict(terminator_ids=[], num_slots=8, max_len=16384, steps_per_sync=4)
    runs = {}
    for chunked in (2048, None):
        eng = ServingEngine(model, arch, prefill_chunk_tokens=chunked, **kw)
        if chunked:
            t0 = time.perf_counter()
            state = eng.prefill_prefix(prefix_ids, pixels=prefix_px,
                                       image_token_id=IMAGE_TOKEN, suffix_budget=512)
            torch.cuda.synchronize()
            log(f"[engine] prefill_prefix of 8 tokens + 256 frames: bucket {state.bucket}, "
                f"{time.perf_counter() - t0:.3f} s with the encode")
        reqs = [Request(request_id=i, prefix=state if label.startswith("question") else None,
                        **rkw) for i, (label, rkw) in enumerate(mix)]
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: w.launches for name, w in WRAPPERS.items()}
        gaps = [b - a for a, b in zip(eng.round_stamps, eng.round_stamps[1:])]
        n_tok = sum(len(r.output_ids) for r in out)
        tag = "chunked prefill on" if chunked else "chunked prefill off"
        log(f"[engine] {tag}: {len(out)} requests, {n_tok} output tokens in {wall:.3f} s, "
            f"{n_tok / wall:.2f} output tokens/s, {len(gaps)} rounds, largest gap between "
            f"rounds {max(gaps):.3f} s (round {gaps.index(max(gaps)) + 1}; median "
            f"{sorted(gaps)[len(gaps) // 2]:.3f} s; all {', '.join(f'{x:.3f}' for x in gaps)}); "
            f"{smi}")
        log(f"[engine] {tag}: launches {launches}")
        bad = [(r.request_id, r.error) for r in out if r.error or not r.done]
        if bad:
            raise AssertionError(f"engine requests failed: {bad}")
        for name in ("ssd_fwd", "flash_fwd", "vit_attn_qkv", "block_attn"):
            if launches[name] == 0:
                raise AssertionError(f"{name} was never launched by the engine ({tag})")
        runs[chunked] = out
        del eng
        torch.cuda.empty_cache()

    out = runs[2048]
    ref_gen = Generator(model, arch, terminator_ids=[], max_new_tokens=1)
    # the teacher-forcing references: the bf16 model (kernels) and an f32
    # copy of its backbone (the same weights, plain versions: the kernels
    # take bf16), which leaves only the served side's bf16 rounding
    llm32 = NanoModel(arch.llm, torch.float32, DEV)
    llm32.load_state_dict(model.llm_backbone.state_dict())
    refs = {"bf16": lambda f, ve, n: forced_logits(model.llm_backbone, arch, ref_gen, f, ve, n)}

    def f32_rows(f, ve, n):
        use_plain_versions()
        try:
            return forced_logits(llm32, arch, ref_gen, f, ve, n)
        finally:
            use_kernels()

    refs["f32"] = f32_rows

    def forced_hits(ref, full, visual, tokens):
        """(hits, misses described, the largest miss's gap to the argmax) of
        teacher forcing over `tokens`."""
        rows = refs[ref](full + tokens[:-1], visual, len(tokens))
        misses, worst = [], 0.0
        for t, (tok, row) in enumerate(zip(tokens, rows)):
            top = torch.topk(row, 2).values
            if int(row.argmax()) != tok:
                gap = (top[0] - row[tok]).item()
                worst = max(worst, gap)
                misses.append(f"token {t}: {tok} (gap {gap:.3e}), "
                              f"argmax {int(row.argmax())} (top-2 margin "
                              f"{(top[0] - top[1]).item():.3e})")
        return len(tokens) - len(misses), misses, worst

    hits = {(who, ref): 0 for who in ("engine", "generator") for ref in refs}
    total = agree = 0
    worst_gap = (0.0, "")
    for (label, rkw), r in zip(mix, out):
        ids, px = rkw["input_ids"], rkw.get("pixels")
        # the Generator on the same request: its first logits, and its own
        # greedy tokens as a baseline for teacher forcing
        base_gen = Generator(model, arch, terminator_ids=[], max_new_tokens=len(r.output_ids))
        if label.startswith("question"):
            ref = base_gen.generate(ids, prefix=state)
            full, full_px = prefix_ids + ids, prefix_px
        else:
            ref = base_gen.generate(ids, pixels=px, image_token_id=IMAGE_TOKEN)
            full, full_px = ids, px
        cos = cosine(r.first_logits, ref.first_logits)
        if not cos >= 0.999:
            raise AssertionError(f"engine {label}: first-token logits cosine {cos:.6f} against "
                                 "Generator.generate")
        misses = {}
        with torch.inference_mode():  # the frames' tokens, through the tower's kernels
            visual = ref_gen.encode_frames(full_px) if full_px is not None else None
        for who, tokens in (("engine", r.output_ids), ("generator", ref.token_ids.tolist())):
            for name in refs:
                n_hit, misses[who, name], gap = forced_hits(name, full, visual, tokens)
                hits[who, name] += n_hit
                if (who, name) == ("engine", "f32") and gap > worst_gap[0]:
                    worst_gap = (gap, label)
        same = next((i for i, (a, b) in enumerate(zip(r.output_ids, ref.token_ids.tolist()))
                     if a != b), len(r.output_ids))
        total, agree = total + len(r.output_ids), agree + same
        log(f"[engine] {label}: {len(r.output_ids)} tokens, first logits cosine {cos:.6f} "
            f"against Generator.generate, whose tokens agree for the first {same}; teacher "
            f"forcing misses, bf16 / f32 reference: engine {len(misses['engine', 'bf16'])} / "
            f"{len(misses['engine', 'f32'])}, the Generator's own tokens "
            f"{len(misses['generator', 'bf16'])} / {len(misses['generator', 'f32'])}"
            + "".join(f"; f32 {m}" for m in misses["engine", "f32"]))
    del llm32
    off = runs[None]
    same = sum(a.output_ids == b.output_ids for a, b in zip(out, off))
    log(f"[engine] teacher forcing over {total} tokens: "
        + ", ".join(f"{who}'s tokens {hits[who, ref]} ({100 * hits[who, ref] / total:.1f}%) "
                    f"against the {ref} reference" for who, ref in hits)
        + f"; the engine's tokens agree with the Generator's up to the first difference for "
        f"{agree} of {total}; chunked prefill on and off give the same tokens for {same} of "
        f"{len(out)} requests; the engine's largest miss under the f32 reference lies "
        f"{worst_gap[0]:.3e} below the argmax ({worst_gap[1] or 'no miss'}; limit "
        f"{MISS_GAP_LIMIT})")
    if hits["engine", "f32"] < 0.95 * total:
        raise AssertionError("the engine's tokens disagree with teacher forcing")
    if worst_gap[0] > MISS_GAP_LIMIT:
        raise AssertionError(f"engine {worst_gap[1]}: a token {worst_gap[0]:.3e} below the "
                             f"argmax of teacher forcing (limit {MISS_GAP_LIMIT})")
    del runs, out, off, state
    torch.cuda.empty_cache()


def pdrop_arch(arch):
    """The same model with the JAX package's pdrop setting (PDROP)."""
    return dataclasses.replace(arch, llm=dataclasses.replace(arch.llm, **PDROP))


def attach_merge_modules(model, arch_p) -> None:
    """Give the model TransV modules for arch_p's stages in its dtype, from a
    generator of their own (the other weights stay as the seed made them),
    alpha set so that tanh(alpha) = 0.5."""
    mods = init_merge_modules(arch_p.llm, model.llm_backbone.embeddings.weight.dtype, DEV)
    mods.reset_parameters(torch.Generator(device=DEV).manual_seed(SEED + 8))
    with torch.no_grad():
        for mm in mods.values():
            mm.alpha.fill_(PDROP_ALPHA)
    model.merge_modules = mods


@torch.no_grad()
def temper_transv(model, gen, ids, px) -> list:
    """Rescale each stage's TransV q_proj so that its cross-attention logits
    have standard deviation 1 on this request's pdrop prefill, stage by
    stage (each rescale changes what the next stage sees). The 9B's raw
    hidden state has an RMS of tens by layer 14, so N(0, 0.02) q and k
    projections give logits of thousands: a one-hot softmax whose winner a
    bf16 rounding upstream can flip, and with it the suffix rows. Returns
    the factors."""
    factors = []
    for si in range(len(model.merge_modules)):
        seen = []

        def record(q, k, v, *args):
            seen.append((q, k))
            return cross(q, k, v, *args)

        cross, pdrop_mod.cross_attention = pdrop_mod.cross_attention, record
        try:
            pdrop_prefill(gen, ids, px)
        finally:
            pdrop_mod.cross_attention = cross
        q, k = seen[si]
        B, Lq, Hq, hd = q.shape
        Hkv = k.shape[2]
        logits = torch.einsum("bqgrd,bkgd->bgrqk", q.reshape(B, Lq, Hkv, Hq // Hkv, hd).float(),
                              k.float()) / math.sqrt(hd)
        factor = 1.0 / logits.std().item()
        model.merge_modules.stage(si).cross_attn.q_proj.weight.mul_(factor)
        factors.append(factor)
    return factors


class StageLog:
    """Records, while installed, each pdrop stage's row count before and
    after it and the keep indices each "attn" stage ranks; with `replay`
    (the keep indices of another run, in stage order) those stages keep
    these instead of their own."""

    def __init__(self, replay=None):
        self.lengths, self.keeps, self.replay = [], [], list(replay or ())
        self._stage, self._keep = pdrop_mod.apply_pdrop_stage, pdrop_mod._keep_indices

    def __enter__(self):
        def stage(hidden, *args, **kw):
            out = self._stage(hidden, *args, **kw)
            self.lengths.append((hidden.shape[1], out[0].shape[1]))
            return out

        def keep(st, *args, **kw):
            idx = self._keep(st, *args, **kw)
            if st.compress_type == "attn":
                self.keeps.append(idx.cpu())
                if self.replay:
                    idx = self.replay.pop(0).to(idx.device)
            return idx

        nano_mod.apply_pdrop_stage = longctx_mod.apply_pdrop_stage = stage
        qwen2_mod.apply_pdrop_stage = stage
        pdrop_mod._keep_indices = keep
        return self

    def __exit__(self, *exc):
        nano_mod.apply_pdrop_stage = longctx_mod.apply_pdrop_stage = self._stage
        qwen2_mod.apply_pdrop_stage = self._stage
        pdrop_mod._keep_indices = self._keep


def plan_visual(gen, ids) -> int:
    return gen._plan_prompt(ids, IMAGE_TOKEN)[0].num_visual


def kv_lens(cache, cfg) -> dict:
    return {i: cache["layers"][i]["kv_len"] for i in cfg.attention_layer_indices}


@torch.inference_mode()
def pdrop_prefill(gen, ids, pixels, replay=None, visual=None):
    """The Generator's bucketed pdrop prefill of one request: (first logits,
    cache, bucket, StageLog); `replay` as StageLog takes it; `visual` the
    encoded frames, if given."""
    if visual is None:
        visual = gen.encode_frames(pixels)
    plan, bucket, pad, ids_arr, gather_idx, seq_idx = gen._plan_prompt(ids, IMAGE_TOKEN)
    with StageLog(replay) as stages:
        logits, cache = gen.prefill(ids_arr, gather_idx, seq_idx, visual, pad,
                                    bucket + MAX_NEW, gen._pdrop_start(plan, pad, True))
    return logits, cache, bucket, stages


@torch.inference_mode()
def forced_logits_pdrop(llm, merge, arch_p, gen, ids, visual, tokens) -> torch.Tensor:
    """The f32 logits (n, V) of one pdrop nano_forward over the request's
    bucketed, fused prompt row (its left pad kept) followed by its outputs
    but the last: the rows that predict the n outputs, with the prompt's last
    row as the ranking query, as the Generator's prefill and decode take it."""
    plan, bucket, pad, ids_arr, gather_idx, seq_idx = gen._plan_prompt(ids, IMAGE_TOKEN)
    text = llm.embeddings(torch.as_tensor(ids_arr, dtype=torch.long, device=DEV))
    src = torch.cat([text, visual.to(text.dtype)])
    fused = src[torch.as_tensor(gather_idx, dtype=torch.long, device=DEV)]
    out = llm.embeddings(torch.as_tensor(tokens[:-1], dtype=torch.long, device=DEV))
    row = torch.cat([fused, out])[None]
    seq = torch.cat([torch.as_tensor(seq_idx, dtype=torch.int32, device=DEV),
                     torch.zeros(len(tokens) - 1, dtype=torch.int32, device=DEV)])[None]
    vs, nv, _ = plan.sample_layouts[0]
    spec = make_pdrop_spec([(pad + vs, nv, row.shape[1] - pad - vs - nv)],
                           arch_p.llm.pdrop_stages, [bucket - 1])
    return nano_forward(llm, arch_p.llm, inputs_embeds=row, seq_idx=seq, pdrop_spec=spec,
                        pdrop_params=merge, logits_to_keep=len(tokens))["logits"][0]


def transv_witness(model, arch_p, gen, ids, px, tag: str, min_cos=None) -> dict:
    """How far rounding alone moves the pdrop first logits of one request at
    the merge modules' present weights. One keep set for every run (the
    kernel run's), so that only the arithmetic differs: the kernels in bf16,
    the plain versions in bf16, the plain versions in bf16 with every visual
    feature moved up by one ulp, and the plain versions on an f32 copy of the
    backbone and merge modules (the same bf16 visual features). Returns the
    cosines of the pairs; where the bf16 runs part from the f32 run as far as
    from each other, the gap is the conditioning of the weights, not a fault
    of a kernel. With `min_cos`, the kernel run must reach it against the f32
    run."""
    with torch.inference_mode():
        visual = gen.encode_frames(px)
        if visual.dtype != torch.bfloat16:
            raise AssertionError(f"visual features in {visual.dtype}, not bf16")
        nudged = (visual.view(torch.int16) + 1).view(torch.bfloat16)  # one ulp up in magnitude
    kern, _, _, stages = pdrop_prefill(gen, ids, px, visual=visual)
    use_plain_versions()
    try:
        plain, _, _, _ = pdrop_prefill(gen, ids, px, replay=stages.keeps, visual=visual)
        moved, _, _, _ = pdrop_prefill(gen, ids, px, replay=stages.keeps, visual=nudged)
        llm32 = NanoModel(arch_p.llm, torch.float32, DEV)
        llm32.load_state_dict(model.llm_backbone.state_dict())
        merge32 = copy.deepcopy(model.merge_modules).float()
        first = int(kern.float().argmax())
        with StageLog(replay=stages.keeps):
            f32 = forced_logits_pdrop(llm32, merge32, arch_p, gen, ids, visual, [first])[-1]
    finally:
        use_kernels()
    del llm32, merge32
    torch.cuda.empty_cache()
    cos = {"kernels vs f32": cosine(kern, f32), "plain vs f32": cosine(plain, f32),
           "kernels vs plain": cosine(kern, plain), "plain vs plain one ulp up": cosine(plain, moved),
           "plain one ulp up vs f32": cosine(moved, f32)}
    log(f"[pdrop witness] {tag}, one keep set, first-logit cosines: "
        + ", ".join(f"{k} {v:.6f}" for k, v in cos.items()))
    if min_cos is not None and not cos["kernels vs f32"] > min_cos:
        raise AssertionError(f"pdrop witness {tag}: the kernels' first logits part from the f32 "
                             "run's")
    return cos


class CallLog:
    """Wraps a kernel wrapper: keeps the inputs (args, kwargs) of the first
    call at each key(*args) while armed, and in `grads` the cotangent that
    reaches that call's (first) output in the backward, if one does."""

    def __init__(self, fn, key):
        self.fn, self.key, self.armed, self.calls, self.grads = fn, key, True, {}, {}

    def __call__(self, *args, **kw):
        key = self.key(*args)
        first = self.armed and key not in self.calls
        if first:
            self.calls[key] = (tuple(clone_arg(a) for a in args),
                               {k: clone_arg(v) for k, v in kw.items()})
        out = self.fn(*args, **kw)
        head = out[0] if isinstance(out, tuple) else out
        if first and head.requires_grad:
            head.register_hook(lambda grad: self.grads.__setitem__(key, grad.detach().clone()))
        return out


@contextlib.contextmanager
def logging_calls(places: dict, key=None):
    """While installed, each place (name -> (module, attribute)) calls
    through a CallLog keyed by `key` (by_length by default); yields the logs
    by name."""
    logs = {name: CallLog(getattr(mod, attr), key or by_length)
            for name, (mod, attr) in places.items()}
    for name, (mod, attr) in places.items():
        setattr(mod, attr, logs[name])
    try:
        yield logs
    finally:
        for name, (mod, attr) in places.items():
            setattr(mod, attr, logs[name].fn)


def first_call(*args):
    """CallLog's key that keeps only the first call."""
    return 0


def by_length(x, *args):
    """CallLog's key for K1 and K2: the row count of their first argument."""
    return x.shape[1]


def by_transv_shape(q, k, *args):
    """CallLog's key for K9: (Lq, Lk, B)."""
    return q.shape[1], k.shape[1], q.shape[0]


@torch.no_grad()
def compare_logged(name: str, calls: dict, tag: str, kernel_results: dict) -> None:
    """A kernel against its plain version on each call CallLog kept."""
    for key, (args, kw) in sorted(calls.items()):
        err = compare(name, CALLS[name](*args, **kw), PLAIN[name](*args, **kw))
        shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
        log(f"[{tag}] {name} at {key} on the path's own inputs {shapes}: max abs err {err:.3e}")
        kernel_results[name]["max_abs_err"] = max(kernel_results[name]["max_abs_err"], err)


def phase_pdrop(model, arch, smi: str, kernel_results: dict) -> None:
    """5c: pdrop and TransV on the bf16 9B (PDROP; the merge modules from a
    generator of their own, q_proj tempered by temper_transv, transv_witness
    before and after; the tempered kernel run within a cosine of 0.99 of the
    f32 run): (a) the 64-
    and 256-frame requests through
    generate(use_pdrop=True), K1, K2, K3 and K9 launched, the rows after each
    stage and each attention layer's kv_len, the first logits (cosine 0.99)
    and the attn keep set (99% overlap) against a run of the plain
    versions, K1 and K2 against their plain versions on the first call at
    each row count the stages give, the pdrop prefill's seconds beside the
    plain prefill's; (b)
    prefill_prefix(use_pdrop=True) of the long-video phase's 1,016-frame
    prefix and its 40-token question, and nano_forward_longctx with the
    stages against one pdrop prefill of the same row (cosine 0.999); (c)
    ServingEngine(pdrop_frames=64): a text-only request and 8 of 64 frames
    through 8 slots, each request's tokens those of the offline Generator,
    or where they part within MISS_GAP_LIMIT of the argmax of an f32
    teacher-forcing pdrop forward; (d) K9 on the TransV calls the paths made
    (prefill 32 x 820 / 819, decode 1 x 820 / 819, the engine's B 8)
    against its plain version and SDPA."""
    arch_p = pdrop_arch(arch)
    cfg = arch_p.llm
    attach_merge_modules(model, arch_p)
    for var in FUSIONS:
        os.environ[var] = "0"
    gen = Generator(model, arch_p, terminator_ids=[], max_new_tokens=MAX_NEW)
    requests = make_requests(arch)[1:]
    transv_witness(model, arch_p, gen, *requests[0][1], "64 frames, weights as drawn")
    factors = temper_transv(model, gen, *requests[0][1])
    log(f"[pdrop] TransV q_proj rescaled by {', '.join(f'{f:.3e}' for f in factors)} (stage "
        "order): cross-attention logits of standard deviation 1 on the 64-frame request")
    transv_witness(model, arch_p, gen, *requests[0][1], "64 frames, q_proj tempered", 0.99)
    calls = CallLog(block_attn_lse, by_transv_shape)
    attn_mod.block_attn_lse = calls
    try:
        # (a) the Generator; K1 and K2 logged at each length the stages give
        path = {name: CallLog(CALLS[name], by_length) for name in ("ssd_fwd", "flash_fwd")}
        for name, logged in path.items():
            setattr(*ROUTES[name], logged)
        reset_launches()
        for label, (ids, px) in requests:
            o = gen.generate(ids, pixels=px, image_token_id=IMAGE_TOKEN, use_pdrop=True)
            if not torch.isfinite(o.first_logits).all():
                raise AssertionError(f"pdrop {label}: non-finite first-token logits")
            log(f"[pdrop] {label}: encode {o.encode_s:.3f} s, pdrop prefill {o.prefill_s:.3f} s, "
                f"decode {(o.num_generated - 1) / o.decode_s:.2f} tok/s, tokens "
                f"{o.token_ids.tolist()}")
        launches = {name: w.launches for name, w in WRAPPERS.items()}
        use_kernels()
        attn_mod.block_attn_lse = calls
        log(f"[pdrop] launches during the two pdrop requests: {launches}")
        for name in ("ssd_fwd", "flash_fwd", "vit_attn_qkv", "block_attn"):
            if launches[name] == 0:
                raise AssertionError(f"pdrop: {name} was never launched")
        calls.armed = False
        for name, logged in path.items():
            compare_logged(name, logged.calls, "pdrop", kernel_results)
        del path
        torch.cuda.empty_cache()
        for label, (ids, px) in requests:
            logits, cache, bucket, stages = pdrop_prefill(gen, ids, px)
            lens = kv_lens(cache, cfg)
            log(f"[pdrop] {label}: bucket {bucket}, rows "
                + " -> ".join(str(n) for n in [stages.lengths[0][0]]
                              + [after for _, after in stages.lengths])
                + f"; kv_len by attention layer {lens}; cache length {cache['length']}; "
                f"TransV rows by stage {[c['k'].shape[0] for c in cache['ca_kv']]}")
            del cache
            # the plain versions rank on their own (the overlap) and then keep
            # the kernel run's set (the first logits); a second plain run keeps
            # its own set, and the kernel run is repeated with that set
            use_plain_versions()
            try:
                ref, _, _, ref_stages = pdrop_prefill(gen, ids, px, replay=stages.keeps)
                free, _, _, _ = pdrop_prefill(gen, ids, px)
            finally:
                use_kernels()
            swapped, _, _, _ = pdrop_prefill(gen, ids, px, replay=ref_stages.keeps)
            keep, ref_keep = stages.keeps[0], ref_stages.keeps[0]
            overlap = len(set(keep.tolist()) & set(ref_keep.tolist())) / len(ref_keep)
            log(f"[pdrop] {label}: attn keep set, kernels vs plain versions: {overlap:.2%} of "
                f"{len(ref_keep)} overlap; first logits cosine, each run with its own keep set "
                f"{cosine(logits, free):.6f}, the kernels with the plain versions' set vs the "
                f"kernels with their own {cosine(swapped, logits):.6f}, vs the plain versions "
                f"{cosine(swapped, free):.6f}")
            logits_agree(f"pdrop {label}, kernels vs plain versions, one keep set", logits, ref)
            if overlap < 0.99:
                raise AssertionError(f"pdrop {label}: keep sets overlap {overlap:.2%}")
            # each stage drops what pdrop_drop_counts says (820 and 819 at 256
            # frames: 8,192 -> 7,372 -> 6,553), and an attention layer keeps
            # the rows it saw
            rows = [bucket]
            for drop in pdrop_mod.pdrop_drop_counts(cfg, plan_visual(gen, ids)):
                rows.append(rows[-1] - drop)
            want = {i: rows[sum(st.layer <= i for st in cfg.pdrop_stages)] for i in lens}
            if stages.lengths != list(zip(rows, rows[1:])) or lens != want:
                raise AssertionError(f"pdrop rows {stages.lengths}, kv_len {lens}; want {rows}, "
                                     f"{want}")
        ids, px = requests[1][1]
        times = []
        for use in (True, False, True, False):
            o = gen.generate(ids, pixels=px, image_token_id=IMAGE_TOKEN, use_pdrop=use)
            times.append((use, o.prefill_s))
        log("[pdrop] 256 frames, prefill seconds in turns: " + ", ".join(
            f"{'pdrop' if use else 'plain'} {sec:.4f}" for use, sec in times) + f"; {smi}")

        # (b) long video: the 1,016-frame prefix of phase 5, from its generator
        g = torch.Generator(device=DEV).manual_seed(SEED + 5)
        size = arch.vision.image_size
        frames = torch.rand(1024, size, size, 3, generator=g, device=DEV)[:1016] * 2 - 1
        text = torch.randint(10, 130000, (8 + 12 + 40 + 300,), generator=g, device=DEV).tolist()
        prefix_ids, question = text[:8] + [IMAGE_TOKEN] * 1016, text[20:60]
        t0 = time.perf_counter()
        state = gen.prefill_prefix(prefix_ids, pixels=frames, image_token_id=IMAGE_TOKEN,
                                   suffix_budget=512, use_pdrop=True)
        torch.cuda.synchronize()
        log(f"[pdrop long video] prefill_prefix(use_pdrop=True): bucket {state.bucket}, cache "
            f"length {state.cache['length']}, kv_len {kv_lens(state.cache, cfg)}, "
            f"{time.perf_counter() - t0:.3f} s with the encode")
        before = block_attn_lse.launches
        o = gen.generate(question, prefix=state)
        if not torch.isfinite(o.first_logits).all():
            raise AssertionError("pdrop long video: non-finite logits")
        log(f"[pdrop long video] 40-token question: continuation {o.prefill_s:.3f} s, K9 "
            f"launches {block_attn_lse.launches - before}, tokens {o.token_ids.tolist()}")
        del state
        llm = model.llm_backbone
        with torch.inference_mode():
            visual = gen.encode_frames(frames)
            emb = lambda x: llm.embeddings(torch.as_tensor(x, device=DEV))  # noqa: E731
            row = torch.cat([emb(text[:8]), visual, emb(question)])[None]
            nv, L = visual.shape[0], row.shape[1]
            spec = make_pdrop_spec([(8, nv, len(question))], cfg.pdrop_stages, [L - 1])
            t0 = time.perf_counter()
            one = nano_forward(llm, cfg, inputs_embeds=row, logits_to_keep=1, pdrop_spec=spec,
                               pdrop_params=model.merge_modules)["logits"][:, -1]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with StageLog() as stages:
                long = nano_forward_longctx(llm, cfg, row, chunk_tokens=4096, pdrop_spec=spec,
                                            pdrop_params=model.merge_modules)["logits"][:, -1]
            torch.cuda.synchronize()
        log(f"[pdrop long video] {L} rows -> "
            + " -> ".join(str(after) for _, after in stages.lengths)
            + f": one-shot pdrop prefill {t1 - t0:.3f} s, longctx (chunks of 4,096) "
            f"{time.perf_counter() - t1:.3f} s")
        logits_agree("pdrop long video, longctx vs one-shot", long, one, 0.999)
        del frames, visual, row, one, long
        torch.cuda.empty_cache()

        # (c) the engine: a text-only request, then 8 of 64 frames
        g = torch.Generator(device=DEV).manual_seed(SEED + 9)
        mix = [dict(input_ids=torch.randint(10, 130000, (100,), generator=g,
                                            device=DEV).tolist(), max_new_tokens=MAX_NEW)]
        for _ in range(8):
            ids = torch.randint(10, 130000, (40,), generator=g, device=DEV).tolist()
            mix.append(dict(input_ids=ids[:8] + [IMAGE_TOKEN] * 64 + ids[8:],
                            pixels=torch.rand(64, size, size, 3, generator=g, device=DEV) * 2 - 1,
                            image_token_id=IMAGE_TOKEN, max_new_tokens=MAX_NEW))
        eng = ServingEngine(model, arch_p, terminator_ids=[], num_slots=8, max_len=4096,
                            steps_per_sync=4, pdrop_frames=64)
        reset_launches()
        attn_mod.block_attn_lse, calls.armed = calls, True  # the plain runs routed past it
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.run([Request(request_id=i, **kw) for i, kw in enumerate(mix)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        calls.armed = False
        n_tok = sum(len(r.output_ids) for r in out)
        log(f"[pdrop engine] {len(out)} requests, {n_tok} output tokens in {wall:.3f} s, "
            f"{n_tok / wall:.2f} output tokens/s; launches "
            f"{ {name: w.launches for name, w in WRAPPERS.items()} }; {smi}")
        bad = [(r.request_id, r.error) for r in out if r.error or not r.done]
        if bad:
            raise AssertionError(f"pdrop engine requests failed: {bad}")
        del eng
        check_pdrop_engine(model, arch_p, mix, out)
    finally:
        attn_mod.block_attn_lse = block_attn_lse
    # the long-video phase's count, and the two pdrop requests' of (a)
    kernel_results["block_attn"]["launches"] += launches["block_attn"]
    time_transv_calls(calls.calls, kernel_results)
    model.merge_modules = None
    torch.cuda.empty_cache()


def time_transv_calls(calls: dict, kernel_results: dict) -> None:
    """(d) K9 on the TransV calls the paths made, {(Lq, Lk, B): inputs}."""
    with torch.no_grad():
        for (Lq, Lk, B), ((q, k, v), kw) in sorted(calls.items()):
            err = compare("block_attn", block_attn_lse(q, k, v, **kw),
                          block_attn_lse_plain(q, k, v, **kw))
            ms = timed_ms(lambda: block_attn_lse(q, k, v, **kw))
            plain_ms = timed_ms(lambda: block_attn_lse_plain(q, k, v, **kw), iters=3)
            lib_in = [x.transpose(1, 2).contiguous() for x in (q, k, v)]
            lib_ms = timed_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                *lib_in, enable_gqa=True))
            Hq, Hkv, hd = q.shape[2], k.shape[2], q.shape[3]
            bound_ms, bound_by = bound(4 * B * Hq * hd * Lq * Lk,
                                       nbytes(q, k, v, q) + 8 * B * Hq * Lq)
            pack, n_split, _ = block_attn_plan(B, Lq, Lk, Hq, Hkv)
            log(f"[pdrop] block_attn [TransV {Lq} x {Lk}, B {B}]: max abs err {err:.3e}; kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms (SDPA), bound "
                f"{bound_ms:.4f} ms ({bound_by}); {n_split} key split(s), {pack} heads a block")
            kernel_results["block_attn"]["max_abs_err"] = max(
                kernel_results["block_attn"]["max_abs_err"], err)


def check_pdrop_engine(model, arch_p, mix, out) -> None:
    """Each engine request's tokens against the offline Generator's (pdrop
    for the video requests); where they part, every engine token from there
    that is not the argmax of an f32 teacher-forcing pdrop forward (an f32
    copy of the backbone and the merge modules, plain versions) must lie
    within MISS_GAP_LIMIT of it."""
    llm32 = merge32 = None
    same = 0
    for i, (kw, r) in enumerate(zip(mix, out)):
        gen = Generator(model, arch_p, terminator_ids=[], max_new_tokens=len(r.output_ids))
        px = kw.get("pixels")
        ref = gen.generate(kw["input_ids"], pixels=px, image_token_id=IMAGE_TOKEN,
                           use_pdrop=px is not None).token_ids.tolist()
        first = next((j for j, (a, b) in enumerate(zip(r.output_ids, ref)) if a != b), None)
        if first is None:
            same += 1
            continue
        if px is None:
            raise AssertionError(f"pdrop engine: the text-only request's tokens {r.output_ids} "
                                 f"are not generate()'s {ref}")
        if llm32 is None:
            llm32 = NanoModel(arch_p.llm, torch.float32, DEV)
            llm32.load_state_dict(model.llm_backbone.state_dict())
            merge32 = copy.deepcopy(model.merge_modules).float()
        with torch.inference_mode():
            visual = gen.encode_frames(px)
        use_plain_versions()
        try:
            rows = forced_logits_pdrop(llm32, merge32, arch_p, gen, kw["input_ids"], visual,
                                       r.output_ids)
        finally:
            use_kernels()
        gaps = [(rows[j].max() - rows[j, tok]).item() for j, tok in enumerate(r.output_ids)]
        worst = max(gaps[first:])
        log(f"[pdrop engine] request {i}: tokens part from the offline Generator's at {first} "
            f"({r.output_ids} vs {ref}); largest gap below the f32 argmax from there "
            f"{worst:.3e} (limit {MISS_GAP_LIMIT})")
        if worst > MISS_GAP_LIMIT:
            raise AssertionError(f"pdrop engine request {i}: a token {worst:.3e} below the f32 "
                                 "argmax")
    log(f"[pdrop engine] {same} of {len(out)} requests give the offline Generator's tokens")
    del llm32, merge32
    torch.cuda.empty_cache()


def training_row(arch, n_frames: int, g: torch.Generator, question: int = 0):
    """One row, collated as a user's data would be: 8 text tokens, the frames,
    32 text tokens, with labels on those last 32 but the first `question`
    (a question without labels, whose last row a training "attn" pdrop
    stage ranks by)."""
    text = torch.randint(10, 130000, (40,), generator=g, device=DEV).tolist()
    ids = text[:8] + [IMAGE_TOKEN] * n_frames + text[8:]
    labels = [IGNORE_INDEX] * (8 + n_frames + question) + text[8 + question:]
    size = arch.vision.image_size
    pixels = torch.rand(n_frames, size, size, 3, generator=g, device=DEV) * 2 - 1
    return collate([{"input_ids": torch.tensor(ids).numpy(),
                     "labels": torch.tensor(labels).numpy(), "pixels": pixels.cpu().numpy()}],
                   IMAGE_TOKEN, arch.tokens_per_frame)


def profile_call(label: str, fn, top: int = 25) -> None:
    """torch.profiler over one call: device time by kernel name and the share
    of the call's wall time the device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): a CPU op's entry repeats the
    # device time of the kernels it launched
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"[profile] {label}: wall {wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
        f"({100 * busy / wall_us:.1f}%), {sum(r[2] for r in rows)} device launches")
    for key, us, count in rows[:top]:
        log(f"[profile]   {us / 1e3:9.2f} ms {count:6d}x  {key[:110]}")
    # the SSD kernels' passes together, by their argument structs' names
    for what, tags in (("K4 (csrc/ssd_bwd.cu), all passes", ("BwdArgs",)),
                       ("K1 / K5 (csrc/ssd_fwd.cu), all passes", ("SsdArgs", "ConvArgs"))):
        mine = [r for r in rows if any(tag in r[0] for tag in tags)]
        if mine:
            log(f"[profile]   {sum(r[1] for r in mine) / 1e3:9.2f} ms {sum(r[2] for r in mine):6d}x"
                f"  {what}")


# where each family's training path calls K1 and K2 (their autograd
# functions, whose backwards are K4 and K2-bwd)
TRAINING_PLACES = {"nano": {"ssd_fwd": (nano_mod, "ssd_scan"),
                            "flash_fwd": (nano_mod, "flash_attention")},
                   "qwen2": {"flash_fwd": (qwen2_mod, "flash_attention")}}


def check_training_calls(tag: str, logs: dict, kernel_results: dict) -> None:
    """K1 and K2, and their backwards K4 and K2-bwd, on the calls a training
    run's CallLogs kept (the first at each row count): each forward against
    its plain version (compare_logged), each backward, given the cotangent
    that call's output got, against autograd through the plain version."""
    for name, calls in logs.items():
        compare_logged(name, calls.calls, tag, kernel_results)
        bwd = {"ssd_fwd": "ssd_bwd", "flash_fwd": "flash_bwd"}[name]
        for key, (args, kw) in sorted(calls.calls.items()):
            if key not in calls.grads:
                raise AssertionError(f"{tag}: no cotangent reached {name} at {key}")
            g = calls.grads[key]
            if name == "ssd_fwd":
                leaves = [a.clone().requires_grad_() for a in (*args[:5], kw["D"], kw["dt_bias"])]
                y, _ = ssd_scan(*leaves[:5], chunk_size=kw["chunk_size"], D=leaves[5],
                                dt_bias=leaves[6], dt_limit=kw["dt_limit"], seq_idx=kw["seq_idx"])
                got = torch.autograd.grad(y, leaves, g)
                want = ssd_scan_bwd_plain(*args[:5], kw["D"], kw["dt_bias"], kw["seq_idx"], g,
                                          None, kw["chunk_size"], kw["dt_limit"])[:7]
            else:
                leaves = [a.clone().requires_grad_() for a in args[:3]]
                seg = kw.get("segment_ids")
                got = torch.autograd.grad(flash_attention(*leaves, segment_ids=seg), leaves, g)
                want = flash_attention_bwd_plain(*args[:3], g, seg)
            err = compare(bwd, tuple(got), tuple(want))
            log(f"[{tag}] {bwd} at {key} on the first step's own inputs and cotangent "
                f"{[tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]}: max abs err "
                f"{err:.3e}")
            kernel_results[bwd]["max_abs_err"] = max(kernel_results[bwd]["max_abs_err"], err)


def phase_training(model, arch, kernel_results: dict, profile: bool = False) -> None:
    add_lora(model, rank=8, alpha=16.0,
             generator=torch.Generator(device=DEV).manual_seed(SEED + 2))
    g = torch.Generator(device=DEV).manual_seed(SEED + 3)
    short, long_ = training_row(arch, 64, g), training_row(arch, 256, g)
    opt_cfg = OptimConfig(learning_rate=1e-3, schedule="constant", max_grad_norm=1.0)
    with tempfile.TemporaryDirectory() as run_dir:
        cfg = TrainerConfig(run_dir=run_dir, max_steps=5, log_every=1, save_every=10**9,
                            lora=True, trainable_modules="projector", remat="full",
                            resume=False)
        trainer = Trainer(arch, model, opt_cfg, cfg, device=DEV)
        n_lora = sum(p.numel() for n, p in trainer.opt.params.items() if ".lora_" in n)
        n_train = sum(p.numel() for p in trainer.opt.params.values())
        log(f"[train] LoRA rank 8 on {sum('.lora_a' in n for n in trainer.opt.params)} "
            f"linears: {n_lora / 1e6:.2f} M factor parameters, {n_train / 1e6:.2f} M "
            f"trainable with the projector")
        start = {n: p.detach().clone() for n, p in trainer.opt.params.items()}
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with logging_calls(TRAINING_PLACES["nano"]) as logs:
            trainer.train([short] * 4)
            for c in logs.values():
                c.armed = False
            trainer.train([long_])
        launches = {name: w.launches for name, w in WRAPPERS.items()}
    log(f"[train] launches during the five steps: {launches}")
    for h, cb in zip(trainer.history, [short] * 4 + [long_]):
        tokens = cb.plan.fused_len * cb.batch["input_ids"].shape[0]
        log(f"[train] step {h['step']}: {tokens} tokens, loss {h['loss']:.4f}, grad norm "
            f"{h['grad_norm']:.4f}, {h['seconds']:.3f} s, {tokens / h['seconds']:.1f} "
            f"trained tokens/s, peak memory {h.get('max_memory_gib', math.nan):.2f} GiB")
    losses = [h["loss"] for h in trainer.history]
    if len(losses) != 5 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"training losses {losses}")
    if not losses[3] < losses[0]:
        raise AssertionError(f"the 4th loss {losses[3]} is not below the 1st {losses[0]}")
    for name in TRAINING:
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched on the training path")
    for name in ("ssd_bwd", "flash_bwd"):
        kernel_results[name]["launches"] += launches[name]

    check_training_calls("train", logs, kernel_results)
    del logs
    torch.cuda.empty_cache()

    # the first step's gradient again from the same start, kernels vs plain versions
    with torch.no_grad():
        for n, p in trainer.opt.params.items():
            p.copy_(start[n])
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in short.batch.items()}
    m_k, g_k = grad_step(model, arch, trainer.opt.params, batch, short.plan)
    use_plain_versions()
    try:
        m_p, g_p = grad_step(model, arch, trainer.opt.params, batch, short.plan)
    finally:
        use_kernels()
    names = [n for n in g_k if ".lora_" in n]
    vk = torch.cat([g_k[n].flatten() for n in names])
    vp = torch.cat([g_p[n].flatten() for n in names])
    cos = torch.nn.functional.cosine_similarity(vk, vp, dim=0).item()
    lk, lp = float(m_k["loss"]), float(m_p["loss"])
    log(f"[train] first step, kernels vs plain versions: loss {lk:.6f} vs {lp:.6f} "
        f"(logged {losses[0]:.6f}); LoRA gradient cosine {cos:.6f}, norms "
        f"{vk.norm().item():.4e} vs {vp.norm().item():.4e}")
    # bf16 activations and gradients through 52 layers round at other places
    if not (abs(lk - lp) <= 1e-2 * abs(lp) and cos > 0.99):
        raise AssertionError("the first training step disagrees with the plain-version run")
    if profile:
        profile_call(f"one training step at {long_.plan.fused_len} tokens",
                     lambda: trainer.train_step(long_))
    phase_pdrop_training(model, arch, pdrop_arch(arch), kernel_results, "train pdrop",
                         trainer.history)


# 6b: the first tower-training step's gradient groups, each held to a cosine
# of TOWER_GRAD_COS against the same step with the ViT attention backward's
# plain version (K3's forward a kernel on both sides: one bf16 ulp at its
# place re-decides ToMe's merges, tests/test_torch_tome_ulp.py, and a gate
# that let it vary would measure ToMe, not the backward)
TOWER_GRAD_COS = 0.99
TOWER_FRAMES = 64  # the 1,064-token training row; 256 frames would not fit (PERF.md §7)


def tower_groups(n_layers: int) -> dict:
    """LoRA, the projector, the tower's blocks in thirds and its embeddings."""
    cut = [0, n_layers // 3, 2 * n_layers // 3, n_layers]
    groups = {"LoRA factors": lambda n: ".lora_" in n,
              "projector": lambda n: n.startswith("projector.")}
    for a, b in zip(cut, cut[1:]):
        groups[f"tower blocks {a}-{b - 1}"] = (
            lambda n, a=a, b=b: n.startswith("vision_backbone.layers.")
            and a <= int(n.split(".")[2]) < b)
    groups["tower embeddings"] = (lambda n: n.startswith("vision_backbone.")
                                  and not n.startswith("vision_backbone.layers."))
    return groups


def phase_tower_training(model, arch, smi: str, kernel_results: dict) -> None:
    """6b: the 9B with a trainable SigLIP tower: LoRA on the backbone plus
    trainable_modules="vision_backbone,projector" with its own vision_lr,
    four Trainer steps at 1,064 tokens (64 frames). The tower's attention is
    K3's LSE variant and the backward kernel (VitAttnQKVFn), exactly one
    launch of each a layer and step. First the first step's gradients,
    kernels against the backward's plain version, by group."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[tower train] {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated before the "
        f"phase")
    g = torch.Generator(device=DEV).manual_seed(SEED + 17)
    row = training_row(arch, TOWER_FRAMES, g)
    n_layers = len(model.vision_backbone.layers)
    opt_cfg = OptimConfig(learning_rate=1e-3, vision_lr=2e-5, schedule="constant",
                          max_grad_norm=1.0)
    with tempfile.TemporaryDirectory() as run_dir:
        cfg = TrainerConfig(run_dir=run_dir, max_steps=4, log_every=1, save_every=10**9,
                            lora=True, trainable_modules="vision_backbone,projector",
                            remat="full", resume=False)
        trainer = Trainer(arch, model, opt_cfg, cfg, device=DEV)
        params = trainer.opt.params
        n_tower = sum(p.numel() for n, p in params.items() if n.startswith("vision_backbone."))
        log(f"[tower train] {sum(p.numel() for p in params.values()) / 1e6:.1f} M trainable "
            f"parameters, {n_tower / 1e6:.1f} M of them the tower's ({n_layers} blocks) at "
            f"vision_lr {opt_cfg.vision_lr} (the rest {opt_cfg.learning_rate}); "
            f"{row.plan.fused_len} tokens a step")
        batch = {k: torch.from_numpy(v).to(DEV) for k, v in row.batch.items()}
        # (1) the first step's gradients: the backward kernel, then its plain
        # version (the formulas in f32 from K3's output and LSE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m_k, g_k = grad_step(model, arch, params, batch, row.plan)
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
        vit_attention_mod.vit_attention_qkv_bwd = vit_attention_qkv_bwd_plain
        try:
            t0 = time.perf_counter()
            m_p, g_p = grad_step(model, arch, params, batch, row.plan)
            torch.cuda.synchronize()
            t_p = time.perf_counter() - t0
        finally:
            vit_attention_mod.vit_attention_qkv_bwd = vit_attention_qkv_bwd
        groups = tower_groups(n_layers)
        cos = {}
        for group, pick in groups.items():
            names = [n for n in g_k if pick(n)]
            a, b = (torch.cat([gr[n].flatten() for n in names]) for gr in (g_k, g_p))
            cos[group] = (cosine(a, b), a.norm().item(), b.norm().item())
        lk, lp = float(m_k["loss"]), float(m_p["loss"])
        log(f"[tower train] first step, backward kernel vs its plain version (K3 forward on "
            f"both sides): loss {lk:.6f} vs {lp:.6f}, {t_k:.3f} s vs {t_p:.3f} s; gradient "
            f"cosine by group: " + "; ".join(f"{grp} {c:.6f} (norms {na:.4e} / {nb:.4e})"
                                              for grp, (c, na, nb) in cos.items()))
        del g_k, g_p, m_k, m_p
        torch.cuda.empty_cache()
        bad = {grp: c for grp, (c, _, _) in cos.items() if not c >= TOWER_GRAD_COS}
        if bad or abs(lk - lp) > 1e-5 * abs(lp):  # one forward, twice
            raise AssertionError(f"tower training: first-step gradients against the plain "
                                 f"backward: {bad}, losses {lk} / {lp}")
        # (2) four steps
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        trainer.train([row] * 4)
        launches = {name: w.launches for name, w in WRAPPERS.items()}
        hist = trainer.history
    log(f"[tower train] launches during the four steps: {launches}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    for h in hist:
        log(f"[tower train] step {h['step']}: loss {h['loss']:.4f}, grad norm "
            f"{h['grad_norm']:.4f} (tower {h.get('grad_norm/vision_backbone', math.nan):.4f}, "
            f"projector {h.get('grad_norm/projector', math.nan):.4f}), {h['seconds']:.3f} s, "
            f"peak memory {h.get('max_memory_gib', math.nan):.2f} GiB")
    log(f"[tower train] peak memory over the four steps {peak:.2f} GiB of "
        f"{torch.cuda.get_device_properties(DEV).total_memory / 2**30:.1f} GiB; {smi}")
    losses = [h["loss"] for h in hist]
    if len(losses) != 4 or not all(math.isfinite(v) for v in losses + [h["grad_norm"]
                                                                      for h in hist]):
        raise AssertionError(f"tower training: losses {losses}")
    if peak * 2**30 >= 80e9:
        raise AssertionError(f"tower training: peak memory {peak:.2f} GiB")
    want = {"vit_attn_qkv": 4 * n_layers, "vit_attn_bwd": 4 * n_layers}
    for name, count in want.items():
        if launches[name] != count:
            raise AssertionError(f"tower training: {name} launched {launches[name]} times, "
                                 f"want {count}")
    for name in TRAINING:
        if launches[name] == 0:
            raise AssertionError(f"tower training: {name} was never launched")
    kernel_results["vit_attn_bwd"]["launches"] = launches["vit_attn_bwd"]
    kernel_results["vit_attn_qkv"]["launches"] += launches["vit_attn_qkv"]  # the LSE variant


# the parameter groups whose first-step gradients the pdrop training holds
# against the plain versions' (K3 a kernel on both sides), each to a cosine
# of PDROP_GRAD_COS
PDROP_GRAD_COS = 0.99
PDROP_GRAD_GROUPS = {
    "LoRA factors": lambda n: ".lora_" in n,
    "projector": lambda n: n.startswith("projector."),
    **{f"merge {proj}": (lambda n, proj=proj: f".cross_attn.{proj}." in n)
       for proj in ("q_proj", "k_proj", "v_proj", "o_proj")},
    "merge alpha": lambda n: n.startswith("merge_modules.") and n.endswith(".alpha"),
}
# the runs of the gradient bisection: one kernel (or a forward kernel and
# its backward) on, every other call its plain version
BISECTION = {"nano": {"K1 (K4 plain)": ("K1",), "K1 + K4": ("K1", "K4"),
                      "K2 (K2-bwd plain)": ("K2",), "K2 + K2-bwd": ("K2", "K2-bwd"),
                      "K3": ("K3",), "TransV": ("TransV",)},
             "qwen2": {"K2 (K2-bwd plain)": ("K2",), "K2 + K2-bwd": ("K2", "K2-bwd"),
                       "K3": ("K3",), "TransV": ("TransV",)}}


def kernel_switches(family: str) -> dict:
    """The calls of a family's pdrop training path that the gradient
    bisection turns between a kernel and its plain version, by kernel:
    (module, attribute, kernel, plain version). K4 and K2-bwd are the
    backwards of K1's and K2's autograd functions, so they run only while
    K1 and K2 do; TransV is K9 forward and K2-bwd's non-causal mode."""
    table = {"K2": (qwen2_mod if family == "qwen2" else nano_mod, "flash_attention",
                    CALLS["flash_fwd"], PLAIN["flash_fwd"]),
             "K2-bwd": (flash_mod, "flash_attention_bwd", flash_attention_bwd,
                        lambda q, k, v, out, dout, lse, seg:
                        flash_attention_bwd_plain(q, k, v, dout, seg)),
             "K3": (vit_mod, "encoder_attention_qkv", CALLS["vit_attn_qkv"],
                    PLAIN["vit_attn_qkv"]),
             "TransV": (pdrop_mod, "cross_attention", attn_mod.cross_attention,
                        attn_mod.attention)}
    if family == "qwen2":
        return table
    return {"K1": (nano_mod, "ssd_scan", CALLS["ssd_fwd"], PLAIN["ssd_fwd"]),
            "K4": (ssd_kernel_mod, "ssd_scan_bwd", ssd_scan_bwd,
                   lambda x, dt, A, B_, C, D, dt_bias, seq_idx, states, dy, dfinal, cs, lim:
                   ssd_scan_bwd_plain(x, dt, A, B_, C, D, dt_bias, seq_idx, dy, dfinal, cs,
                                      lim)),
            **table}


def rounding_noise(x: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """x with each element moved by a uniform draw of up to 2^-8 of itself
    and rounded to x's dtype again: in bf16, about a quarter of the elements
    move one ulp, as a rounding made at another place moves them."""
    u = torch.rand(x.shape, generator=g, device=x.device) * 2 - 1
    return (x.float() * (1 + u * 2.0**-8)).to(x.dtype)


class NoisyGrad(torch.autograd.Function):
    """The identity, with rounding noise on the gradient."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return rounding_noise(grad, ctx.g), None


def with_rounding_noise(fn, g: torch.Generator):
    """A plain version with rounding noise on its (first) output and on the
    gradients of its tensor arguments: the bisection's control, a run that
    rounds where the kernels run, at other places than the plain run."""
    def call(*args, **kw):
        args = [NoisyGrad.apply(a, g) if torch.is_tensor(a) and a.requires_grad else a
                for a in args]
        out = fn(*args, **kw)
        head = out[0] if isinstance(out, tuple) else out
        head = head + (rounding_noise(head.detach(), g) - head.detach())
        return (head, *out[1:]) if isinstance(out, tuple) else head
    return call


def pdrop_first_step(model, arch_p, params, batch, plan, family: str, on, keeps=None,
                     noise=None):
    """grad_step(use_pdrop=True) with the kernels named in `on` (of
    kernel_switches) and every other call its plain version; `noise` =
    (generator, names): those plain versions under rounding noise. The
    "attn" stage keeps `keeps` (in stage order) if given, else ranks its
    own. -> (loss, the gradients, the visual tokens, TransV's first (q, k,
    v), the keep sets it ranked)."""
    table = kernel_switches(family)
    for name, (mod, attr, kern, plain) in table.items():
        noisy = noise is not None and name in noise[1]
        setattr(mod, attr, kern if name in on else
                with_rounding_noise(plain, noise[0]) if noisy else plain)
    seen = []

    def encode(*args, **kw):
        seen.append(encode_visual(*args, **kw))
        return seen[-1]

    vlm_mod.encode_visual = encode
    try:
        with StageLog(replay=keeps) as kept, logging_calls(
                {"transv": (pdrop_mod, "cross_attention")}, key=first_call) as rec:
            m, g = grad_step(model, arch_p, params, batch, plan, use_pdrop=True)
    finally:
        vlm_mod.encode_visual = encode_visual
        for mod, attr, kern, _ in table.values():
            setattr(mod, attr, kern)
    return (float(m["loss"]), g, seen[0].detach(), rec["transv"].calls[0][0][:3],
            kept.keeps)


def group_cosines(g_a: dict, g_b: dict) -> dict:
    """Per PDROP_GRAD_GROUPS group: (cosine, norm of a, norm of b)."""
    out = {}
    for group, pick in PDROP_GRAD_GROUPS.items():
        names = [n for n in g_a if pick(n)]
        a, b = (torch.cat([g[n].float().flatten() for n in names]) for g in (g_a, g_b))
        out[group] = (cosine(a, b), a.norm().item(), b.norm().item())
    return out


def token_drift(got, want, limit: float = 0.05) -> str:
    """How many visual tokens of one run lie further than `limit` of their
    norm from the plain run's, and the largest such distance: a rounding
    moves a token by ~1e-2 of itself, a different ToMe merge by ~1."""
    rel = ((got.float() - want.float()).norm(dim=-1) / want.float().norm(dim=-1)).flatten()
    return (f"{int((rel > limit).sum())} of {rel.numel()} visual tokens moved by more than "
            f"{limit:g} of their norm (largest {rel.max().item():.3f})")


def input_drift(got, want) -> str:
    """How far TransV's first (q, k, v) in one run lie from the plain run's:
    the norm of the difference over the norm, whole and, for k and v, less
    each head's mean over the keys (what the merge q/k gradients read)."""
    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    def centred(x):
        return x.float() - x.float().mean(1, keepdim=True)

    parts = [f"{n} {rel(a, b):.3e}" for n, a, b in zip("qkv", got, want)]
    parts += [f"{n} less its key mean {rel(centred(a), centred(b)):.3e}"
              for n, a, b in zip("kv", got[1:], want[1:])]
    return ", ".join(parts)


def noncausal_bwd_check(tag: str, q, k, v, g) -> float:
    """K2-bwd's non-causal mode on one TransV call of the path (through
    cross_attention under autograd: K9, then the backward kernel) against
    its plain version given K9's output, to the kernel's tolerance."""
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(attn_mod.cross_attention(*leaves), leaves, g)
    with torch.no_grad():
        want = cross_attention_bwd_plain(q, k, v, block_attn_lse(q, k, v)[0], g)
    err = compare("flash_bwd_noncausal", tuple(got), want)
    log(f"[{tag}] flash_bwd_noncausal on the first step's first TransV call "
        f"{[tuple(a.shape) for a in (q, k, v)]}: max abs err {err:.3e}")
    return err


def phase_pdrop_training(model, arch, arch_p, kernel_results: dict, tag: str,
                         plain_history) -> None:
    """LoRA (the model's rank-8 factors) with pdrop and TransV: the merge
    modules attached from a generator of their own, tanh(alpha) 0.5, q_proj
    tempered on the 64-frame request (as phase 5c does), then trained with
    the projector and the LoRA factors (trainable_modules "projector,merge",
    use_pdrop) through Trainer.train: four steps on a 64-frame row (8 text
    tokens, the frames, 12 question tokens without labels, 20 answer tokens)
    and one on a 256-frame row. Every loss finite, the 4th below the 1st;
    the rows after each stage; every kernel of the path launched, K9 and
    K2-bwd's non-causal mode exactly twice a step (the two stages' TransV);
    on the first step's own inputs and cotangents, K1 / K4 and K2 / K2-bwd
    at each row count (before and after the stages; check_training_calls)
    and the non-causal mode on the first TransV call (noncausal_bwd_check)
    against their plain versions. Then the first step again from the same
    start, on the same keep sets: its gradients, group by group
    (PDROP_GRAD_GROUPS), against a run with every plain version but K3,
    cosine PDROP_GRAD_COS each and every merge group's norm non-zero. K3
    stays a kernel on both sides: no gradient passes the frozen tower, and a
    rounding at its place moves ~300 of the visual tokens wholly, which
    changes the dropped tokens and with them the merge q / k gradients by
    ~8% on the 9B. The bisection beside the gate shows it: every kernel,
    each alone among plain versions (BISECTION), and the plain versions
    under rounding noise at every kernel's place (twice) and at K3's alone,
    each against every plain version. Step s and peak memory beside the
    plain LoRA steps'."""
    family = arch.llm_family
    attach_merge_modules(model, arch_p)
    requests = make_requests(arch)
    gen = Generator(model, arch_p, terminator_ids=[], max_new_tokens=MAX_NEW)
    factors = temper_transv(model, gen, *requests[1][1])
    del gen
    log(f"[{tag}] {arch_p.llm.pdrop_type}, CrossAttention, tanh(alpha) 0.5; TransV q_proj "
        f"rescaled by {', '.join(f'{f:.3e}' for f in factors)} (stage order)")
    g = torch.Generator(device=DEV).manual_seed(SEED + 16)
    short = training_row(arch, 64, g, question=12)
    long_ = training_row(arch, 256, g, question=12)
    # the merge modules at the stage-2 recipe's learning rate (docs/USAGE.md:
    # --learning_rate 1e-5, which the merge group takes), the LoRA factors
    # and the projector at the plain LoRA phase's
    opt_cfg = OptimConfig(learning_rate=1e-3, merge_lr=1e-5, schedule="constant",
                          max_grad_norm=1.0)
    with tempfile.TemporaryDirectory() as run_dir:
        cfg = TrainerConfig(run_dir=run_dir, max_steps=5, log_every=1, save_every=10**9,
                            lora=True, trainable_modules="projector,merge", use_pdrop=True,
                            remat="full", resume=False)
        trainer = Trainer(arch_p, model, opt_cfg, cfg, device=DEV)
        n_merge = sum(p.numel() for n, p in trainer.opt.params.items()
                      if n.startswith("merge_modules."))
        log(f"[{tag}] trainable: {sum(p.numel() for p in trainer.opt.params.values()) / 1e6:.2f}"
            f" M parameters, {n_merge / 1e6:.2f} M of them in the merge modules")
        start = {n: p.detach().clone() for n, p in trainer.opt.params.items()}
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with StageLog() as stages, logging_calls(TRAINING_PLACES[family]) as logs, \
                logging_calls({"transv": (pdrop_mod, "cross_attention"),
                               "vit_attn_qkv": (vit_mod, "encoder_attention_qkv")},
                              key=first_call) as once:
            trainer.train([short] * 4)
            for c in (*logs.values(), *once.values()):
                c.armed = False
            trainer.train([long_])
        launches = {name: w.launches for name, w in WRAPPERS.items()}
    log(f"[{tag}] launches during the five steps: {launches}")
    for h, ph, cb in zip(trainer.history, plain_history, [short] * 4 + [long_]):
        log(f"[{tag}] step {h['step']}: {cb.plan.fused_len} tokens, loss {h['loss']:.4f}, grad "
            f"norm {h['grad_norm']:.4f} (merge modules {h['grad_norm/merge_modules']:.4f}), "
            f"{h['seconds']:.3f} s, peak memory {h.get('max_memory_gib', math.nan):.2f} GiB; "
            f"the plain LoRA step {ph['seconds']:.3f} s, "
            f"{ph.get('max_memory_gib', math.nan):.2f} GiB")
    losses = [h["loss"] for h in trainer.history]
    norms = [h["grad_norm"] for h in trainer.history]
    if len(losses) != 5 or not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError(f"{tag}: losses {losses}, grad norms {norms}")
    if not losses[3] < losses[0]:
        raise AssertionError(f"{tag}: the 4th loss {losses[3]} is not below the 1st {losses[0]}")
    want_rows = []
    for cb in [short] * 4 + [long_]:
        rows = [cb.plan.fused_len]
        for drop in pdrop_mod.pdrop_drop_counts(arch_p.llm, cb.plan.num_visual):
            rows.append(rows[-1] - drop)
        want_rows += list(zip(rows, rows[1:]))
    log(f"[{tag}] rows before and after each stage: {stages.lengths[:2]} (64 frames), "
        f"{stages.lengths[-2:]} (256 frames)")
    if stages.lengths != want_rows:
        raise AssertionError(f"{tag}: stage rows {stages.lengths}, want {want_rows}")
    need = dict(TRANSV_TRAIN_LAUNCHES)
    path = (("flash_fwd", "vit_attn_qkv", "flash_bwd") if family == "qwen2"
            else TRAINING) + tuple(need)
    for name in path:
        if launches[name] == 0 or launches[name] != need.get(name, launches[name]):
            raise AssertionError(f"{tag}: {name} launched {launches[name]} times, want "
                                 f"{need.get(name, 'some')}")
    for name in path:
        if name != "vit_attn_qkv":
            kernel_results[name]["launches"] += launches[name]

    # the kernels of the path on the first step's own inputs and cotangents:
    # K1 / K4 and K2 / K2-bwd at each row count, before and after the
    # stages, K3 on the tower's first call, and the non-causal mode on the
    # first TransV call
    check_training_calls(tag, logs, kernel_results)
    compare_logged("vit_attn_qkv", once["vit_attn_qkv"].calls, tag, kernel_results)
    (args, _), = once["transv"].calls.values()
    err = noncausal_bwd_check(tag, *args[:3], once["transv"].grads[0])
    res = kernel_results["flash_bwd_noncausal"]
    res["max_abs_err"] = max(res["max_abs_err"], err)
    del logs, once, args
    torch.cuda.empty_cache()

    # the first step again from the same start, on the kernels' keep sets:
    # every kernel against every plain version but K3 (the gate), against
    # every plain version, and the bisection: each kernel alone among plain
    # versions, and the plain versions under rounding noise (the control)
    with torch.no_grad():
        for n, p in trainer.opt.params.items():
            p.copy_(start[n])
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in short.batch.items()}
    step_args = (model, arch_p, trainer.opt.params, batch, short.plan, family)
    every = tuple(kernel_switches(family))
    lk, g_k, v_k, x_k, keeps = pdrop_first_step(*step_args, every)
    lr, g_r, v_r, _, _ = pdrop_first_step(*step_args, ("K3",), keeps)
    cos = group_cosines(g_k, g_r)
    log(f"[{tag}] first step, every kernel vs every plain version but K3 (one keep set): loss "
        f"{lk:.6f} vs {lr:.6f} (logged {losses[0]:.6f}); gradient cosines by group: "
        + "; ".join(f"{grp} {c:.6f}, norms {na:.4e} vs {nb:.4e}"
                    for grp, (c, na, nb) in cos.items())
        + f"; {token_drift(v_k, v_r)}")
    del g_r, v_r
    _, g_p, v_p, x_p, _ = pdrop_first_step(*step_args, (), keeps)
    def noise(i, names):
        return torch.Generator(device=DEV).manual_seed(SEED + 20 + i), names

    runs = {"every kernel": (every, None),
            **{f"{label} alone": (on, None) for label, on in BISECTION[family].items()},
            "every kernel but TransV": (tuple(n for n in every if n != "TransV"), None),
            **{f"the plain versions, rounding noise at every kernel's place ({i})":
               ((), noise(i, every)) for i in (1, 2)},
            "the plain versions, rounding noise at K3's place alone": ((), noise(3, ("K3",)))}
    for label, (on, noise_) in runs.items():
        if label == "every kernel":
            l_r, g_r, v_r, x_r = lk, g_k, v_k, x_k
        else:
            l_r, g_r, v_r, x_r, _ = pdrop_first_step(*step_args, on, keeps, noise_)
        log(f"[{tag}] bisection, {label}, against every plain version: loss {l_r:.6f}; "
            + ", ".join(f"{grp} {c:.6f}" for grp, (c, _, _) in group_cosines(g_r, g_p).items())
            + f"; TransV's first inputs: {input_drift(x_r, x_p)}; {token_drift(v_r, v_p)}")
        del g_r, v_r, x_r
    bad = [grp for grp, (c, na, nb) in cos.items() if not c >= PDROP_GRAD_COS]
    for grp, (c, na, nb) in cos.items():
        if grp.startswith("merge") and not (na > 0 and nb > 0):
            raise AssertionError(f"{tag}: no gradient reaches {grp}")
    if bad or not abs(lk - lr) <= 1e-2 * abs(lr):
        raise AssertionError(f"{tag}: the first pdrop training step disagrees with the plain "
                             f"versions ({bad or 'loss'})")
    model.merge_modules = None
    del trainer, start, g_k, g_p, v_k, v_p, x_k, x_p
    torch.cuda.empty_cache()


# the speculative phases: the JAX Generator's n_draft, the new tokens a
# request, and the successor rig's cycle of ids (below every model's hidden
# width) and its new tokens
SPEC_DRAFT = 7
SPEC_NEW = 32
SPEC_COMMIT = 4  # the partial commit's rows in phase 5d (4): three drafts accepted
# phase 5d (4): the largest relative error (norm of the difference over the
# norm) of a cache's K/V rows and Mamba states after a verify or commit
# against decode steps. Both round their bf16 activations at other places;
# phase 5's streamed continuation holds its last SSM state to 2.8e-2 of the
# one-shot prefill's after 12,288 rows (NVIDIA H100 80GB HBM3, 700 W).
SPEC_CACHE_TOL = 0.05
SPEC_LONG_ROWS = 8448  # the 256-frame bucket and a 256-row suffix budget, as in phase 3
RIG_CYCLE = 64
RIG_NEW = 64


def spec_requests(arch):
    """Prompts with repeated n-grams: 40 text tokens whose first 8-token
    phrase comes back twice, alone and with 64 frames after its first 8
    tokens."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 20)
    size = arch.vision.image_size
    phrase = torch.randint(10, 130000, (8,), generator=g, device=DEV).tolist()
    rest = torch.randint(10, 130000, (16,), generator=g, device=DEV).tolist()
    text = phrase + rest[:8] + phrase + rest[8:] + phrase
    pixels = torch.rand(64, size, size, 3, generator=g, device=DEV) * 2 - 1
    return [("text", (text, None)),
            ("64 frames", (text[:8] + [IMAGE_TOKEN] * 64 + text[8:], pixels))]


@contextlib.contextmanager
def plain_versions(family: str):
    """Every kernel of the family's path swapped for its plain version."""
    if family == "qwen2":
        route_qwen2(PLAIN)
    else:
        use_plain_versions()
    try:
        yield
    finally:
        if family == "qwen2":
            route_qwen2(CALLS)
        else:
            use_kernels()


def f32_backbone(model, arch):
    """An f32 copy of the bf16 backbone, the teacher-forcing reference."""
    cls = qwen2_mod.Qwen2Model if arch.llm_family == "qwen2" else NanoModel
    llm32 = cls(arch.llm, torch.float32, DEV)
    llm32.load_state_dict(model.llm_backbone.state_dict())
    return llm32


def near_tie_gate(tag: str, llm32, arch, gen, ids, visual, tokens, first: int) -> float:
    """Phase 5b's gate on tokens that part from the plain loop's at `first`:
    from there every token that is not the argmax of an f32 teacher-forcing
    forward (plain versions) must lie within MISS_GAP_LIMIT of it."""
    with torch.inference_mode(), plain_versions(arch.llm_family):
        rows = forced_logits(llm32, arch, gen, ids + tokens[:-1], visual, len(tokens))
    gaps = [(rows[j].max() - rows[j, tok]).item() for j, tok in enumerate(tokens)]
    worst = max(gaps[first:])
    log(f"[{tag}] the tokens part from the plain loop's at {first}: largest gap below the "
        f"f32 argmax from there {worst:.3e} (limit {MISS_GAP_LIMIT})")
    if worst > MISS_GAP_LIMIT:
        raise AssertionError(f"{tag}: a token {worst:.3e} below the f32 argmax")
    return worst


def spec_launches(tag: str, arch, stats: dict) -> dict:
    """The launches since the last reset_launches against what a speculative
    generate makes: the prefill's own (K1 once a Mamba layer; no K9 on
    either backbone) and, each verify and commit being one continuation,
    two K9 blocks an attention layer and K1 a Mamba layer; a plain round is
    one decode step (K9 a layer on qwen2, none on nano: its decode attention
    is the plain masked one). Raises where they differ; returns them."""
    cfg, runs = arch.llm, stats["verify"] + stats["partial"]
    if arch.llm_family == "qwen2":
        want = {"block_attn": cfg.num_hidden_layers * (2 * runs + stats["plain"])}
    else:
        kinds = cfg.layers_block_type
        want = {"block_attn": 2 * kinds.count("attention") * runs,
                "ssd_fwd": kinds.count("mamba") * (1 + runs)}
    for name, count in want.items():
        if WRAPPERS[name].launches != count:
            raise AssertionError(f"{tag}: {name} launched {WRAPPERS[name].launches} times, "
                                 f"the prefill and the loop's rounds make {count}")
    return want


@contextlib.contextmanager
def successor_rig(model, arch):
    """tests/test_speculative.py:98's successor model at full width: the
    embedding rows of ids below RIG_CYCLE one-hot, lm_head row (i + 1) %
    RIG_CYCLE reading dimension i, every out_proj / o_proj / down_proj
    zeroed, so that the greedy token after i is (i + 1) % RIG_CYCLE. The
    weights come back afterwards."""
    llm = model.llm_backbone
    if llm.lm_head is None:
        raise ValueError("the successor rig needs an untied lm_head")
    saved = []

    def swap(p, new):
        saved.append((p, p.data))
        p.data = new

    eye = torch.eye(RIG_CYCLE, dtype=llm.embeddings.weight.dtype, device=DEV)
    emb = torch.zeros_like(llm.embeddings.weight)
    emb[:RIG_CYCLE, :RIG_CYCLE] = eye
    head = torch.zeros_like(llm.lm_head.weight)
    head[:RIG_CYCLE, :RIG_CYCLE] = eye.roll(1, 0)
    swap(llm.embeddings.weight, emb)
    swap(llm.lm_head.weight, head)
    for name, p in llm.named_parameters():
        if any(f"{proj}." in name for proj in ("out_proj", "o_proj", "down_proj")):
            swap(p, torch.zeros_like(p))
    try:
        yield
    finally:
        for p, data in reversed(saved):
            p.data = data


def clone_cache(tree):
    """A copy of a decode cache whose tensors are new."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: clone_cache(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_cache(v) for v in tree]
    return tree


def cache_rel_err(got, want, rows: int) -> float:
    """The largest relative error (norm of the difference over the norm) of
    got's K/V rows [0, rows) and Mamba states against want's."""
    pairs = []
    for lg, lw in zip(got["layers"], want["layers"]):
        if "k" in lw:
            pairs += [(lg[n][:, :rows], lw[n][:, :rows]) for n in ("k", "v")]
        if "ssm_state" in lw:
            pairs.append((lg["ssm_state"], lw["ssm_state"]))
            pairs += [(lg["conv_state"][n], lw["conv_state"][n]) for n in lw["conv_state"]]
    return max(((g.float() - w.float()).norm() / w.float().norm()).item() for g, w in pairs)


@torch.inference_mode()
def verify_against_steps(model, arch, gen, ids, px, kernel_results: dict, tag: str) -> None:
    """Phase 5d (4): the speculative loop's verify (1 + SPEC_DRAFT rows,
    logits_all) and a partial commit (SPEC_COMMIT rows) on the model's own
    prefill cache of `ids`, against decode steps from copies of it. The rows
    are the greedy tokens of those steps, so the drafts are the model's own.
    Holds each verify row's logits to its step's (cosine 0.999, as phase 5's
    streamed continuation), the caches after the verify and the commit to
    the steps' within SPEC_CACHE_TOL, a step after the commit to the step
    there, and the cache before the verify to itself, bitwise; K1 (nano) and
    K9 on the inputs the verify and the commit gave them against their plain
    versions. Times the K/V copy a continuation makes against the verify."""
    llm, cfg = model.llm_backbone, arch.llm
    cont = forward_continue(arch)
    S = SPEC_DRAFT + 1
    visual = gen.encode_frames(px)
    plan, bucket, pad, ids_arr, gather_idx, seq_idx = gen._plan_prompt(ids, IMAGE_TOKEN)
    first, pre = gen.prefill(ids_arr, gather_idx, seq_idx, visual, pad,
                             bucket + gen.max_new_tokens + gen._spec_margin)
    length, digest = int(pre["length"]), cache_digest(pre)
    seq, rows, stepped = [int(first[0].argmax())], [], clone_cache(pre)
    for i in range(S):
        step, stepped = decode_step(model, arch, torch.tensor([[seq[i]]], device=DEV), stepped)
        rows.append(step[0])
        seq.append(int(step[0].argmax()))
        if i + 1 == SPEC_COMMIT:
            at_commit = clone_cache(stepped)
    embeds = llm.embeddings(torch.tensor([seq[:S]], device=DEV))
    k1 = CallLog(pc_mod.ssd_scan, by_length)
    k9 = CallLog(pc_mod.block_attn_lse, by_transv_shape)
    pc_mod.ssd_scan, pc_mod.block_attn_lse = k1, k9
    try:
        logits, verified = cont(llm, cfg, embeds, pre, pdrop_params=model.merge_modules,
                                logits_all=True, chunk_size=S)
        _, committed = cont(llm, cfg, embeds[:, :SPEC_COMMIT], pre,
                            pdrop_params=model.merge_modules, logits_all=True, chunk_size=S)
    finally:
        pc_mod.ssd_scan, pc_mod.block_attn_lse = k1.fn, k9.fn
    cos = [cosine(logits[0, i], rows[i]) for i in range(S)]
    same = sum(int(logits[0, i].argmax()) == int(rows[i].argmax()) for i in range(S))
    err_v = cache_rel_err(verified, stepped, length + S)
    err_c = cache_rel_err(committed, at_commit, length + SPEC_COMMIT)
    after, _ = decode_step(model, arch, torch.tensor([[seq[SPEC_COMMIT]]], device=DEV),
                           committed)
    cos_after = cosine(after[0], rows[SPEC_COMMIT])
    log(f"[{tag} verify] {S} rows after {length} on the prefill cache against {S} decode "
        f"steps: logits cosine per row {', '.join(f'{c:.6f}' for c in cos)}, argmax equal "
        f"on {same} of {S}; cache relative error after the verify {err_v:.3e}, after the "
        f"{SPEC_COMMIT}-row commit {err_c:.3e} (limit {SPEC_CACHE_TOL}); the step after the "
        f"commit, cosine {cos_after:.6f}")
    if cache_digest(pre) != digest:
        raise AssertionError(f"{tag} verify: the continuations wrote the cache before them")
    if min(cos + [cos_after]) <= 0.999 or max(err_v, err_c) > SPEC_CACHE_TOL:
        raise AssertionError(f"{tag} verify: the verify or the commit parts from the steps")
    if arch.llm_family != "qwen2":
        h0 = max(kw["initial_state"].abs().max().item() for _, kw in k1.calls.values())
        log(f"[{tag} verify] K1 from the carried states (|h0| max {h0:.3e}) at rows "
            f"{sorted(k1.calls)}")
        if sorted(k1.calls) != [SPEC_COMMIT, S]:
            raise AssertionError(f"{tag} verify: K1 ran at {sorted(k1.calls)} rows")
        compare_logged("ssd_fwd", k1.calls, f"{tag} verify", kernel_results)
    compare_logged("block_attn", k9.calls, f"{tag} verify", kernel_results)
    verify_ms = timed_ms(lambda: cont(llm, cfg, embeds, pre, pdrop_params=model.merge_modules,
                                      logits_all=True, chunk_size=S))
    kv = [lc[n] for lc in pre["layers"] for n in ("k", "v") if n in lc]
    # and the same buffers at SPEC_LONG_ROWS rows
    kv_long = [t.new_empty((t.shape[0], SPEC_LONG_ROWS) + t.shape[2:]) for t in kv]
    for rows, bufs in ((kv[0].shape[1], kv), (SPEC_LONG_ROWS, kv_long)):
        copy_ms = timed_ms(lambda: [t.clone() for t in bufs])
        moved = 2 * nbytes(*bufs)
        log(f"[{tag} verify] the K/V copy a continuation makes of a {rows:,}-row cache: "
            f"{moved / 2 ** 20:.1f} MiB moved in {copy_ms:.4f} ms (bound "
            f"{moved / PEAK_BYTES * 1e3:.4f}), against the verify's {verify_ms:.4f} ms on "
            f"this prompt (events, host gaps included): {copy_ms / verify_ms:.2%}")


def phase_speculative(model, arch, smi: str, kernel_results: dict, tag: str) -> None:
    """N-gram speculative decoding (models/speculative.py, n_draft
    SPEC_DRAFT) on `model`: (1) the text and 64-frame prompts of
    spec_requests, SPEC_NEW tokens, plain and speculative greedy loops in
    one call (tokens/s of each; the speculative tokens the plain ones or,
    where they part, within MISS_GAP_LIMIT of the f32 teacher-forcing
    argmax: the verify runs K1 and K9 over 8 rows where a step runs one, so
    bf16 near-ties may part); the launches exactly spec_launches'; (2) a speculative question on a PrefixState of 8 tokens
    + 64 frames: the prefix's SHA-256 unchanged; (3) the successor rig:
    every draft accepted, the cycle's tokens, tokens/s against the plain
    loop; then with one wrong id in the prompt's cycle: a partial commit,
    the same tokens; (4) verify_against_steps on the 64-frame prompt. The
    launches of (1) and (3) add to the kernels' records."""
    for var in FUSIONS:
        os.environ[var] = "0"
    kw = dict(terminator_ids=[], max_new_tokens=SPEC_NEW)
    plain = Generator(model, arch, **kw)
    spec = Generator(model, arch, speculative="ngram", n_draft=SPEC_DRAFT, **kw)
    llm32 = None
    requests = spec_requests(arch)
    launched = {}
    for label, (ids, px) in requests:
        base = plain.generate(ids, pixels=px, image_token_id=IMAGE_TOKEN)
        reset_launches()
        out = spec.generate(ids, pixels=px, image_token_id=IMAGE_TOKEN)
        st = out.spec_stats
        want = spec_launches(f"{tag} {label}", arch, st)
        for name, count in want.items():
            launched[name] = launched.get(name, 0) + count
        if not torch.isfinite(out.first_logits).all():
            raise AssertionError(f"{tag} {label}: non-finite first logits")
        tps_p = (base.num_generated - 1) / base.decode_s
        tps_s = (out.num_generated - 1) / out.decode_s
        log(f"[{tag}] {label}: {out.num_generated} tokens; drafts proposed {st['proposed']}, "
            f"accepted {st['accepted']}; verify passes {st['verify']}, partial commits "
            f"{st['partial']}, plain steps {st['plain']}; decode {tps_s:.2f} tok/s "
            f"speculative, {tps_p:.2f} plain ({tps_s / tps_p:.2f}x); launches {want}; {smi}")
        log(f"[{tag}] {label}: tokens speculative {out.token_ids.tolist()}, plain "
            f"{base.token_ids.tolist()}")
        tokens, ref = out.token_ids.tolist(), base.token_ids.tolist()
        first = next((j for j, (a, b) in enumerate(zip(tokens, ref)) if a != b), None)
        if first is not None:
            llm32 = llm32 if llm32 is not None else f32_backbone(model, arch)
            with torch.inference_mode():
                visual = plain.encode_frames(px) if px is not None else None
            near_tie_gate(f"{tag} {label}", llm32, arch, plain, ids, visual, tokens, first)

    # (2) a speculative question on a cached prefix
    text, px = requests[0][1][0], requests[1][1][1]
    prefix_ids, question = text[:8] + [IMAGE_TOKEN] * 64, text[8:]
    state = spec.prefill_prefix(prefix_ids, pixels=px, image_token_id=IMAGE_TOKEN,
                                suffix_budget=64)
    before = cache_digest(state.cache)
    o = spec.generate(question, prefix=state)
    after = cache_digest(state.cache)
    p = plain.generate(question, prefix=state)
    log(f"[{tag} prefix] a {len(question)}-token question on 8 tokens + 64 frames: "
        f"speculative {o.token_ids.tolist()} ({o.spec_stats}), plain {p.token_ids.tolist()}; "
        f"prefix SHA-256 {before[:16]} before, {after[:16]} after")
    if before != after or cache_digest(state.cache) != before:
        raise AssertionError(f"{tag} prefix: the speculative question wrote the prefix cache")
    first = next((j for j, (a, b) in enumerate(zip(o.token_ids.tolist(),
                                                   p.token_ids.tolist())) if a != b), None)
    if first is not None:
        llm32 = llm32 if llm32 is not None else f32_backbone(model, arch)
        with torch.inference_mode():
            visual = plain.encode_frames(px)
        near_tie_gate(f"{tag} prefix", llm32, arch, plain, prefix_ids + question, visual,
                      o.token_ids.tolist(), first)
    del state, llm32
    torch.cuda.empty_cache()

    # (3) the successor rig: the loop's best case, then one wrong id in the
    # history (a draft rejected where the cycle passes it: a partial commit)
    rig_kw = dict(terminator_ids=[], max_new_tokens=RIG_NEW, pad_token_id=RIG_CYCLE)
    prompt = list(range(RIG_CYCLE)) + list(range(8))
    wrong = prompt[:12] + [RIG_CYCLE + 1] + prompt[13:]
    cycle = [(8 + t) % RIG_CYCLE for t in range(RIG_NEW)]
    with successor_rig(model, arch):
        plain_rig = Generator(model, arch, **rig_kw)
        spec_rig = Generator(model, arch, speculative="ngram", n_draft=SPEC_DRAFT, **rig_kw)
        plain_rig.generate(prompt)  # warm
        runs = {"plain": plain_rig.generate(prompt)}
        spec_rig.generate(prompt)
        for label, ids in (("speculative", prompt), ("one wrong id", wrong)):
            reset_launches()
            runs[label] = spec_rig.generate(ids)
            for name, count in spec_launches(f"{tag} rig, {label}", arch,
                                             runs[label].spec_stats).items():
                launched[name] += count
    for name, count in launched.items():
        kernel_results[name]["launches"] += count
    tps = {k: (o.num_generated - 1) / o.decode_s for k, o in runs.items()}
    for label in ("speculative", "one wrong id"):
        st = runs[label].spec_stats
        log(f"[{tag} rig] successor rig, cycle of {RIG_CYCLE} ids, {RIG_NEW} tokens, {label}: "
            f"drafts proposed {st['proposed']}, accepted {st['accepted']}, verify passes "
            f"{st['verify']}, partial commits {st['partial']}, plain steps {st['plain']}; "
            f"decode {tps[label]:.2f} tok/s, plain {tps['plain']:.2f} "
            f"({tps[label] / tps['plain']:.2f}x); {smi}")
    for name, o in runs.items():
        if o.token_ids.tolist() != cycle:
            raise AssertionError(f"{tag} rig: {name} tokens {o.token_ids.tolist()}")
    st, st_w = runs["speculative"].spec_stats, runs["one wrong id"].spec_stats
    if not (st["verify"] > 0 and st["accepted"] == st["proposed"] and st["partial"] == 0):
        raise AssertionError(f"{tag} rig: not every draft accepted: {st}")
    if not st_w["partial"] > 0:
        raise AssertionError(f"{tag} rig: the wrong id made no partial commit: {st_w}")

    # (4) a verify and a commit on the model's own cache against decode steps
    verify_against_steps(model, arch, spec, *requests[1][1], kernel_results, tag)


def phase_qwen2_training(model, arch, kernel_results: dict) -> None:
    """10(f): LoRA (rank 8, alpha 16) on qwen2.5-7b with the projector
    unfrozen, through Trainer.train, as phase 6 trains the 9B: four steps on
    one repeated row of 64 frames + 40 text tokens (1,064 tokens), one at
    256 frames (4,136). Every loss and grad norm finite, the 4th loss below
    the 1st, K2 and K2-bwd launched (K2-bwd at pack 1); K2-bwd against its
    plain version on the inputs and cotangent the first step gave one layer;
    the first step's LoRA gradient against a run with the plain K2 and K2-bwd
    (route_qwen2), cosine above 0.99."""
    add_lora(model, rank=8, alpha=16.0,
             generator=torch.Generator(device=DEV).manual_seed(SEED + 2))
    g = torch.Generator(device=DEV).manual_seed(SEED + 3)
    short, long_ = training_row(arch, 64, g), training_row(arch, 256, g)
    opt_cfg = OptimConfig(learning_rate=1e-3, schedule="constant", max_grad_norm=1.0)
    cfg = arch.llm
    with tempfile.TemporaryDirectory() as run_dir:
        tcfg = TrainerConfig(run_dir=run_dir, max_steps=5, log_every=1, save_every=10**9,
                             lora=True, trainable_modules="projector", remat="full",
                             resume=False)
        trainer = Trainer(arch, model, opt_cfg, tcfg, device=DEV)
        n_lora = sum(p.numel() for n, p in trainer.opt.params.items() if ".lora_" in n)
        log(f"[qwen2 train] LoRA rank 8 on {sum('.lora_a' in n for n in trainer.opt.params)} "
            f"linears: {n_lora / 1e6:.2f} M factor parameters, "
            f"{sum(p.numel() for p in trainer.opt.params.values()) / 1e6:.2f} M trainable "
            f"with the projector; Hq/Hkv {cfg.num_attention_heads}/{cfg.num_key_value_heads}, "
            f"pack {gqa_pack(cfg.num_attention_heads, cfg.num_key_value_heads)}")
        start = {n: p.detach().clone() for n, p in trainer.opt.params.items()}
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with logging_calls(TRAINING_PLACES["qwen2"]) as logs:
            trainer.train([short] * 4)
            logs["flash_fwd"].armed = False
            trainer.train([long_])
        launches = {name: w.launches for name, w in WRAPPERS.items()}
    log(f"[qwen2 train] launches during the five steps: {launches}")
    for h, cb in zip(trainer.history, [short] * 4 + [long_]):
        tokens = cb.plan.fused_len * cb.batch["input_ids"].shape[0]
        log(f"[qwen2 train] step {h['step']}: {tokens} tokens, loss {h['loss']:.4f}, grad norm "
            f"{h['grad_norm']:.4f}, {h['seconds']:.3f} s, {tokens / h['seconds']:.1f} trained "
            f"tokens/s, peak memory {h.get('max_memory_gib', math.nan):.2f} GiB")
    losses = [h["loss"] for h in trainer.history]
    norms = [h["grad_norm"] for h in trainer.history]
    if len(losses) != 5 or not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError(f"qwen2 training losses {losses}, grad norms {norms}")
    if not losses[3] < losses[0]:
        raise AssertionError(f"qwen2: the 4th loss {losses[3]} is not below the 1st {losses[0]}")
    for name in ("flash_fwd", "flash_bwd", "vit_attn_qkv"):
        if launches[name] == 0:
            raise AssertionError(f"qwen2 training: {name} was never launched")
    for name in ("flash_fwd", "flash_bwd"):
        kernel_results[name]["launches"] += launches[name]

    check_training_calls("qwen2 train", logs, kernel_results)
    del logs
    torch.cuda.empty_cache()

    # the first step's gradient again from the same start, kernels vs plain versions
    with torch.no_grad():
        for n, p in trainer.opt.params.items():
            p.copy_(start[n])
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in short.batch.items()}
    m_k, g_k = grad_step(model, arch, trainer.opt.params, batch, short.plan)
    with plain_versions("qwen2"):
        m_p, g_p = grad_step(model, arch, trainer.opt.params, batch, short.plan)
    names = [n for n in g_k if ".lora_" in n]
    vk = torch.cat([g_k[n].flatten() for n in names])
    vp = torch.cat([g_p[n].flatten() for n in names])
    cos = torch.nn.functional.cosine_similarity(vk, vp, dim=0).item()
    lk, lp = float(m_k["loss"]), float(m_p["loss"])
    log(f"[qwen2 train] first step, kernels vs plain versions: loss {lk:.6f} vs {lp:.6f} "
        f"(logged {losses[0]:.6f}); LoRA gradient cosine {cos:.6f} (limit 0.99), norms "
        f"{vk.norm().item():.4e} vs {vp.norm().item():.4e}")
    # bf16 activations and gradients through 28 layers round at other places
    if not (abs(lk - lp) <= 1e-2 * abs(lp) and cos > 0.99):
        raise AssertionError("qwen2: the first training step disagrees with the plain versions")
    arch_p = dataclasses.replace(arch, llm=dataclasses.replace(cfg, **QWEN2_PDROP))
    phase_pdrop_training(model, arch, arch_p, kernel_results, "qwen2 train pdrop",
                         trainer.history)


def set_fusions(on: bool) -> None:
    for var in FUSIONS:
        os.environ[var] = "1" if on else "0"


def phase_int8_serving(arch, smi: str, kernel_results: dict, bf16: dict,
                       profile: bool = False) -> None:
    t0 = time.perf_counter()
    model = init_vlm_params(arch, torch.Generator(device=DEV).manual_seed(SEED),
                            dtype=torch.bfloat16)
    # W8A8 as bench.py serves it: the ViT and the backbone (its lm_head by an
    # f32 dequant), the projector in bf16
    quantize_params_int8(model.vision_backbone)
    quantize_params_int8(model.llm_backbone)
    g = torch.Generator(device=DEV).manual_seed(SEED + 4)
    size = arch.vision.image_size
    clip = torch.rand(64, size, size, 3, generator=g, device=DEV) * 2 - 1
    calibrate_act_scales(lambda m, px: vit_mod.vit_forward(m, arch.vision, px),
                         model.vision_backbone, [clip])
    with torch.no_grad():
        emb = encode_visual(model, arch, clip)
    calibrate_act_scales(
        lambda m, e: nano_forward(m, arch.llm, inputs_embeds=e, logits_to_keep=1),
        model.llm_backbone, [emb.reshape(1, -1, emb.shape[-1])])
    fuse_decode_in_proj(model.llm_backbone)
    del clip, emb
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    int8 = [m for m in model.modules() if isinstance(m, Int8Linear)]
    log(f"[int8] quantized {len(int8)} linears ({sum(m.act_inv is not None for m in int8)} "
        f"calibrated on one 64-frame clip), in_proj fused; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB, {time.perf_counter() - t0:.1f} s")

    gen = Generator(model, arch, terminator_ids=[], max_new_tokens=MAX_NEW)
    requests = make_requests(arch)
    set_fusions(False)
    off = serve(gen, requests, "int8")
    set_fusions(True)
    try:
        captures = capture_all()
        reset_launches()
        on = serve(gen, requests, "int8 fused", captures)
        launches = {name: w.launches for name, w in WRAPPERS.items()}
        use_kernels()
        log(f"[int8 fused] launches during the requests: {launches}")
        n_mamba = arch.llm.layers_block_type.count("mamba")
        steps = sum(o.num_generated - 1 for o in on.values())
        clips = sum(-(-(0 if px is None else px.shape[0]) // gen.clip_size)
                    for _, (_, px) in requests)
        want = {"ssd_conv_fwd": n_mamba * len(requests), "decode_fused": n_mamba * steps,
                "layernorm": 2 * len(model.vision_backbone.layers) * clips, "ssd_fwd": 0}
        for name, count in want.items():
            if launches[name] != count:
                raise AssertionError(f"{name}: {launches[name]} launches, the fused path "
                                     f"makes {count}")
        for name in FUSED:
            kernel_results[name]["launches"] = launches[name]
        compare_captured(captures, FUSED, "int8 fused", kernel_results)
        del captures
        torch.cuda.empty_cache()
        for label, _ in requests:
            logits_agree(f"int8 {label}, fused vs unfused", on[label].first_logits,
                         off[label].first_logits, 0.98)
        check_against_plain_run(gen, requests, on, "int8 fused", 0.98)
        # where the runs part: the tower's features (before ToMe, whose merge
        # choices are discrete) and the visual tokens, on 16 of the 64 frames
        px = requests[1][1][1][:16]
        feats = {"fused": tower(model, arch, px)}
        use_plain_versions()
        try:
            feats["plain versions"] = tower(model, arch, px)
        finally:
            use_kernels()
        set_fusions(False)
        feats["unfused"] = tower(model, arch, px)
        for (fa, ta), (fb, tb), what in (
                (feats["fused"], feats["unfused"], "fused vs unfused"),
                (feats["fused"], feats["plain versions"], "fused kernels vs plain versions"),
                (feats["unfused"], bf16["tower"], "int8 unfused vs the bf16 model")):
            log(f"[int8] 16 frames, {what}: tower features cosine {cosine(fa, fb):.6f}, "
                f"visual tokens cosine {cosine(ta, tb):.6f}")
        del feats
    finally:
        set_fusions(False)
    for label, _ in requests:
        log(f"[int8] {label}: first-token logits, int8 unfused vs the bf16 model: cosine "
            f"{cosine(off[label].first_logits, bf16['logits'][label]):.6f}")
    ab_rounds(gen, requests)
    int8_pdrop_mix(model, arch, smi, kernel_results)
    if profile:
        ids, px = requests[2][1]
        for on in (False, True):
            set_fusions(on)
            try:
                profile_call(f"int8 256-frame request, fusions {'on' if on else 'off'}",
                             lambda: gen.generate(ids, pixels=px, image_token_id=IMAGE_TOKEN))
            finally:
                set_fusions(False)


def int8_pdrop_mix(model, arch, smi: str, kernel_results: dict) -> None:
    """The JAX package's pdrop serving mix (bench_all.py:348-410) on the W8A8
    model with the fusions on: the merge modules attached (PDROP), quantized
    and calibrated on one request's pdrop prefill; 8 requests of 4 text
    tokens, 64 frames and 20 text tokens, 16 new tokens each, through
    ServingEngine(pdrop_frames=64) with 8 slots, twice (the second run is
    the one to read). Every request served; K5, K7, K8 and K9 launched."""
    arch_p = pdrop_arch(arch)
    attach_merge_modules(model, arch_p)
    quantize_params_int8(model.merge_modules)
    g = torch.Generator(device=DEV).manual_seed(SEED + 10)
    size = arch.vision.image_size

    def mix(base):
        out = []
        for i in range(8):
            text = torch.randint(3, 2000, (24,), generator=g, device=DEV).tolist()
            out.append(Request(request_id=base + i,
                               input_ids=text[:4] + [IMAGE_TOKEN] * 64 + text[4:],
                               pixels=torch.rand(64, size, size, 3, generator=g,
                                                 device=DEV) * 2 - 1,
                               image_token_id=IMAGE_TOKEN, max_new_tokens=MAX_NEW))
        return out

    gen = Generator(model, arch_p, terminator_ids=[], max_new_tokens=MAX_NEW)
    first = mix(100)[0]
    calibrate_act_scales(lambda m, r: pdrop_prefill(gen, r.input_ids, r.pixels),
                         model.merge_modules, [first])
    n_cal = sum(isinstance(m, Int8Linear) and m.act_inv is not None
                for m in model.merge_modules.modules())
    set_fusions(True)
    try:
        for run in ("first", "second"):
            eng = ServingEngine(model, arch_p, terminator_ids=[], num_slots=8, max_len=4096,
                                steps_per_sync=4, pdrop_frames=64)
            reqs = mix(0 if run == "second" else 1000)
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = eng.run(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {name: w.launches for name, w in WRAPPERS.items()}
            bad = [(r.request_id, r.error) for r in out if r.error or not r.done]
            if bad:
                raise AssertionError(f"int8 pdrop mix: requests failed {bad}")
            n_tok = sum(len(r.output_ids) for r in out)
            log(f"[int8 pdrop] {run} run, W8A8 with the fusions on ({n_cal} TransV linears "
                f"calibrated): {len(out)} requests x 64 frames, {n_tok} output tokens in "
                f"{wall:.3f} s, {n_tok / wall:.2f} output tokens/s, {len(out) / wall:.3f} "
                f"requests/s; launches {launches}; {smi}")
            for name in ("ssd_conv_fwd", "decode_fused", "layernorm", "block_attn"):
                if launches[name] == 0:
                    raise AssertionError(f"int8 pdrop mix: {name} was never launched")
            del eng
    finally:
        set_fusions(False)
    model.merge_modules = None
    torch.cuda.empty_cache()


@torch.no_grad()
def tower(model, arch, px):
    """(the ViT's penultimate features, the visual tokens after ToMe and the
    projector) of some frames."""
    return vit_mod.vit_forward(model.vision_backbone, arch.vision, px), \
        encode_visual(model, arch, px)


def ab_rounds(gen, requests) -> None:
    """The fusions off and on in turns (off, on, on, off) on the text and the
    256-frame requests, within this one call on this one card."""
    for idx in (0, 2):
        label, (ids, px) = requests[idx]
        for on in (False, True, True, False):
            set_fusions(on)
            try:
                o = gen.generate(ids, pixels=px, image_token_id=IMAGE_TOKEN)
            finally:
                set_fusions(False)
            log(f"[int8 A/B] {label}, fusions {'on ' if on else 'off'}: encode "
                f"{o.encode_s:.3f} s, prefill {o.prefill_s:.3f} s, decode "
                f"{(o.num_generated - 1) / o.decode_s:.2f} tok/s")


def phase_tower_serving(vision_id: str, n_requests: int, tag: str,
                        kernel_results: dict, int8: bool = False) -> dict:
    """Serve `n_requests` of the three requests with another vision tower and
    nano-9b-v2 at full width and depth (random bf16 weights from the seed):
    every encode chunk must launch the tower's attention kernel once per
    block (K6 for InternVideo2, K3 for the ViTs) and the other one never. The
    kernel is held against its plain version on the armed 64-frame request's
    first call, and that request's first logits against the plain versions'.
    With `int8`, the model is then quantized W8A8 as the int8 phase does
    (tower and backbone, calibrated on the 64-frame request's frames, the
    in_proj fused) and serves the 64-frame request again, with the int8
    phase's agreement check against the plain versions. Returns the launch
    counts of the bf16 requests."""
    arch = build_arch(VLMConfig(vision_backbone_id=vision_id))
    t0 = time.perf_counter()
    model = init_vlm_params(arch, torch.Generator(device=DEV).manual_seed(SEED),
                            dtype=torch.bfloat16)
    torch.cuda.synchronize()
    blocks = {"vit_attn": 0, "vit_attn_qkv": 0}
    for key, fam, _ in arch.towers():
        blocks["vit_attn" if fam == "internvideo2" else "vit_attn_qkv"] += len(
            model.tower(key)[0].layers)
    n_vis = sum(p.numel() for p in model.vision_backbone.parameters())
    log(f"[{tag}] {vision_id} + nano-9b-v2: {n_vis / 1e9:.3f} B tower params, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.2f} B in all, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB, init {time.perf_counter() - t0:.1f} s; "
        f"{arch.tokens_per_frame} tokens a frame; attention blocks per chunk {blocks}")
    gen = Generator(model, arch, terminator_ids=[], max_new_tokens=MAX_NEW)
    requests = make_requests(arch)[:n_requests]
    captures = capture_all()
    reset_launches()
    outs = serve(gen, requests, tag, captures)
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    use_kernels()
    log(f"[{tag}] launches during the requests: {launches}")
    chunks = sum(-(-px.shape[0] // gen.clip_size) for _, (_, px) in requests if px is not None)
    for name, per_chunk in blocks.items():
        if launches[name] != per_chunk * chunks:
            raise AssertionError(f"{tag}: {name} launched {launches[name]} times, "
                                 f"{chunks} encode chunks make {per_chunk * chunks}")
    for name in ("ssd_fwd", "flash_fwd"):
        if launches[name] == 0:
            raise AssertionError(f"{tag}: {name} was never launched")
    compare_captured(captures, [name for name, k in blocks.items() if k], tag, kernel_results)
    del captures
    torch.cuda.empty_cache()
    check_against_plain_run(gen, requests, outs, tag)
    if int8:
        int8_tower_request(model, arch, gen, requests, outs, blocks, tag)
    return launches


def int8_tower_request(model, arch, gen, requests, bf16_outs, blocks, tag: str) -> None:
    """W8A8 on a single-tower model, as phase_int8_serving makes it, then
    the 64-frame request: the tower's attention kernel once per block and
    encode chunk, every tower linear int8 under the tower's switch, the first
    logits against the plain versions (cosine 0.98, the int8 limit)."""
    t0 = time.perf_counter()
    cfg, clip = arch.vision, requests[1][1][1]
    tower_fwd = (iv2_mod.encode_frames_iv2 if arch.vision_family == "internvideo2"
                 else vit_mod.vit_forward)
    quantize_params_int8(model.vision_backbone)
    quantize_params_int8(model.llm_backbone)
    calibrate_act_scales(lambda m, px: tower_fwd(m, cfg, px), model.vision_backbone, [clip])
    with torch.no_grad():
        emb = encode_visual(model, arch, clip)
    calibrate_act_scales(
        lambda m, e: nano_forward(m, arch.llm, inputs_embeds=e, logits_to_keep=1),
        model.llm_backbone, [emb.reshape(1, -1, emb.shape[-1])])
    fuse_decode_in_proj(model.llm_backbone)
    del emb
    torch.cuda.empty_cache()
    tower_int8 = [m for m in model.vision_backbone.modules() if isinstance(m, Int8Linear)]
    if not tower_int8 or any(m.switch != "TIMEVIPER_VIT_INT8_MXU" or m.act_inv is None
                             for m in tower_int8):
        raise AssertionError(f"{tag} int8: the tower's linears are not all calibrated int8 "
                             "under TIMEVIPER_VIT_INT8_MXU")
    log(f"[{tag} int8] quantized {len(tower_int8)} tower linears (the tubelet embedding "
        f"too: {isinstance(getattr(model.vision_backbone, 'patch_embed', None), Int8Linear)}) "
        f"and {sum(isinstance(m, Int8Linear) for m in model.llm_backbone.modules())} backbone "
        f"linears, calibrated on the 64 frames; {torch.cuda.memory_allocated() / 2**30:.1f} "
        f"GiB, {time.perf_counter() - t0:.1f} s")
    reset_launches()
    outs = serve(gen, requests[1:2], f"{tag} int8")
    chunks = -(-clip.shape[0] // gen.clip_size)
    for name, per_chunk in blocks.items():
        got = WRAPPERS[name].launches
        if got != per_chunk * chunks:
            raise AssertionError(f"{tag} int8: {name} launched {got} times, not "
                                 f"{per_chunk * chunks}")
    check_against_plain_run(gen, requests, outs, f"{tag} int8", 0.98)
    log(f"[{tag} int8] 64 frames: first-token logits, int8 vs the bf16 model: cosine "
        f"{cosine(outs['64 frames'].first_logits, bf16_outs['64 frames'].first_logits):.6f}")

# phase 10: the qwen2 backbone. Where each kernel of its path is called: K2
# in the prefill's attention, K9 in the Generator's decode step, in the
# continuation's two suffix blocks and in TransV's cross-attention, K3 in
# the SigLIP tower
QWEN2_ID = "qwen2.5-7b-instruct"
QWEN2_PDROP = dict(use_pdrop=True, pdrop_type="uni_14_0.8-attn_21_0.6",
                   merge_module="CrossAttention")  # docs/USAGE.md's qwen2 setting
QWEN2_ROUTES = {"flash_fwd": ((qwen2_mod, "flash_attention"),),
                "block_attn": ((qwen2_mod, "block_attn_lse"), (pc_mod, "block_attn_lse"),
                               (attn_mod, "block_attn_lse")),
                "vit_attn_qkv": ((vit_mod, "encoder_attention_qkv"),)}
QWEN2_PATH = tuple(QWEN2_ROUTES)


def route_qwen2(table: dict) -> None:
    """Point the qwen2 path's calls of each kernel at table[name] (CALLS or
    PLAIN)."""
    for name, places in QWEN2_ROUTES.items():
        for mod, attr in places:
            setattr(mod, attr, table[name])


def qwen2_launches(tag: str, want: dict, need=QWEN2_PATH) -> dict:
    """The launch counts since the last reset_launches; each kernel in `need`
    must have launched, and exactly want[name] times where given."""
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    log(f"[{tag}] launches: {launches}")
    for name in need:
        if launches[name] == 0 or launches[name] != want.get(name, launches[name]):
            raise AssertionError(f"{tag}: {name} launched {launches[name]} times, want "
                                 f"{want.get(name, 'some')}")
    return launches


def phase_qwen2(smi: str, kernel_results: dict) -> None:
    """10: qwen2.5-7b-instruct + siglip-vit-so400m-384px + tome_mlp-16 at full
    width and depth (28 layers, GQA 28 / 4), random bf16 weights from the
    seed: (a) the three requests through Generator.generate with the kernels
    and with every plain version (first-logit cosine 0.99; K2 28 launches a
    prefill, K9 28 a decode step); (b) a 40-token question on a cached prefix
    of 8 tokens + 256 frames against the whole prompt; (c) pdrop with TransV
    (QWEN2_PDROP, tanh(alpha) 0.5, q_proj tempered as phase 5c tempers it):
    the 64- and 256-frame requests, the rows after each stage, each layer's
    kv_len, the first logits on one keep set against the plain versions, and
    the attn keep set against theirs (within 2 points of what one input ulp
    moves the plain versions' own set, or of 99%); (d) ServingEngine with 4
    slots: a text request and four of 64 frames, each the offline
    Generator's tokens or, where they part, within MISS_GAP_LIMIT of an f32
    teacher-forcing argmax. The launches of (a) add to the kernels'
    records."""
    arch = build_arch(VLMConfig(llm_backbone_id=QWEN2_ID))
    t0 = time.perf_counter()
    model = init_vlm_params(arch, torch.Generator(device=DEV).manual_seed(SEED),
                            dtype=torch.bfloat16)
    torch.cuda.synchronize()
    cfg = arch.llm
    log(f"[qwen2] {QWEN2_ID}: {sum(p.numel() for p in model.llm_backbone.parameters()) / 1e9:.2f}"
        f" B backbone params ({cfg.num_hidden_layers} layers, Hq/Hkv "
        f"{cfg.num_attention_heads}/{cfg.num_key_value_heads}, pack "
        f"{gqa_pack(cfg.num_attention_heads, cfg.num_key_value_heads)}), "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB, init {time.perf_counter() - t0:.1f} s")
    for var in FUSIONS:
        os.environ[var] = "0"
    gen = Generator(model, arch, terminator_ids=[], max_new_tokens=MAX_NEW)
    requests = make_requests(arch)

    # (a) the three requests, with the kernels and with the plain versions
    route_qwen2(CALLS)
    reset_launches()
    outs = serve(gen, requests, "qwen2")
    steps = sum(o.num_generated - 1 for o in outs.values())
    launches = qwen2_launches("qwen2", {"flash_fwd": 3 * cfg.num_hidden_layers,
                                        "block_attn": steps * cfg.num_hidden_layers})
    for name in QWEN2_PATH:
        kernel_results[name]["launches"] += launches[name]
    route_qwen2(PLAIN)
    try:
        plain = serve(gen, requests, "qwen2 plain")
    finally:
        route_qwen2(CALLS)
    for label, o in outs.items():
        log(f"[qwen2] {label}: ids kernels {o.token_ids.tolist()} plain "
            f"{plain[label].token_ids.tolist()}")
        logits_agree(f"qwen2 {label}, kernels vs plain versions", o.first_logits,
                     plain[label].first_logits)
    del plain
    torch.cuda.empty_cache()

    # (b) a question on a cached 256-frame prefix, against the whole prompt
    g = torch.Generator(device=DEV).manual_seed(SEED + 13)
    size = arch.vision.image_size
    text = torch.randint(10, 130000, (48,), generator=g, device=DEV).tolist()
    frames = torch.rand(256, size, size, 3, generator=g, device=DEV) * 2 - 1
    prefix_ids, question = text[:8] + [IMAGE_TOKEN] * 256, text[8:]
    t0 = time.perf_counter()
    state = gen.prefill_prefix(prefix_ids, pixels=frames, image_token_id=IMAGE_TOKEN,
                               suffix_budget=512)
    torch.cuda.synchronize()
    reset_launches()
    o = gen.generate(question, prefix=state)
    # the continuation: two K9 blocks a layer; the decode: one a layer and step
    qwen2_launches("qwen2 prefix", {"block_attn": (o.num_generated + 1) * cfg.num_hidden_layers},
                   need=("block_attn",))
    whole = gen.generate(prefix_ids + question, pixels=frames, image_token_id=IMAGE_TOKEN)
    log(f"[qwen2 prefix] prefill_prefix of 8 tokens + 256 frames: bucket {state.bucket}, pad "
        f"{state.pad}, {time.perf_counter() - t0:.3f} s with the encode; 40-token question: "
        f"continuation {o.prefill_s:.3f} s, decode {(o.num_generated - 1) / o.decode_s:.2f} "
        f"tok/s, tokens {o.token_ids.tolist()}; the whole prompt's {whole.token_ids.tolist()}")
    logits_agree("qwen2 prefix, question vs the whole prompt", o.first_logits,
                 whole.first_logits)
    del state, frames, whole
    torch.cuda.empty_cache()

    # (c) pdrop with TransV
    arch_p = dataclasses.replace(arch, llm=dataclasses.replace(cfg, **QWEN2_PDROP))
    attach_merge_modules(model, arch_p)
    gen_p = Generator(model, arch_p, terminator_ids=[], max_new_tokens=MAX_NEW)
    factors = temper_transv(model, gen_p, *requests[1][1])
    log(f"[qwen2 pdrop] {arch_p.llm.pdrop_type}: TransV q_proj rescaled by "
        f"{', '.join(f'{f:.3e}' for f in factors)} (stage order)")
    for label, (ids, px) in requests[1:]:
        reset_launches()
        o = gen_p.generate(ids, pixels=px, image_token_id=IMAGE_TOKEN, use_pdrop=True)
        qwen2_launches(f"qwen2 pdrop {label}", {})
        with torch.inference_mode():
            visual = gen_p.encode_frames(px)
            nudged = (visual.view(torch.int16) + 1).view(torch.bfloat16)  # one ulp up
        logits, cache, bucket, stages = pdrop_prefill(gen_p, ids, px, visual=visual)
        lens = [lc["kv_len"] for lc in cache["layers"]]
        rows = [bucket]
        for drop in pdrop_mod.pdrop_drop_counts(arch_p.llm, plan_visual(gen_p, ids)):
            rows.append(rows[-1] - drop)
        want = [rows[sum(st.layer <= i for st in arch_p.llm.pdrop_stages)]
                for i in range(cfg.num_hidden_layers)]
        if stages.lengths != list(zip(rows, rows[1:])) or lens != want:
            raise AssertionError(f"qwen2 pdrop rows {stages.lengths}, kv_len {lens}; want "
                                 f"{rows}, {want}")
        transv_rows = [c["k"].shape[0] for c in cache["ca_kv"]]
        del cache
        # the plain versions on the kernels' keep set (the first logits), on
        # their own (the overlap), and on their own with every visual feature
        # one ulp up: how far rounding alone moves the keep set
        route_qwen2(PLAIN)
        try:
            ref, _, _, _ = pdrop_prefill(gen_p, ids, px, replay=stages.keeps, visual=visual)
            _, _, _, ref_stages = pdrop_prefill(gen_p, ids, px, visual=visual)
            _, _, _, moved_stages = pdrop_prefill(gen_p, ids, px, visual=nudged)
        finally:
            route_qwen2(CALLS)
        keep, ref_keep = stages.keeps[0], ref_stages.keeps[0]
        overlap = len(set(keep.tolist()) & set(ref_keep.tolist())) / len(ref_keep)
        witness = len(set(moved_stages.keeps[0].tolist()) & set(ref_keep.tolist())) / len(ref_keep)
        log(f"[qwen2 pdrop] {label}: encode {o.encode_s:.3f} s, pdrop prefill "
            f"{o.prefill_s:.3f} s, decode {(o.num_generated - 1) / o.decode_s:.2f} tok/s, "
            f"tokens {o.token_ids.tolist()}; rows " + " -> ".join(map(str, rows))
            + f"; kv_len by layer {sorted(set(lens), reverse=True)} ({lens.count(rows[0])}, "
            f"{lens.count(rows[1])}, {lens.count(rows[-1])} layers); TransV rows "
            f"{transv_rows}; attn keep set of {len(ref_keep)}: kernels vs plain versions "
            f"{overlap:.2%} overlap, plain vs plain one ulp up {witness:.2%}")
        logits_agree(f"qwen2 pdrop {label}, kernels vs plain versions, one keep set", logits,
                     ref)
        # random weights rank visual tokens by near-ties that one input ulp
        # reorders: the kernels' set must overlap the plain one as closely as
        # that, or to 99%, less 2 points
        if overlap < min(0.99, witness) - 0.02:
            raise AssertionError(f"qwen2 pdrop {label}: keep sets overlap {overlap:.2%} (one "
                                 f"input ulp: {witness:.2%})")
        del visual, nudged
    model.merge_modules = None
    torch.cuda.empty_cache()

    # (d) the engine: 4 slots, a text request and four of 64 frames
    g = torch.Generator(device=DEV).manual_seed(SEED + 14)
    mix = [dict(input_ids=torch.randint(10, 130000, (100,), generator=g, device=DEV).tolist(),
                max_new_tokens=MAX_NEW)]
    for _ in range(4):
        ids = torch.randint(10, 130000, (40,), generator=g, device=DEV).tolist()
        mix.append(dict(input_ids=ids[:8] + [IMAGE_TOKEN] * 64 + ids[8:],
                        pixels=torch.rand(64, size, size, 3, generator=g, device=DEV) * 2 - 1,
                        image_token_id=IMAGE_TOKEN, max_new_tokens=MAX_NEW))
    eng = ServingEngine(model, arch, terminator_ids=[], num_slots=4, max_len=4096,
                        steps_per_sync=4)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run([Request(request_id=i, **kw) for i, kw in enumerate(mix)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_tok = sum(len(r.output_ids) for r in out)
    log(f"[qwen2 engine] {len(out)} requests through 4 slots, {n_tok} output tokens in "
        f"{wall:.3f} s, {n_tok / wall:.2f} output tokens/s; {smi}")
    # the slots' decode is the plain masked attention (one length a row)
    qwen2_launches("qwen2 engine", {}, need=("flash_fwd", "vit_attn_qkv"))
    bad = [(r.request_id, r.error) for r in out if r.error or not r.done]
    if bad:
        raise AssertionError(f"qwen2 engine requests failed: {bad}")
    del eng
    check_qwen2_engine(model, arch, mix, out)
    # (e) speculative decoding, (f) LoRA training
    phase_speculative(model, arch, smi, kernel_results, "qwen2 spec")
    phase_qwen2_training(model, arch, kernel_results)
    del model, gen, gen_p
    gc.collect()
    torch.cuda.empty_cache()
    # (g) W8A8, the weights made again from the seed
    phase_qwen2_w8a8(arch, smi, outs, requests)
    gc.collect()
    torch.cuda.empty_cache()


QWEN2_W8A8_COS = 0.98  # the W8A8 request's first logits against bf16, as phase 7's


def phase_qwen2_w8a8(arch, smi: str, bf16: dict, requests) -> None:
    """10(g): qwen2.5-7b in W8A8 as bench.py serves the 9B: the tower's and
    the backbone's linears int8 (the lm_head by its f32 dequant, the
    projector bf16), calibrated on one 64-frame clip. The 64-frame request
    through Generator.generate (K2 28 launches for the prefill, K9 28 a
    decode step) against the bf16 model's (a): first-logit cosine
    QWEN2_W8A8_COS; a 32-token question on a cached prefix of 8 tokens + 64
    frames against that whole prompt; a 2-slot ServingEngine with the text
    and the 64-frame request."""
    t0 = time.perf_counter()
    model = init_vlm_params(arch, torch.Generator(device=DEV).manual_seed(SEED),
                            dtype=torch.bfloat16)
    quantize_params_int8(model.vision_backbone)
    quantize_params_int8(model.llm_backbone)
    g = torch.Generator(device=DEV).manual_seed(SEED + 4)
    size = arch.vision.image_size
    clip = torch.rand(64, size, size, 3, generator=g, device=DEV) * 2 - 1
    calibrate_act_scales(lambda m, px: vit_mod.vit_forward(m, arch.vision, px),
                         model.vision_backbone, [clip])
    with torch.no_grad():
        emb = encode_visual(model, arch, clip)
    calibrate_act_scales(
        lambda m, e: qwen2_mod.qwen2_forward(m, arch.llm, inputs_embeds=e, logits_to_keep=1),
        model.llm_backbone, [emb.reshape(1, -1, emb.shape[-1])])
    del clip, emb
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    int8 = [m for m in model.modules() if isinstance(m, Int8Linear)]
    cfg = arch.llm
    log(f"[qwen2 w8a8] quantized {len(int8)} linears ({sum(m.act_inv is not None for m in int8)}"
        f" calibrated on one 64-frame clip; q/k/v with their biases); "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB, {time.perf_counter() - t0:.1f} s")
    gen = Generator(model, arch, terminator_ids=[], max_new_tokens=MAX_NEW)
    label, (ids, px) = requests[1]
    reset_launches()
    o = gen.generate(ids, pixels=px, image_token_id=IMAGE_TOKEN)
    qwen2_launches("qwen2 w8a8", {"flash_fwd": cfg.num_hidden_layers,
                                  "block_attn": (o.num_generated - 1) * cfg.num_hidden_layers})
    cos = cosine(o.first_logits, bf16[label].first_logits)
    log(f"[qwen2 w8a8] {label}: encode {o.encode_s:.3f} s, prefill {o.prefill_s:.3f} s, decode "
        f"{(o.num_generated - 1) / o.decode_s:.2f} tok/s, tokens {o.token_ids.tolist()} (bf16 "
        f"{bf16[label].token_ids.tolist()}); first-token logits against the bf16 model: cosine "
        f"{cos:.6f} (limit {QWEN2_W8A8_COS}); {smi}")
    if not (torch.isfinite(o.first_logits).all() and cos >= QWEN2_W8A8_COS):
        raise AssertionError(f"qwen2 w8a8: first-logit cosine {cos:.6f} against bf16")
    # a question on a cached prefix, against the whole prompt
    n_prefix = 8 + px.shape[0]
    state = gen.prefill_prefix(ids[:n_prefix], pixels=px, image_token_id=IMAGE_TOKEN,
                               suffix_budget=512)
    reset_launches()
    q = gen.generate(ids[n_prefix:], prefix=state)
    qwen2_launches("qwen2 w8a8 prefix",
                   {"block_attn": (q.num_generated + 1) * cfg.num_hidden_layers},
                   need=("block_attn",))
    log(f"[qwen2 w8a8 prefix] {len(ids) - n_prefix}-token question on 8 tokens + "
        f"{px.shape[0]} frames: tokens {q.token_ids.tolist()}, the whole prompt's "
        f"{o.token_ids.tolist()}")
    logits_agree("qwen2 w8a8 prefix, question vs the whole prompt", q.first_logits,
                 o.first_logits, QWEN2_W8A8_COS)
    del state
    # the engine
    mix = [dict(input_ids=requests[0][1][0], max_new_tokens=MAX_NEW),
           dict(input_ids=ids, pixels=px, image_token_id=IMAGE_TOKEN, max_new_tokens=MAX_NEW)]
    eng = ServingEngine(model, arch, terminator_ids=[], num_slots=2, max_len=4096,
                        steps_per_sync=4)
    reset_launches()
    out = eng.run([Request(request_id=i, **kw) for i, kw in enumerate(mix)])
    qwen2_launches("qwen2 w8a8 engine", {}, need=("flash_fwd", "vit_attn_qkv"))
    bad = [(r.request_id, r.error) for r in out if r.error or not r.done]
    if bad:
        raise AssertionError(f"qwen2 w8a8 engine requests failed: {bad}")
    got = {r.request_id: list(r.output_ids) for r in out}
    log(f"[qwen2 w8a8 engine] 2 requests through 2 slots: tokens {got[0]} and {got[1]}; the "
        f"offline Generator's 64-frame tokens {o.token_ids.tolist()}")
    del eng, gen, model


def check_qwen2_engine(model, arch, mix, out) -> None:
    """Each engine request's tokens against the offline Generator's; where
    they part, every engine token from there that is not the argmax of an
    f32 teacher-forcing qwen2_forward (an f32 copy of the backbone, plain
    versions) must lie within MISS_GAP_LIMIT of it (phase 5b's rule)."""
    llm32, same = None, 0
    for i, (kw, r) in enumerate(zip(mix, out)):
        gen = Generator(model, arch, terminator_ids=[], max_new_tokens=len(r.output_ids))
        px = kw.get("pixels")
        ref = gen.generate(kw["input_ids"], pixels=px, image_token_id=IMAGE_TOKEN)
        cos = cosine(r.first_logits, ref.first_logits)
        ref = ref.token_ids.tolist()
        first = next((j for j, (a, b) in enumerate(zip(r.output_ids, ref)) if a != b), None)
        log(f"[qwen2 engine] request {i}: first logits cosine {cos:.6f} against the offline "
            f"Generator's; tokens {r.output_ids}, the Generator's "
            + ("the same" if first is None else f"{ref} (they part at {first})"))
        if not cos >= 0.999:
            raise AssertionError(f"qwen2 engine request {i}: first logits cosine {cos:.6f}")
        if first is None:
            same += 1
            continue
        if llm32 is None:
            llm32 = qwen2_mod.Qwen2Model(arch.llm, torch.float32, DEV)
            llm32.load_state_dict(model.llm_backbone.state_dict())
        with torch.inference_mode():
            visual = gen.encode_frames(px) if px is not None else None
        route_qwen2(PLAIN)
        try:
            rows = forced_logits(llm32, arch, gen, kw["input_ids"] + r.output_ids[:-1], visual,
                                 len(r.output_ids))
        finally:
            route_qwen2(CALLS)
        gaps = [(rows[j].max() - rows[j, tok]).item() for j, tok in enumerate(r.output_ids)]
        worst = max(gaps[first:])
        log(f"[qwen2 engine] request {i}: largest gap below the f32 argmax from token {first} "
            f"on {worst:.3e} (limit {MISS_GAP_LIMIT})")
        if worst > MISS_GAP_LIMIT:
            raise AssertionError(f"qwen2 engine request {i}: a token {worst:.3e} below the f32 "
                                 "argmax")
    log(f"[qwen2 engine] {same} of {len(out)} requests give the offline Generator's tokens")
    del llm32
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 4b: a checkpoint in the reference's layout, loaded and chatted with
# ---------------------------------------------------------------------------

def _nano_reference(sd: dict, cfg) -> dict:
    """A NanoModel state_dict -> NemotronHForCausalLM names: the role-split
    in_proj joined back to [gate | x | B | C | dt] rows, the conv taps to
    (C, 1, K)."""
    out = {}
    for k, v in sd.items():
        if not re.match(r"layers\.\d+\.mixer\.(in_proj|conv1d)\.\w+\.(weight|bias)$", k):
            out[k if k.startswith("lm_head.") else f"backbone.{k}"] = v
    for i, bt in enumerate(cfg.layers_block_type):
        if bt != "mamba":
            continue
        pre = f"layers.{i}.mixer"
        out[f"backbone.{pre}.in_proj.weight"] = torch.cat(
            [sd[f"{pre}.in_proj.{r}.weight"] for r in ("gate", "x", "B", "C", "dt")])
        conv = torch.cat([sd[f"{pre}.conv1d.{r}.weight"] for r in "xBC"])
        out[f"backbone.{pre}.conv1d.weight"] = conv[:, None, :]
        if f"{pre}.conv1d.x.bias" in sd:
            out[f"backbone.{pre}.conv1d.bias"] = torch.cat(
                [sd[f"{pre}.conv1d.{r}.bias"] for r in "xBC"])
    return out


def _qwen2_reference(sd: dict) -> dict:
    names = {"embeddings.weight": "model.embed_tokens.weight", "norm_f.weight": "model.norm.weight"}
    return {names.get(k, k if k.startswith("lm_head.") else f"model.{k}"): v
            for k, v in sd.items()}


def _vit_reference(sd: dict, cfg) -> dict:
    """A ViT state_dict -> timm names, the patch weight back to (D, 3, p, p),
    a class row in front of the position table where the tower has a class
    token, and the last block (which the port does not build) as a copy of
    the one before it."""
    out = {}
    for k, v in sd.items():
        if k == "patch_embed.weight":
            p = cfg.patch_size
            out["patch_embed.proj.weight"] = v.reshape(v.shape[0], p, p, 3).permute(0, 3, 1, 2)
        elif k == "patch_embed.bias":
            out["patch_embed.proj.bias"] = v
        elif k == "pos_embed" and "cls_token" in sd:
            out[k] = torch.cat([sd["cls_token"].to(v.dtype), v], dim=1)
        elif k == "reg_tokens":
            out["reg_token"] = v
        else:
            out[re.sub(r"^layers\.", "blocks.", k)] = v
    last = cfg.num_hidden_layers - 1
    for k in [k for k in out if k.startswith(f"blocks.{last - 1}.")]:
        out[k.replace(f"blocks.{last - 1}.", f"blocks.{last}.")] = out[k]
    return out


def _iv2_reference(sd: dict, cfg) -> dict:
    """An InternVideo2 state_dict -> vit_scale_clean names: the tubelet
    weight back to (D, 3, t, p, p), LayerScale as `weight`."""
    out = {}
    for k, v in sd.items():
        if k == "patch_embed.weight":
            p, tb = cfg.patch_size, cfg.tubelet_size
            out["patch_embed.proj.weight"] = v.reshape(v.shape[0], tb, p, p, 3).permute(
                0, 4, 1, 2, 3)
        elif k == "patch_embed.bias":
            out["patch_embed.proj.bias"] = v
        else:
            k = re.sub(r"\.(ls[12])\.gamma$", r".\1.weight", k)
            out[re.sub(r"^layers\.", "blocks.", k)] = v
    return out


def _projector_reference(sd: dict) -> dict:
    names = ["fc0", "fc1", "fc2"] if "fc0.weight" in sd else ["fc1", "fc2"]
    return {f"projector.{2 * names.index(k.split('.')[0])}.{k.split('.')[1]}": v
            for k, v in sd.items()}


def reference_state_dict(sd: dict, arch) -> dict:
    """The inverse of train/convert.py:convert_vlm_checkpoint: a
    TimeViperVLM state_dict -> the reference's whole-VLM names and layouts
    (generic_vlm.py:874-910), views of `sd` where a rename suffices."""

    def part(prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    llm = part("llm_backbone.")
    llm = (_nano_reference(llm, arch.llm) if arch.llm_family == "nano"
           else _qwen2_reference(llm))
    out = {f"llm_backbone.llm.{k}": v for k, v in llm.items()}
    merge = part("merge_modules.")
    alphas = []
    for i in sorted({int(k.split(".")[0]) for k in merge}):
        alphas.append(merge[f"{i}.alpha"].reshape(1))
        for k, v in merge.items():
            if k.startswith(f"{i}.cross_attn."):
                out[f"llm_backbone.llm.backbone.merge_modules.{i}."
                    f"{k[len(f'{i}.cross_attn.'):]}"] = v
    if alphas:
        out["llm_backbone.llm.backbone.alpha"] = torch.cat(alphas)
    for key, fam, cfg in arch.towers():
        dot = f".{key}" if key else ""
        tower = part(f"vision_backbone{dot}.")
        tower = (_iv2_reference(tower, cfg) if fam == "internvideo2"
                 else _vit_reference(tower, cfg))
        vis = f"vision_backbone.backbones.{key}" if key else "vision_backbone"
        out.update({f"{vis}.featurizer.{k}": v for k, v in tower.items()})
        proj = f"projector.projectors.{key}" if key else "projector"
        out.update({f"{proj}.{k}": v
                    for k, v in _projector_reference(part(f"projector{dot}.")).items()})
    return out


class WordTokenizer:
    """A word-level tokenizer over the 9B's 131,072 ids, with the calls of a
    Hugging Face tokenizer that data/processor.py makes: the special tokens
    and the chat template's words first, `w<i>` for every other id, and
    `<image>`, once added, at IMAGE_TOKEN. Special tokens split the text
    before the words do, as in a Hugging Face tokenizer."""

    SPECIAL = ("<pad>", "<unk>", "<SPECIAL_10>", "<SPECIAL_11>", "<SPECIAL_12>")
    WORDS = ("System", "User", "Assistant")

    def __init__(self):
        self.vocab = {w: i for i, w in enumerate(self.SPECIAL + self.WORDS)}
        self.words = {i: w for w, i in self.vocab.items()}
        self.added = {}
        self.pad_token_id, self.eos_token_id = 0, self.vocab["<SPECIAL_12>"]

    def add_special_tokens(self, tokens: dict, replace_additional_special_tokens=True) -> int:
        new = [t for t in tokens["additional_special_tokens"] if t not in self.added]
        self.added.update({t: IMAGE_TOKEN for t in new})
        return len(new)

    def convert_tokens_to_ids(self, token: str):
        return self.added.get(token, self.vocab.get(token))

    def _id(self, word: str) -> int:
        if word in self.vocab or word in self.added:
            return self.convert_tokens_to_ids(word)
        return int(word[1:]) if re.fullmatch(r"w\d+", word) else self.vocab["<unk>"]

    def encode(self, text: str, add_special_tokens: bool = False) -> list:
        specials = sorted((*self.SPECIAL, *self.added), key=len, reverse=True)
        out = []
        for piece in re.split("(" + "|".join(map(re.escape, specials)) + ")", text):
            out += [self._id(piece)] if piece in specials else [self._id(w) for w in piece.split()]
        return out

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        words = []
        for i in map(int, ids):
            special = i == IMAGE_TOKEN or self.words.get(i) in self.SPECIAL
            if not (skip_special_tokens and special):
                words.append("<image>" if i == IMAGE_TOKEN else self.words.get(i, f"w{i}"))
        return " ".join(words)


CKPT_SHARD_BYTES = 2 << 30  # the reference's weight files are ~2-5 GB shards
CHAT_FRAMES = 64
CHAT_FRAME_HW = (720, 1280)  # synthetic frames: the card's machine has no libav (PERF.md §6)


def rss_bytes() -> int:
    with open("/proc/self/status") as f:
        return next(int(line.split()[1]) * 1024 for line in f if line.startswith("VmRSS:"))


class PeakRSS:
    """The host's resident set, sampled every 5 ms while the block runs;
    `peak` is the largest."""

    def __enter__(self):
        import threading

        self.peak, self._stop = rss_bytes(), threading.Event()

        def sample():
            while not self._stop.wait(0.005):
                self.peak = max(self.peak, rss_bytes())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_bytes())


def round_to_checkpoint_values(model) -> int:
    """The JAX loader rounds every leaf of ndim >= 2 to the model's dtype
    (timeviper_tpu/models/api.py:205-207); the port's bf16 model keeps a few
    such tensors (the Mamba conv taps, the ViT position table) in f32. Round
    those in place to bf16 values, so that the checkpoint this phase writes
    loads back bitwise. Returns how many tensors were rounded."""
    n = 0
    with torch.no_grad():
        for t in model.state_dict().values():
            if t.dtype == torch.float32 and t.ndim >= 2:
                t.copy_(t.to(torch.bfloat16))
                n += 1
    return n


def write_checkpoint(model, arch, path: Path) -> int:
    """`path`: config.json with the JAX package's keys and the weights in
    the reference's layout (`reference_state_dict`), torch.save'd as .bin
    shards of about CKPT_SHARD_BYTES. Returns the bytes written."""
    with open(path / "config.json", "w") as f:
        json.dump({"model_id": "timeviper-9b-random", "vision_backbone_id":
                   arch.vlm.vision_backbone_id, "llm_backbone_id": arch.vlm.llm_backbone_id,
                   "arch_specifier": arch.vlm.arch_specifier, "conv_template": "nano_base"}, f)
    ref = reference_state_dict(model.state_dict(), arch)
    shards, shard, size = [], [], 0
    for name in ref:
        shard.append(name)
        size += ref[name].numel() * ref[name].element_size()
        if size >= CKPT_SHARD_BYTES:
            shards.append(shard)
            shard, size = [], 0
    shards += [shard] if shard else []
    total = 0
    for i, names in enumerate(shards):
        part = {k: ref[k].detach().contiguous().cpu() for k in names}
        file = path / f"pytorch_model-{i + 1:05d}-of-{len(shards):05d}.bin"
        torch.save(part, file)
        total += file.stat().st_size
        del part
    return total


def phase_checkpoint(model, arch, smi: str, kernel_results: dict, then=None):
    """Phase 4b: the 9B written as a reference checkpoint, loaded onto the
    card through models/api.py:load_vlm_weights (every tensor bitwise the
    built one), then chat and a question on a cached video prefix through
    TimeViperModel with a word-level tokenizer and the nano_base template,
    64 synthetic 1280x720 frames through the ported host preprocessing; the
    greedy tokens against the built model's Generator on the same ids and
    pixels. The loaded model is freed at the end; `then(path)`, given, runs
    on the checkpoint before it is deleted, and its result is returned."""
    from timeviper_tpu_torch.data.native import native_available
    from timeviper_tpu_torch.models.api import assemble_model, load_vlm_weights
    from timeviper_tpu_torch.models.generate import split_prompt_at_last_image

    rounded = round_to_checkpoint_values(model)
    built = model.state_dict()
    model_bytes = sum(t.numel() * t.element_size() for t in built.values())
    holder = tempfile.TemporaryDirectory(prefix="timeviper_ckpt_")
    with contextlib.nullcontext(holder.name) as tmp:  # deleted after `then`
        path = Path(tmp)
        free = shutil.disk_usage(path).free
        if free < 1.2 * model_bytes:
            raise RuntimeError(f"{free / 1e9:.1f} GB free under {path}, the checkpoint needs "
                               f"{model_bytes / 1e9:.1f} GB")
        t0 = time.perf_counter()
        written = write_checkpoint(model, arch, path)
        log(f"[ckpt] {rounded} f32 tensors of ndim >= 2 rounded to bf16 values (the loader's "
            f"cast); wrote {written / 1e9:.3f} GB in {len(list(path.glob('*.bin')))} .bin shards "
            f"in {time.perf_counter() - t0:.2f} s; {free / 1e9:.1f} GB were free")

        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        with PeakRSS() as rss:
            rss_before = rss_bytes()
            t0 = time.perf_counter()
            loaded, larch, meta = load_vlm_weights(str(path), dtype=torch.bfloat16)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
        log(f"[ckpt] load_vlm_weights: {written / 1e9:.3f} GB read (warm: the files were just "
            f"written) in {load_s:.2f} s, {written / 1e9 / load_s:.2f} GB/s; card memory during "
            f"the load {peak / 2**30:.2f} GiB above the {before / 2**30:.2f} GiB held before "
            f"(the model is {model_bytes / 2**30:.2f} GiB); host RSS {rss_before / 2**30:.2f} "
            f"GiB before, peak {rss.peak / 2**30:.2f} GiB; {smi}")
        if peak > 1.02 * model_bytes + (256 << 20):
            raise AssertionError(f"the load held {peak / 2**30:.2f} GiB on the card, more "
                                 f"than one copy of the model")
    got = loaded.state_dict()
    same = [k for k in built if k in got and got[k].dtype == built[k].dtype
            and torch.equal(got[k], built[k])]
    log(f"[ckpt] {len(same)} of {len(built)} tensors bitwise equal to the built model's "
        f"({len(got)} loaded)")
    if len(same) != len(built) or len(got) != len(built):
        raise AssertionError("the loaded state_dict is not the built one: "
                             f"{sorted(set(built) - set(same))[:5]}")
    del got

    tm = assemble_model(loaded, larch, meta, WordTokenizer(), max_new_tokens=MAX_NEW)
    frames = np.random.default_rng(SEED + 7).integers(
        0, 255, (CHAT_FRAMES, *CHAT_FRAME_HW, 3), dtype=np.uint8)
    question = " ".join(f"w{i}" for i in range(1000, 40000, 1999))
    prompt = tm.template.prompt_for_generation("<image>" * CHAT_FRAMES + "\n" + question)
    tm.processor("<image>" * 2, videos=[list(frames[:2])])  # builds the native library
    t0 = time.perf_counter()
    enc = tm.processor(prompt, videos=[list(frames)])
    pre_s = time.perf_counter() - t0
    ids, pixels = enc["input_ids"].tolist(), enc["pixels"]
    log(f"[ckpt] host preprocessing ({'native C++' if native_available() else 'PIL'}, "
        f"{os.cpu_count()} cores): {CHAT_FRAMES} frames of {CHAT_FRAME_HW[1]}x"
        f"{CHAT_FRAME_HW[0]} -> {tuple(pixels.shape)} in {pre_s:.3f} s, "
        f"{CHAT_FRAMES / pre_s:.1f} frames/s; prompt {len(ids)} ids")

    reset_launches()
    out = tm.generator.generate(ids, pixels=pixels, image_token_id=tm.processor.image_token_id)
    text = tm.chat(question, frames=frames)
    pre_ids, suf_ids = split_prompt_at_last_image(ids, tm.processor.image_token_id)
    state = tm.prefill_video_prefix(pre_ids, pixels, suffix_budget=64)
    q_out = tm.generator.generate(suf_ids, prefix=state)
    q_text = tm.generate(suf_ids, prefix=state)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    log(f"[ckpt] launches on the loaded model: {launches}")
    for name in SERVING + ("block_attn",):
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched on the loaded model")
        kernel_results[name]["launches"] += launches[name]
    log(f"[ckpt] chat: encode {out.encode_s:.3f} s, prefill {out.prefill_s:.3f} s, decode "
        f"{(out.num_generated - 1) / out.decode_s:.2f} tok/s, {out.num_generated} tokens "
        f"{out.token_ids.tolist()}; text {text!r}; question on the prefix "
        f"{q_out.prefill_s:.3f} s, tokens {q_out.token_ids.tolist()}")

    gen = Generator(model, arch, terminator_ids=tm.processor.terminator_ids, max_new_tokens=MAX_NEW)
    want = gen.generate(ids, pixels=pixels, image_token_id=tm.processor.image_token_id)
    want_q = gen.generate(suf_ids, prefix=gen.prefill_prefix(
        pre_ids, pixels=pixels, image_token_id=tm.processor.image_token_id, suffix_budget=64))

    def as_text(o):
        return tm.processor.decode([t for t in o.token_ids.tolist()
                                    if t not in tm.processor.terminator_ids]).strip()

    log(f"[ckpt] built model: tokens {want.token_ids.tolist()}, question "
        f"{want_q.token_ids.tolist()}")
    if (out.token_ids.tolist() != want.token_ids.tolist()
            or q_out.token_ids.tolist() != want_q.token_ids.tolist()
            or text != as_text(want) or q_text != as_text(want_q)):
        raise AssertionError("the loaded model's greedy tokens are not the built model's")
    log(f"[ckpt] greedy tokens and texts equal; first logits max abs diff "
        f"{(out.first_logits - want.first_logits).abs().max().item():.3e}")
    del tm, loaded, state, gen
    gc.collect()
    torch.cuda.empty_cache()
    try:
        return then(path) if then is not None else None
    finally:
        holder.cleanup()


# 4c-4f: training from the CLI on heterogeneous rows, the remat policies,
# QLoRA and the layer-streamed offload trainer
CLI_FRAMES = (32, 64)  # one video a dataset: every batch of 2 is heterogeneous
CLI_STEPS = 4
CLI_VIDEO_HW = (360, 640)
CLI_WORDS = ("<pad> <unk> <SPECIAL_10> <SPECIAL_11> <SPECIAL_12> System User Assistant . "
             "what happens in the video a man runs then sits down").split()
HETERO_LOSS_RTOL = 1e-2
POLICY_COS = 0.9999
REMAT_ROW_FRAMES = 256  # the 4,136-token training row
BENCH_52L = dict(num_hidden_layers=52, hidden_size=2048, intermediate_size=10752,
                 mamba_num_heads=64, vocab_size=2048)  # bench_all.py:bench_train's 52 layers
BENCH_52L_TOKENS = 8192
QLORA_TOKENS = 4096  # bench_all.py:bench_qlora
QLORA_RANK = 16
QLORA = {}  # the 9B's backbone as it is
OFFLOAD = dict(num_hidden_layers=3, hybrid_override_pattern="M*-", hidden_size=4096,
               intermediate_size=21504, mamba_num_heads=128, vocab_size=2048)  # :bench_offload
OFFLOAD_TOKENS = 1024


def hf_tokenizer(**special):
    """A word-level tokenizer of the chat template's words and the data's."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(CLI_WORDS)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    return PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>", unk_token="<unk>",
                                   eos_token="<SPECIAL_12>", **special)


def write_hf_tokenizer(path: Path) -> None:
    """`hf_tokenizer` saved where AutoTokenizer.from_pretrained finds it."""
    hf_tokenizer().save_pretrained(str(path))


def check_extra_special_tokens() -> None:
    """data/processor.py:attach_special_tokens, under this machine's
    transformers, keeps a tokenizer's own extra special tokens beside
    `<image>`, and decoding skips them."""
    import transformers
    from timeviper_tpu_torch.data.processor import attach_special_tokens

    extra = ["<SPECIAL_10>", "<SPECIAL_11>"]
    tok = hf_tokenizer(additional_special_tokens=list(extra))  # the tokenizer takes the list
    attach_special_tokens(tok, "nano")
    ids = tok.encode("<SPECIAL_10> <image> what <SPECIAL_11> happens", add_special_tokens=False)
    text = tok.decode(ids, skip_special_tokens=True)
    log(f"[cli] transformers {transformers.__version__}: special tokens after <image> was added "
        f"{tok.all_special_tokens}; {ids} decodes to {text!r}")
    if not set(extra + ["<image>"]) <= set(tok.all_special_tokens) or text != "what happens":
        raise AssertionError("attach_special_tokens dropped the tokenizer's own special tokens")


def host_ram_gib() -> tuple:
    """(total, available) host memory, GiB, from /proc/meminfo."""
    with open("/proc/meminfo") as f:
        kb = {line.split(":")[0]: int(line.split()[1]) for line in f}
    return kb["MemTotal"] / 2**20, kb["MemAvailable"] / 2**20


def synthetic_frames(n: int, seed: int) -> np.ndarray:
    """n frames of CLI_VIDEO_HW: a moving gradient and noise."""
    h, w = CLI_VIDEO_HW
    r = np.random.default_rng(seed)
    base = np.arange(w)[None, :, None] + np.arange(h)[:, None, None] // 3 + np.arange(3) * 60
    return np.stack([((base + 7 * i + r.integers(0, 40, (h, w, 3))) % 256).astype(np.uint8)
                     for i in range(n)])


def write_cli_data(root: Path, files: bool) -> Path:
    """One clip per dataset, a JSON of one conversation each, and the YAML
    listing them with CLI_FRAMES frames a video. With `files` the clips are
    MJPG AVI files written by OpenCV, which data/video.py decodes."""
    import yaml

    entries = []
    for k, frames in enumerate(CLI_FRAMES):
        name = f"clip{k}.avi"
        if files:
            import cv2

            w = cv2.VideoWriter(str(root / name), cv2.VideoWriter_fourcc(*"MJPG"), 8.0,
                                CLI_VIDEO_HW[::-1])
            for fr in synthetic_frames(max(CLI_FRAMES), SEED + k):
                w.write(fr[..., ::-1])
            w.release()
        conv = [{"from": "human", "value": "<image> what happens in the video ."},
                {"from": "gpt", "value": "a man runs then sits down ." if k else "a man runs ."}]
        (root / f"data{k}.json").write_text(json.dumps([{"video": name, "conversations": conv}]))
        entries.append({"format": "conversation", "json_path": str(root / f"data{k}.json"),
                        "data_path": str(root), "sampling": "uniform", "num_frames": frames})
    (root / "data.yaml").write_text(yaml.safe_dump({"datasets": entries}))
    return root / "data.yaml"


@contextlib.contextmanager
def synthetic_video_loader(files: bool):
    """Without video files (no backend, or no OpenCV to write them),
    data/video.py:load_video gives synthetic frames (as
    tests/test_train_cli.py:36-42 does for the JAX CLI); otherwise nothing is
    replaced."""
    from timeviper_tpu_torch.data import video as video_mod

    if files:
        yield
        return
    real = video_mod.load_video

    def fake(path, *, num_frames=None, **kw):
        frames = synthetic_frames(num_frames, abs(hash(path)) % 2**31)
        return frames, np.arange(num_frames) / 8.0, video_mod.VideoMeta(num_frames, 8.0,
                                                                       num_frames / 8.0)

    video_mod.load_video = fake
    try:
        yield
    finally:
        video_mod.load_video = real


def phase_train_cli(model, arch, ckpt: Path, smi: str, kernel_results: dict):
    """Phase 4c: `python -m timeviper_tpu_torch.train.cli` (its `main`) on the
    9B from phase 4b's checkpoint: a YAML of two datasets of 32 and 64 frames
    a video, so every batch of 2 is heterogeneous; LoRA rank 8 with the
    projector trained, CLI_STEPS steps, a checkpoint every 2. Checks the
    launches of K1, K2, K2-bwd, K3 and K4, the final artifacts (the LoRA
    factors reload bitwise from lora_state.npz) and the first batch's loss
    against each row through the static one-row path, both sides on the same
    visual embeddings (ToMe re-decides its merges under one bf16 ulp:
    ROADMAP Queue 3). Returns the CLI's Trainer (its model is the 9B with
    LoRA) for phase 4d."""
    from timeviper_tpu_torch.data import video as video_mod
    from timeviper_tpu_torch.data.datasets import ConcatDataset, load_data_from_config
    from timeviper_tpu_torch.data.fusion import HeteroPlan
    from timeviper_tpu_torch.data.image_processing import transform_for_family
    from timeviper_tpu_torch.data.loader import DataLoader, to_device
    from timeviper_tpu_torch.data.processor import Processor
    from timeviper_tpu_torch.train import cli

    import importlib.util

    write_hf_tokenizer(ckpt)
    check_extra_special_tokens()
    total, avail = host_ram_gib()
    backend = video_mod.probe_backend()
    files = backend is not None and importlib.util.find_spec("cv2") is not None
    log(f"[cli] video backend: {backend}; clips written by OpenCV: {files}; host RAM "
        f"{total:.1f} GiB, {avail:.1f} GiB available; {smi}")
    if not files:
        log("[cli] no video files: data/video.py:load_video gives synthetic frames in this "
            "phase (nothing else is replaced)")
    run_root = Path(tempfile.mkdtemp(prefix="timeviper_cli_"))
    try:
        yaml_path = write_cli_data(run_root, files)
        argv = ["--data_config", str(yaml_path), "--pretrained_checkpoint", str(ckpt),
                "--run_dir", str(run_root / "run"), "--lora_enable", "--lora_r", "8",
                "--trainable_modules", "projector", "--max_steps", str(CLI_STEPS),
                "--save_every", "2", "--batch_size", "2", "--num_workers", "1",
                "--log_every", "1", "--learning_rate", "1e-3", "--device", str(DEV),
                "--vision_backbone_id", arch.vlm.vision_backbone_id,
                "--llm_backbone_id", arch.vlm.llm_backbone_id,
                "--arch_specifier", arch.vlm.arch_specifier]
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        with synthetic_video_loader(files), logging_calls(TRAINING_PLACES["nano"]) as logs:
            trainer = cli.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = {name: w.launches for name, w in WRAPPERS.items()}
        log(f"[cli] train.cli.main: {cli_s:.1f} s in all (the checkpoint's load, {CLI_STEPS} "
            f"steps, the final artifacts); launches {launches}")
        for h in trainer.history:
            log(f"[cli] step {h['step']}: loss {h['loss']:.4f}, grad norm {h['grad_norm']:.4f}, "
                f"{h['seconds']:.3f} s, peak {h.get('max_memory_gib', math.nan):.2f} GiB")
        if trainer.step != CLI_STEPS or not all(math.isfinite(h["loss"])
                                                 for h in trainer.history):
            raise AssertionError(f"the CLI trained {trainer.step} steps: {trainer.history}")
        for name in TRAINING:
            if launches[name] == 0:
                raise AssertionError(f"{name} was never launched by the training CLI")
            kernel_results[name]["launches"] += launches[name]
        # K1 / K4 and K2 / K2-bwd on the first step's heterogeneous rows: each
        # row's pads a trailing segment where K4 resets and K2-bwd skips tiles
        for key, (_, kw) in sorted(logs["ssd_fwd"].calls.items()):
            seg = kw["seq_idx"]
            pads = (seg == seg.max(dim=1, keepdim=True).values).sum(1).tolist()
            log(f"[cli] the first step's rows at {key} tokens: {seg.shape[0]} rows, trailing pad "
                f"segments of {[p if p < key else 0 for p in pads]} rows")
        check_training_calls("cli", logs, kernel_results)
        del logs

        t_check = time.perf_counter()
        final = run_root / "run" / "final"
        tparams = trainer.model.state_dict()
        npz = np.load(final / "lora_state.npz")
        dtypes = json.loads((final / "lora_state.dtypes.json").read_text())
        meta = json.loads((final / "config.json").read_text())
        same = [k for k in npz.files if ".lora_" in k and torch.equal(
            torch.from_numpy(npz[k]).to(DEV, getattr(torch, dtypes[k])), tparams[k])]
        saved = torch.load(final / "params" / "params.pt", mmap=True, weights_only=True)
        picked = [k for k in saved if ".lora_" in k or k.startswith("projector.")]
        same_saved = [k for k in picked if torch.equal(saved[k].to(DEV), tparams[k])]
        n_lora = sum(".lora_" in k for k in tparams)
        ckpts = sorted(d.name for d in (run_root / "run").iterdir() if d.name.startswith("chec"))
        log(f"[cli] final artifacts: {len(saved)} tensors in params.pt, config.json "
            f"{meta.get('lora')}, checkpoints {ckpts}; {len(same)} of {n_lora} LoRA factors "
            f"reload bitwise from lora_state.npz, {len(same_saved)} of {len(picked)} factors "
            f"and projector tensors from params.pt ({time.perf_counter() - t_check:.1f} s)")
        if len(same) != n_lora or len(same_saved) != len(picked) or len(saved) != len(
                trainer.model.state_dict()):
            raise AssertionError("the final artifacts do not reload as trained")
        del saved, npz

        # the first batch again, heterogeneous, against each of its rows alone
        processor = Processor.build(
            __import__("transformers").AutoTokenizer.from_pretrained(str(ckpt), use_fast=True),
            transform_for_family("siglip", arch.vision.image_size), arch.llm_family)
        with synthetic_video_loader(files):
            data = ConcatDataset(load_data_from_config(str(yaml_path), processor))
            order = DataLoader(data, 2, processor.image_token_id, arch.tokens_per_frame,
                               num_workers=1, seed=0)._index_batches(0)[0]
            t0 = time.perf_counter()
            items = [data[i] for i in order]
            batch_s = time.perf_counter() - t0
        cb = collate(items, processor.image_token_id, arch.tokens_per_frame,
                     processor.tokenizer.pad_token_id or 0)
        if not isinstance(cb.plan, HeteroPlan):
            raise AssertionError("the CLI's batch of 2 is not heterogeneous")
        with torch.no_grad():
            batch = to_device(cb.batch, DEV)
            px = batch["pixels"]
            ve = encode_visual(model, arch, px.reshape(-1, *px.shape[2:]))
            ve = ve.reshape(px.shape[0], -1, ve.shape[-1])
            hetero = float(vlm_loss(model, arch, {**batch, "visual_embeddings": ve}, cb.plan,
                                    remat=False)[0])
            rows = []
            for b, it in enumerate(items):
                rcb = collate([it], processor.image_token_id, arch.tokens_per_frame)
                rb = to_device(rcb.batch, DEV)
                rb = {"input_ids": rb["input_ids"], "labels": rb["labels"],
                      "visual_embeddings": ve[b:b + 1, :rcb.plan.num_visual]}
                rows.append((rcb.plan.fused_len, float(vlm_loss(model, arch, rb, rcb.plan,
                                                                remat=False)[0])))
        static = sum(v for _, v in rows) / len(rows)
        rel = abs(hetero - static) / abs(static)
        cli_rel = abs(trainer.history[0]["loss"] - static) / abs(static)
        log(f"[cli] first batch: its two items in {batch_s:.2f} s on the host (the decode of "
            f"{sum(CLI_FRAMES)} frames and their preprocessing: each step of the run waits for "
            f"them, its epoch's only batch; checks {time.perf_counter() - t_check:.1f} s); rows "
            f"of {[n for n, _ in rows]} fused tokens padded to "
            f"{cb.plan.fused_len}; heterogeneous loss {hetero:.6f} against the static rows' "
            f"mean {static:.6f} ({[round(v, 6) for _, v in rows]}), relative {rel:.2e}; the "
            f"CLI's logged first loss {trainer.history[0]['loss']:.6f} ({cli_rel:.2e}, its own "
            f"encode)")
        if not rel <= HETERO_LOSS_RTOL:
            raise AssertionError(f"heterogeneous loss {hetero} vs static rows {static}")
        return trainer
    finally:
        shutil.rmtree(run_root, ignore_errors=True)


def grad_vector(grads: dict) -> torch.Tensor:
    return torch.cat([g.float().flatten() for _, g in sorted(grads.items())])


def phase_remat_policies(tmodel, arch, smi: str, kernel_results: dict) -> None:
    """Phase 4d: the 9B LoRA step (rank 8 and the projector, the CLI's model)
    at 4,136 tokens under each remat policy: the first step's gradients from
    the same weights against "full"'s (cosine POLICY_COS), the K1 and K2
    forward launches a step (does the backward run the scan again?), then 1
    warm-up and 3 timed steps, their peak memory. Then bench_all.py's
    52-layer cell (hidden 2,048, L 8,192, every parameter's gradient) under
    "full" and "dots_scan", the TPU suite's open cell."""
    from timeviper_tpu_torch.models.remat import POLICIES
    from timeviper_tpu_torch.train.optim import build_optimizer
    from timeviper_tpu_torch.train.step import train_step, trainable_params

    row = training_row(arch, REMAT_ROW_FRAMES, torch.Generator(device=DEV).manual_seed(SEED + 11))
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in row.batch.items()}
    params = trainable_params(tmodel, True, "projector")
    start = {n: p.detach().clone() for n, p in params.items()}
    ref = None
    totals = {name: 0 for name in TRAINING}
    for policy in POLICIES:
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(start[n])
        reset_launches()
        _, grads = grad_step(tmodel, arch, params, batch, row.plan, remat=policy)
        torch.cuda.synchronize()
        fwd = {"K1": ssd_scan.launches, "K2": flash_attention.launches,
               "K4": ssd_scan_bwd.launches, "K2-bwd": flash_attention_bwd.launches}
        vec = grad_vector(grads)
        ref = vec if ref is None else ref
        cos = torch.nn.functional.cosine_similarity(vec, ref, dim=0).item()
        del grads
        opt = build_optimizer(OptimConfig(learning_rate=1e-4, schedule="constant"), params)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(4):
            t0 = time.perf_counter()
            train_step(tmodel, arch, opt, batch, row.plan, remat=policy)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        for name in TRAINING:
            totals[name] += WRAPPERS[name].launches
        log(f"[remat] 9B LoRA, {row.plan.fused_len} tokens, {policy}: timed steps "
            f"{[round(s, 4) for s in times[1:]]} s (warm-up {times[0]:.4f}), peak {peak:.2f} GiB;"
            f" launches in one step {fwd}; first-step gradient cosine with full {cos:.6f}; "
            f"{smi}")
        if not cos >= POLICY_COS:
            raise AssertionError(f"remat {policy}: gradient cosine {cos} with full")
        del opt
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(start[n])
    for name, v in totals.items():
        kernel_results[name]["launches"] += v
    del ref, vec, start
    gc.collect()
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(NanoConfig(), **BENCH_52L)
    m52 = NanoModel(cfg, torch.bfloat16, DEV)
    m52.reset_parameters(torch.Generator(device=DEV).manual_seed(SEED + 12))
    ids = torch.zeros(1, BENCH_52L_TOKENS, dtype=torch.long, device=DEV)
    plist = list(m52.parameters())
    log(f"[remat] bench_all.py's 52-layer cell: hidden {cfg.hidden_size}, "
        f"{sum(p.numel() for p in plist) / 1e9:.3f} B parameters, {BENCH_52L_TOKENS} tokens, "
        f"every parameter's gradient")
    ref = None
    for policy in ("full", "dots_scan"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        times = []
        for i in range(4):
            t0 = time.perf_counter()
            out = nano_forward(m52, cfg, input_ids=ids, remat=policy)
            loss = torch.nn.functional.cross_entropy(out["logits"][0, :-1], ids[0, 1:])
            grads = torch.autograd.grad(loss, plist)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if i == 0:
                vec = torch.cat([g.float().flatten() for g in grads])
                ref = vec if ref is None else ref
                cos = torch.nn.functional.cosine_similarity(vec, ref, dim=0).item()
                del vec
            del out, loss, grads
        peak = torch.cuda.max_memory_allocated() / 2**30
        for name in TRAINING:
            kernel_results[name]["launches"] += WRAPPERS[name].launches
        med = sorted(times[1:])[1]
        log(f"[remat] 52 layers, {policy}: timed steps {[round(s, 4) for s in times[1:]]} s "
            f"(warm-up {times[0]:.4f}), {BENCH_52L_TOKENS / med:.1f} tokens/s at the median, "
            f"peak {peak:.2f} GiB, K1 {ssd_scan.launches // 4} and K2 "
            f"{flash_attention.launches // 4} launches a step, gradient cosine with full "
            f"{cos:.6f}; {smi}")
        if not cos >= POLICY_COS:
            raise AssertionError(f"52 layers, {policy}: gradient cosine {cos} with full")
    del m52, plist, ref
    gc.collect()
    torch.cuda.empty_cache()


def lora_lm_steps(llm, cfg, ids: torch.Tensor, steps: int = 4) -> tuple:
    """`steps` LoRA steps of the backbone alone (remat "full", the factors'
    AdamW, lr 1e-4): (losses, seconds a step, peak GiB)."""
    from timeviper_tpu_torch.train.optim import build_optimizer

    params = {n: p for n, p in llm.named_parameters() if ".lora_" in n}
    for n, p in llm.named_parameters():
        p.requires_grad_(n in params)
    opt = build_optimizer(OptimConfig(learning_rate=1e-4, schedule="constant"), params)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        out = nano_forward(llm, cfg, input_ids=ids[:, :-1], remat=True)
        loss = torch.nn.functional.cross_entropy(out["logits"][0], ids[0, 1:])
        grads = torch.autograd.grad(loss, list(params.values()))
        opt.update({n: g.float() for n, g in zip(params, grads)})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        del out, loss, grads
    return losses, times, torch.cuda.max_memory_allocated() / 2**30


def module_bytes(llm) -> dict:
    """The backbone's bytes on the card by part: the int8 linears (kernel_q,
    kernel_scale, bias), the bf16 linears, the embeddings, the f32 lm_head
    weight an int8 lm_head keeps for the logits, the LoRA factors, the rest."""
    from timeviper_tpu_torch.train.lora import LoRAInt8Linear, LoRALinear

    out = dict(int8_linears=0, bf16_linears=0, embeddings=0, lm_head_f32=0, lora=0, rest=0)
    seen = set()
    for mod in llm.modules():
        for name, t in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            if t is None or id(t) in seen:
                continue
            seen.add(id(t))
            b = t.numel() * t.element_size()
            if name.startswith("lora_"):
                out["lora"] += b
            elif isinstance(mod, Int8Linear):
                out["int8_linears"] += b
            elif isinstance(mod, (torch.nn.Linear, LoRALinear)) and not isinstance(
                    mod, LoRAInt8Linear):
                out["bf16_linears"] += b
            elif isinstance(mod, torch.nn.Embedding):
                out["embeddings"] += b
            else:
                out["rest"] += b
        if isinstance(mod, Int8Linear) and mod._f32 is not None:
            out["lm_head_f32"] += mod._f32.numel() * 4
    return out


def phase_qlora(smi: str, kernel_results: dict) -> None:
    """Phase 4e: QLoRA on the 9B's backbone (bench_all.py:bench_qlora): LoRA
    rank QLORA_RANK on the bf16 base, 4 steps of QLORA_TOKENS tokens; the
    same factors again on the base in int8 (train/quantize.py:
    quantize_params_int8 keeps a LoRA'd linear's factors), 4 steps. Step s,
    peak GiB, the base's bytes by part, the first losses against each
    other."""
    cfg = dataclasses.replace(NanoConfig(), **QLORA)
    llm = NanoModel(cfg, torch.bfloat16, DEV)
    llm.reset_parameters(torch.Generator(device=DEV).manual_seed(SEED + 13))
    add_lora(llm, rank=QLORA_RANK, scope="",
             generator=torch.Generator(device=DEV).manual_seed(SEED + 14))
    init = {n: p.detach().clone() for n, p in llm.named_parameters() if ".lora_" in n}
    ids = torch.randint(10, cfg.vocab_size, (1, QLORA_TOKENS + 1), device=DEV,
                        generator=torch.Generator(device=DEV).manual_seed(SEED + 15))
    reset_launches()
    b16 = lora_lm_steps(llm, cfg, ids)
    bytes16 = module_bytes(llm)
    with torch.no_grad():
        for n, p in llm.named_parameters():
            if n in init:
                p.copy_(init[n])
    quantize_params_int8(llm)
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    q8 = lora_lm_steps(llm, cfg, ids)
    bytes8 = module_bytes(llm)
    for name in ("ssd_fwd", "flash_fwd", "ssd_bwd", "flash_bwd"):
        kernel_results[name]["launches"] += WRAPPERS[name].launches
    base16 = sum(v for k, v in bytes16.items() if k != "lora")
    base8 = sum(v for k, v in bytes8.items() if k != "lora")
    n_factor = sum(t.numel() for t in init.values())
    gib = {k: round(v / 2**30, 3) for k, v in bytes8.items()}
    rel = abs(q8[0][0] - b16[0][0]) / abs(b16[0][0])
    for tag, (losses, times, peak), base in (("bf16 base", b16, base16),
                                             ("int8 base", q8, base8)):
        log(f"[qlora] 9B backbone, LoRA rank {QLORA_RANK} ({n_factor / 1e6:.1f} M factor "
            f"parameters), {QLORA_TOKENS} tokens, {tag}: base {base / 2**30:.2f} GiB; steps "
            f"{[round(s, 4) for s in times]} s, {QLORA_TOKENS / sorted(times[1:])[1]:.1f} "
            f"tokens/s at the median of the last 3, peak {peak:.2f} GiB; losses "
            f"{[round(v, 5) for v in losses]}; {smi}")
    log(f"[qlora] the int8 base by part (GiB): {gib}; {held:.2f} GiB held on the card after "
        f"quantizing; first loss int8 {q8[0][0]:.6f} against bf16 {b16[0][0]:.6f} "
        f"(relative {rel:.2e})")
    if not base8 < base16:
        raise AssertionError(f"the int8 base holds {base8} bytes, the bf16 one {base16}")
    if not all(math.isfinite(v) for v in q8[0]) or not q8[0][-1] < q8[0][0]:
        raise AssertionError(f"QLoRA losses {q8[0]}")
    del llm, init, ids
    gc.collect()
    torch.cuda.empty_cache()


def copy_gbs(nbytes: int = 256 << 20) -> tuple:
    """Host-to-device and device-to-host GB/s of one pinned buffer of
    `nbytes`, by CUDA events over 5 copies after one."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device=DEV)
    rates = []
    for dst, src in ((dev, host), (host, dev)):
        dst.copy_(src, non_blocking=True)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(5):
            dst.copy_(src, non_blocking=True)
        b.record()
        torch.cuda.synchronize()
        rates.append(5 * nbytes / (a.elapsed_time(b) / 1e3) / 1e9)
    return tuple(rates)


def phase_offload(smi: str, kernel_results: dict) -> None:
    """Phase 4f: train/offload.py:StreamedTrainer on the TPU suite's offload
    row (bench_all.py:bench_offload: 3 layers M*-, hidden 4,096, the 9B's
    layer widths, vocab 2,048, f32 masters, OFFLOAD_TOKENS tokens): 1 warm-up
    and 3 timed steps, tokens/s, the pinned copies' GB/s, the device time
    split into copies and compute, the host's AdamW seconds; the loss falls."""
    from timeviper_tpu_torch.train.offload import StreamedTrainer, host_params

    cfg = dataclasses.replace(NanoConfig(), **OFFLOAD)
    m = NanoModel(cfg, torch.float32, DEV)
    m.reset_parameters(torch.Generator(device=DEV).manual_seed(SEED + 16))
    n_params = sum(p.numel() for p in m.parameters())
    total, avail = host_ram_gib()
    if 12 * n_params / 2**30 > 0.5 * avail:
        raise RuntimeError(f"{n_params} parameters need {12 * n_params / 2**30:.1f} GiB of host "
                           f"RAM (masters and moments), {avail:.1f} GiB are available")
    host = host_params(m)
    del m
    torch.cuda.empty_cache()
    ids = np.random.default_rng(SEED + 17).integers(3, cfg.vocab_size, (1, OFFLOAD_TOKENS + 1))
    tr = StreamedTrainer(cfg, host, lr=1e-4, compute_dtype=torch.bfloat16, device=DEV)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, times, splits = [], [], []
    for _ in range(4):
        t0 = time.perf_counter()
        losses.append(tr.train_step(ids, ids))
        times.append(time.perf_counter() - t0)
        splits.append(dict(tr.timing))
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {name: WRAPPERS[name].launches for name in ("ssd_fwd", "flash_fwd", "ssd_bwd",
                                                           "flash_bwd")}
    for name, v in launches.items():
        kernel_results[name]["launches"] += v
    h2d, d2h = copy_gbs()
    moved = tr.layer_bytes()
    med = sorted(times[1:])[1]
    log(f"[offload] {cfg.num_hidden_layers} layers {cfg.hybrid_override_pattern}, "
        f"{n_params / 1e6:.1f} M parameters ({12 * n_params / 2**30:.2f} GiB of f32 masters and "
        f"moments on the host, {avail:.1f} GiB available), {OFFLOAD_TOKENS} tokens: timed steps "
        f"{[round(s, 4) for s in times[1:]]} s (warm-up {times[0]:.4f}), "
        f"{OFFLOAD_TOKENS / med:.1f} tokens/s at the median, peak {peak:.2f} GiB on the card; "
        f"losses {[round(v, 5) for v in losses]}; launches over the 4 steps {launches}; {smi}")
    log(f"[offload] pinned copies: host-to-device {h2d:.2f} GB/s, device-to-host {d2h:.2f} "
        f"GB/s; a step moves {moved['h2d'] / 1e9:.3f} GB in and {moved['d2h'] / 1e9:.3f} GB "
        f"out ({moved['h2d'] / h2d / 1e9 + moved['d2h'] / d2h / 1e9:.3f} s at those rates)")
    for i, s in enumerate(splits[1:], 1):
        log(f"[offload] step {i + 1}: the card's timeline (events; host gaps included) "
            f"staging weights in {s.get('stage_ms', math.nan):.1f} ms, computing "
            f"{s.get('compute_ms', math.nan):.1f} ms, pulling gradients out "
            f"{s.get('pull_ms', math.nan):.1f} ms; the host's AdamW "
            f"{s['host_adam_s']:.3f} s of the step's {times[i]:.3f} s")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"offload losses {losses}")
    del tr, host


def phases_training_entry(model, arch, ckpt: Path, smi: str, kernel_results: dict,
                          lap) -> None:
    """Phases 4c-4f in turn (4c and 4d on phase 4b's checkpoint)."""
    lap("checkpoint")
    trainer = phase_train_cli(model, arch, ckpt, smi, kernel_results)
    lap("training CLI")
    phase_remat_policies(trainer.model, arch, smi, kernel_results)
    lap("remat policies")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    phase_qlora(smi, kernel_results)
    lap("QLoRA")
    phase_offload(smi, kernel_results)
    lap("offload")


# ---------------------------------------------------------------------------
# Phase 11: sequence-parallel serving
# ---------------------------------------------------------------------------

# the kernels of the sequence-parallel path and where it calls them: K1 in
# the sharded scan, K9 in the sharded attention, K3 in the frame-sharded
# encode, K7 in the decode of the replicated cache
SP_KERNELS = ("ssd_fwd", "block_attn", "vit_attn_qkv", "decode_fused")
SP_RING_TOKENS = 16384
SP_SLOTS_LEN = 8192 + 64  # the engine's capacity: the 256-frame bucket and its tokens
# bf16 decode caches of one prefill composed two ways, each tensor against
# its one-card value. Read on the H100 (PERF.md, PR 19 call 7): sound 0.99943
# at seq 1 and 0.99953 at seq 2 at the lowest; planted faults, the composed
# carry dropped from the final state 0.066, the conv halo zeroed 0.980 on
# the 64 K/V rows after the seam. The cross-span correction of y is below
# the bf16 noise of these caches (dropped: 0.99961), so sp_ssd_seam holds it
# on inputs that carry a state across the seam.
SP_CACHE_COS = 0.999
SP_SEAM_ROWS = 64
# the sharded scan's relative L2 gap to the one-card scan over the rows after
# the seam (bf16 y); the correction dropped must miss it by far
SP_SEAM_GAP = 0.02


def sp_places() -> dict:
    return {"ssd_fwd": (sp_mod, "ssd_scan"), "block_attn": (sp_mod, "block_attn_lse"),
            "vit_attn_qkv": (vit_mod, "encoder_attention_qkv"),
            "decode_fused": (nano_mod, "fused_mamba_decode")}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def cache_agreement(got, want, rows: slice) -> dict:
    """Per kind of decode-cache tensor (the Mamba states, the K/V `rows`):
    the largest relative gap (max |a - b| / max |b|) and the lowest cosine
    over the layers, each with its layer."""
    out = {}

    def add(kind, idx, a, b):
        a, b = a.float(), b.float()
        gap = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-6)
        cos = cosine(a, b)
        g, c = out.get(kind, ((0.0, -1), (2.0, -1)))
        out[kind] = (max(g, (gap, idx)), min(c, (cos, idx)))

    for idx, (g, w) in enumerate(zip(got["layers"], want["layers"])):
        if "ssm_state" in g:
            add("ssm", idx, g["ssm_state"], w["ssm_state"])
            for r in "xBC":
                add("conv " + r, idx, g["conv_state"][r], w["conv_state"][r])
        if "k" in g:
            add("k", idx, g["k"][:, rows], w["k"][:, rows])
            add("v", idx, g["v"][:, rows], w["v"][:, rows])
    return out


@torch.inference_mode()
def sp_one_rank_nccl(model, arch, kernel_results: dict) -> dict:
    """(a) nano_prefill_seq_parallel(fill_cache=True) on one NCCL rank in
    this process (the collectives called on a `seq` axis of one) on the
    256-frame request's fused row, against the one-card prefill: with K1,
    then with the fused conv (K5 on the span with its halo rows in front,
    its first call held against its plain version). Returns the launches."""
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    total = {}
    try:
        mesh = make_mesh(seq=1)
        log(f"[sp] (a) one NCCL rank: mesh {mesh}, seq group backend "
            f"{dist.get_backend(mesh.get_group('seq'))}")
        gen = Generator(model, arch, terminator_ids=[], max_new_tokens=MAX_NEW)
        ids, px = make_requests(arch)[2][1]
        visual = gen.encode_frames(px)
        plan, bucket, pad, ids_arr, gidx, seq = gen._plan_prompt(ids, IMAGE_TOKEN)
        cache_len = bucket + MAX_NEW
        fused = vlm_mod.fuse_rows(model, torch.as_tensor(ids_arr, dtype=torch.long,
                                                         device=DEV)[None],
                                  visual[None], torch.as_tensor(gidx)[None])
        for fused_conv, scan in ((False, "ssd_fwd"), (True, "ssd_conv_fwd")):
            os.environ["TIMEVIPER_FUSED_CONV"] = "1" if fused_conv else "0"
            one_logits, one_cache = gen.prefill(ids_arr, gidx, seq, visual, pad, cache_len)
            reset_launches()
            before = sharding_mod.sent_bytes
            with logging_calls({"ssd_conv_fwd": (sp_mod, "ssd_conv_scan_fused")},
                               key=first_call) as logs:
                logits, cache = nano_prefill_seq_parallel(
                    model.llm_backbone, arch.llm, fused, mesh, valid_from=pad,
                    fill_cache=True, cache_max_len=cache_len, fused_conv=fused_conv)
            torch.cuda.synchronize()
            launches = {n: WRAPPERS[n].launches for n in (scan, "block_attn")}
            moved = sharding_mod.sent_bytes - before
            cos = cosine(logits[:, -1], one_logits)
            agree = cache_agreement(cache, one_cache, slice(pad, bucket))
            worst = min(c for _, (c, _) in agree.values())
            tag = "the fused conv (K5)" if fused_conv else "K1"
            log(f"[sp] (a) one NCCL rank, {tag}, the 256-frame row ({bucket} rows, pad {pad}): "
                f"first-logit cosine {cos:.6f} against the one-card prefill; the caches (K/V "
                f"rows {pad}-{bucket}), per kind the largest relative gap and the lowest "
                "cosine, at their layers: " + "; ".join(
                    f"{kind} {g:.3e} (layer {gi}), {c:.6f} (layer {ci})"
                    for kind, ((g, gi), (c, ci)) in agree.items())
                + f"; launches {launches}, {moved / 2**20:.1f} MiB handed to the NCCL "
                "collectives")
            if not cos > 0.99 or not worst > SP_CACHE_COS:
                raise AssertionError(f"sp (a), {tag}: the one-rank sharded prefill disagrees "
                                     "with the one-card prefill")
            if min(launches.values()) == 0:
                raise AssertionError(f"sp (a): a kernel was not launched: {launches}")
            if fused_conv:
                compare_logged("ssd_conv_fwd", logs["ssd_conv_fwd"].calls, "sp (a)",
                               kernel_results)
            for n, v in launches.items():
                total[n] = total.get(n, 0) + v
        return total
    finally:
        os.environ["TIMEVIPER_FUSED_CONV"] = "0"
        dist.destroy_process_group()


@torch.inference_mode()
def sp_cache_reading(rank: int, gsp, gen1, ids, px, ring_emb):
    """The decode caches that the sequence-sharded prefill fills on a `seq`
    mesh (every rank calls this) against the one-card prefill's on the same
    row, on rank 0: the Generator's on the 256-frame request (its left pad
    fills all but the last 40 rows of the first span) and
    nano_prefill_seq_parallel's on the ring's row (no pad: the seam in the
    middle of real rows). Per row and kind of tensor (the Mamba states, the
    conv windows, the K/V of the real rows) the lowest cosine over the
    layers, with its layer; and the K/V of the ring's SP_SEAM_ROWS rows
    after the seam alone, where a fault in the cross-span scan or conv
    shows first. None on the other ranks."""
    _, bucket, pad, ids_arr, gidx, seq = gen1._plan_prompt(ids, IMAGE_TOKEN)
    visual = gsp.encode_frames(px)
    cache_len = bucket + MAX_NEW
    _, cache_sp = gsp.prefill(ids_arr, gidx, seq, visual, pad, cache_len)
    llm, cfg = gsp.model.llm_backbone, gsp.arch.llm
    L = ring_emb.shape[1]
    _, ring_sp = nano_prefill_seq_parallel(llm, cfg, ring_emb, gsp.mesh, fill_cache=True,
                                           cache_max_len=L + MAX_NEW, logits_to_keep=1)
    if rank != 0:
        return None
    _, cache1 = gen1.prefill(ids_arr, gidx, seq, visual, pad, cache_len)
    ring1 = nano_forward(llm, cfg, inputs_embeds=ring_emb, fill_cache=True,
                         cache_max_len=L + MAX_NEW, logits_to_keep=1)["cache"]
    out = {}
    for row, got, want, rows in (("256 frames", cache_sp, cache1, slice(pad, bucket)),
                                 ("ring", ring_sp, ring1, slice(0, L))):
        agree = cache_agreement(got, want, rows)
        out[row] = {kind: [c, ci] for kind, (_, (c, ci)) in agree.items()}
    seam = cache_agreement(ring_sp, ring1, slice(L // 2, L // 2 + SP_SEAM_ROWS))
    out["ring seam"] = {kind: [seam[kind][1][0], seam[kind][1][1]] for kind in "kv"}
    return out


@torch.inference_mode()
def sp_ssd_seam(rank: int, mesh, cfg) -> list:
    """ssd_seq_sharded (K1 on each span from a zero state, then the composed
    correction) at the 9B's Mamba widths over 8,192 rows, against K1 on the
    whole row on this card, on inputs whose state carries across the seam:
    x, B, C and the raw dt drawn N(0, 1) in bf16, dt_bias -2, A from -0.01 to
    -1 over the heads (the state lives 8-800 rows). Every rank calls it and
    returns, over its span's first SP_SEAM_ROWS rows, the relative L2 gap
    of its y and of its local scan alone (the correction dropped)."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 19)
    H, P = cfg.mamba_num_heads, cfg.mamba_head_dim
    G, N = cfg.mamba_n_groups, cfg.ssm_state_size
    L, n, my = 8192, sharding_mod.axis_size(mesh, "seq"), sharding_mod.axis_index(mesh, "seq")

    def draw(*shape):
        return torch.randn(*shape, generator=g, device=DEV).to(torch.bfloat16)

    x, dt, B_, C = draw(1, L, H, P), draw(1, L, H), draw(1, L, G, N), draw(1, L, G, N)
    A = -torch.linspace(0.01, 1.0, H, device=DEV)
    D, dt_bias = torch.ones(H, device=DEV), torch.full((H,), -2.0, device=DEV)
    kw = dict(chunk_size=cfg.chunk_size, D=D, dt_bias=dt_bias)
    span = slice(my * L // n, (my + 1) * L // n)
    want = ssd_scan(x, dt, A, B_, C, **kw)[0][:, span][:, :SP_SEAM_ROWS].float()
    part = [t[:, span].contiguous() for t in (x, dt, B_, C)]
    got = sp_mod.ssd_seq_sharded(*part[:2], A, *part[2:], mesh=mesh, **kw)
    local = ssd_scan(*part[:2], A, *part[2:], **kw)[0]

    def gap(y):
        return ((y[:, :SP_SEAM_ROWS].float() - want).norm() / want.norm()).item()

    return [gap(got), gap(local)]


def sp_gate(tag: str, got, want, rows_fn) -> str:
    """The tokens equal the one-card ones, or, from the first difference,
    each lies within MISS_GAP_LIMIT of the argmax of the one-card
    teacher-forcing rows over them (phase 5b's near-tie gate, the bf16 model
    with its kernels as the reference)."""
    first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if first is None and len(got) == len(want):
        return "equal"
    rows = rows_fn(got)
    gaps = [(rows[j].max() - rows[j, tok]).item() for j, tok in enumerate(got)]
    worst = max(gaps[first or 0:])
    if worst > MISS_GAP_LIMIT:
        raise AssertionError(f"sp {tag}: a token {worst:.3e} below the one-card argmax")
    return f"part at {first}, largest gap {worst:.3e} (limit {MISS_GAP_LIMIT})"


def sp_replay_indices(mask_log) -> list:
    """The attn stages' keep sets the sharded prefill chose, as the indices
    into the current visual block that StageLog(replay=) takes."""
    out = []
    for compress, keep, current in mask_log:
        if compress == "attn":
            pos = torch.cumsum(current.long(), 0) - 1
            out.append(pos[keep].cpu())
    return out


def sp_rank(rank: int, world: int, port: int, folder: str) -> None:
    """(b) One rank of the 2-rank gloo run on cuda:0 (module doc, phase 11)."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for var in FUSIONS:  # K7 in the decode; K1 (not K5) in the prefill
        os.environ[var] = "1" if var == "TIMEVIPER_FUSED_DECODE" else "0"
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        out = sp_rank_work(rank, make_mesh(seq=world))
        with open(os.path.join(folder, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


@torch.no_grad()
def sp_rank_work(rank: int, mesh) -> dict:
    t_rank = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    arch = build_arch(VLMConfig())
    model = init_vlm_params(arch, torch.Generator(device=DEV).manual_seed(SEED),
                            dtype=torch.bfloat16, device=DEV)
    arch_p = pdrop_arch(arch)
    attach_merge_modules(model, arch_p)
    llm, cfg = model.llm_backbone, arch.llm
    requests = make_requests(arch)
    ids, px = requests[2][1]
    pre_ids, q_ids = split_prompt_at_last_image(ids, IMAGE_TOKEN)
    kw = dict(terminator_ids=[], max_new_tokens=MAX_NEW)
    gen1, gen1_p = Generator(model, arch, **kw), Generator(model, arch_p, **kw)
    factors = [None]
    if rank == 0:  # TransV's q_proj tempered as in phase 5c, then on both ranks
        factors = [temper_transv(model, gen1_p, ids, px)]
    dist.broadcast_object_list(factors, src=0)
    if rank != 0:
        for si, f in enumerate(factors[0]):
            model.merge_modules.stage(si).cross_attn.q_proj.weight.mul_(f)
    ring_ids = torch.randint(10, 130000, (SP_RING_TOKENS,), device=DEV,
                             generator=torch.Generator(device=DEV).manual_seed(SEED + 11))
    ring_emb = llm.embeddings(ring_ids)[None]
    mix = [dict(input_ids=i, pixels=p, image_token_id=IMAGE_TOKEN, max_new_tokens=MAX_NEW)
           for _, (i, p) in requests]
    ref = {}
    if rank == 0:  # the one-card references, the same model on the same card
        out1 = gen1.generate(ids, pixels=px, image_token_id=IMAGE_TOKEN)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ring_ref = nano_forward(llm, cfg, inputs_embeds=ring_emb, logits_to_keep=1)["logits"]
        torch.cuda.synchronize()
        eng1 = ServingEngine(model, arch, num_slots=3, max_len=SP_SLOTS_LEN, **kw)
        ref = dict(out=out1, ring=ring_ref[:, -1], ring_s=time.perf_counter() - t0,
                   engine=[r.output_ids for r in eng1.run(
                       [Request(request_id=i, **r) for i, r in enumerate(mix)])])
        del eng1
        _, _, _, own = pdrop_prefill(gen1_p, ids, px)  # the one-card ranking's own keep set
        ref["own_keep"] = own.keeps
    dist.barrier()
    torch.cuda.empty_cache()

    # the sequence-sharded main path
    gsp, gsp_p = Generator(model, arch, mesh=mesh, **kw), Generator(model, arch_p, mesh=mesh, **kw)
    mask_log = []
    stage_keep = sp_mod._stage_keep_mask

    def record(stage, hidden, model_, cfg_, valid_g, vis_mask, *args):
        keep = stage_keep(stage, hidden, model_, cfg_, valid_g, vis_mask, *args)
        mask_log.append((stage.compress_type, keep, valid_g & vis_mask))
        return keep

    reset_launches()
    sharding_mod.sent_bytes = 0
    sp_mod._stage_keep_mask = record
    try:
        with logging_calls(sp_places(), key=first_call) as logs:
            out_sp = gsp.generate(ids, pixels=px, image_token_id=IMAGE_TOKEN)
            gen_bytes = sharding_mod.sent_bytes
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ring = nano_prefill_seq_parallel(llm, cfg, ring_emb, mesh, logits_to_keep=1)[:, -1]
            torch.cuda.synchronize()
            ring_s, ring_bytes = time.perf_counter() - t0, sharding_mod.sent_bytes - gen_bytes
            out_p = gsp_p.generate(ids, pixels=px, image_token_id=IMAGE_TOKEN, use_pdrop=True)
            n_gen_masks = len(mask_log)
            st = gsp_p.prefill_prefix(pre_ids, pixels=px, image_token_id=IMAGE_TOKEN,
                                      use_pdrop=True)
            out_q = gsp_p.generate(q_ids, prefix=st)
            kv_valid_layers = sum("kv_valid" in lc for lc in st.cache["layers"])
            eng = ServingEngine(model, arch, mesh=mesh, num_slots=3, max_len=SP_SLOTS_LEN, **kw)
            engine = [r.output_ids for r in eng.run(
                [Request(request_id=i, **r) for i, r in enumerate(mix)])]
            del eng
            torch.cuda.synchronize()
    finally:
        sp_mod._stage_keep_mask = stage_keep
    launches = {n: WRAPPERS[n].launches for n in SP_KERNELS}
    if min(launches.values()) == 0:
        raise AssertionError(f"sp rank {rank}: a kernel of the path was not launched: "
                             f"{launches}")
    errs = {n: dict(max_abs_err=0.0) for n in SP_KERNELS}
    for name in SP_KERNELS:
        compare_logged(name, logs[name].calls, f"sp rank {rank}", errs)
    cache_cos = sp_cache_reading(rank, gsp, gen1, ids, px, ring_emb)
    seam_gap, seam_drop = sp_ssd_seam(rank, mesh, cfg)
    if rank > 0 and not (seam_gap < SP_SEAM_GAP < seam_drop):
        raise AssertionError(f"sp rank {rank}: the sharded scan after the seam is "
                             f"{seam_gap:.3e} off the one-card scan (limit {SP_SEAM_GAP}), "
                             f"its local scan alone {seam_drop:.3e}")
    res = dict(rank=rank, launches=launches, errs={n: e["max_abs_err"] for n, e in errs.items()},
               tokens=out_sp.token_ids.tolist(), pdrop=out_p.token_ids.tolist(),
               question=out_q.token_ids.tolist(), engine=engine,
               encode_s=out_sp.encode_s, prefill_s=out_sp.prefill_s, ring_s=ring_s,
               gen_bytes=gen_bytes, ring_bytes=ring_bytes, kv_valid_layers=kv_valid_layers,
               seam=[seam_gap, seam_drop])
    if rank == 0:
        res["cache_cos"] = cache_cos
        worst = min(c for row in cache_cos.values() for c, _ in row.values())
        if not worst > SP_CACHE_COS:
            raise AssertionError(f"sp: the seq-2 cache disagrees with the one-card cache: "
                                 f"lowest cosine {worst:.6f} ({cache_cos})")
        res.update(sp_rank0_checks(model, arch, arch_p, gen1, gen1_p, ref, ids, px, pre_ids,
                                   q_ids, mix, out_sp, ring, out_p, out_q, engine, mask_log,
                                   n_gen_masks))
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["rank_s"] = time.perf_counter() - t_rank
    return res


def sp_rank0_checks(model, arch, arch_p, gen1, gen1_p, ref, ids, px, pre_ids, q_ids, mix,
                    out_sp, ring, out_p, out_q, engine, mask_log, n_gen_masks) -> dict:
    """Rank 0 holds the sharded results against the one-card ones."""
    llm, merge = model.llm_backbone, model.merge_modules
    out1 = ref["out"]
    res = dict(one_encode_s=out1.encode_s, one_prefill_s=out1.prefill_s,
               one_ring_s=ref["ring_s"])
    res["cos"] = cosine(out_sp.first_logits, out1.first_logits)
    res["ring_cos"] = cosine(ring, ref["ring"])

    def plain_rows(request_ids, pixels):
        visual = gen1.encode_frames(pixels) if pixels is not None else None
        return lambda toks: forced_logits(llm, arch, gen1, request_ids + toks[:-1], visual,
                                          len(toks))

    res["tokens_gate"] = sp_gate("generate", out_sp.token_ids.tolist(),
                                 out1.token_ids.tolist(), plain_rows(ids, px))
    res["engine_gate"] = [sp_gate(f"engine {i}", got, want,
                                  plain_rows(r["input_ids"], r["pixels"]))
                          for i, (got, want, r) in enumerate(zip(engine, ref["engine"], mix))]
    # pdrop: the one-card pdrop Generator on the keep sets the sharded
    # ranking chose (its softmax leaves out the left pad, the one-card one
    # takes it in, both as in the JAX package)
    gen_keep = sp_replay_indices(mask_log[:n_gen_masks])
    pre_keep = sp_replay_indices(mask_log[n_gen_masks:])
    own = ref["own_keep"][0]
    res["keep_overlap"] = len(set(own.tolist()) & set(gen_keep[0].tolist())) / max(len(own), 1)
    with StageLog(gen_keep):
        ref_p = gen1_p.generate(ids, pixels=px, image_token_id=IMAGE_TOKEN, use_pdrop=True)
    visual = gen1_p.encode_frames(px)

    def pdrop_rows(toks):
        with StageLog(list(gen_keep)):
            return forced_logits_pdrop(llm, merge, arch_p, gen1_p, ids, visual, toks)

    res["pdrop_cos"] = cosine(out_p.first_logits, ref_p.first_logits)
    res["pdrop_gate"] = sp_gate("pdrop", out_p.token_ids.tolist(), ref_p.token_ids.tolist(),
                                pdrop_rows)
    with StageLog(pre_keep):
        st1 = gen1_p.prefill_prefix(pre_ids, pixels=px, image_token_id=IMAGE_TOKEN,
                                    use_pdrop=True)
    ref_q = gen1_p.generate(q_ids, prefix=st1)
    res["question_cos"] = cosine(out_q.first_logits, ref_q.first_logits)
    same = next((i for i, (a, b) in enumerate(zip(out_q.token_ids, ref_q.token_ids)) if a != b),
                len(ref_q.token_ids))
    res["question_same"] = same
    for key in ("cos", "ring_cos", "pdrop_cos", "question_cos"):
        if not res[key] > 0.99:
            raise AssertionError(f"sp: {key} {res[key]:.6f} against the one-card run")
    return res


def phase_seq_parallel(smi: str, kernel_results: dict) -> None:
    """Phase 11 (module doc): (a) one NCCL rank here, (b) two gloo ranks on
    this card, spawned; each rank's K1, K9, K3 and K7 launches add to the
    kernels line."""
    t_phase = time.perf_counter()
    arch = build_arch(VLMConfig())
    model = init_vlm_params(arch, torch.Generator(device=DEV).manual_seed(SEED),
                            dtype=torch.bfloat16)
    for var in FUSIONS:
        os.environ[var] = "0"
    one = sp_one_rank_nccl(model, arch, kernel_results)
    del model
    gc.collect()
    torch.cuda.empty_cache()  # the ranks hold the 9B twice on this card
    folder = tempfile.mkdtemp(prefix="chip_smoke_sp_")
    try:
        torch.multiprocessing.spawn(sp_rank, args=(2, free_port(), folder), nprocs=2)
        ranks = [json.load(open(os.path.join(folder, f"rank{r}.json"))) for r in range(2)]
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    r0 = ranks[0]
    for r in ranks[1:]:
        for key in ("tokens", "pdrop", "question", "engine"):
            if r[key] != r0[key]:
                raise AssertionError(f"sp: rank {r['rank']}'s {key} tokens differ from rank 0's")
    for name in SP_KERNELS:
        kernel_results[name]["launches"] += sum(r["launches"][name] for r in ranks)
        kernel_results[name]["max_abs_err"] = max(kernel_results[name]["max_abs_err"],
                                                  *(r["errs"][name] for r in ranks))
    for name, n in one.items():
        kernel_results[name]["launches"] += n
    log(f"[sp] (b) two gloo ranks on one {smi.strip()} card: the 256-frame request, the "
        f"one-card Generator on rank 0 against Generator(mesh=make_mesh(seq=2)): first-logit "
        f"cosine {r0['cos']:.6f}, tokens {r0['tokens_gate']}; the seq-2 decode caches against "
        f"the one-card prefill's on the same row, per kind the lowest cosine (limit "
        f"{SP_CACHE_COS}) at its layer: "
        + "; ".join(f"{row}: " + ", ".join(f"{kind} {c:.6f} ({ci})"
                                           for kind, (c, ci) in kinds.items())
                    for row, kinds in r0["cache_cos"].items())
        + f"; the sharded scan's first {SP_SEAM_ROWS} rows after the seam (inputs that carry "
        f"a state across it) {ranks[1]['seam'][0]:.3e} off the one-card scan (relative L2, "
        f"limit {SP_SEAM_GAP}), the span's scan alone {ranks[1]['seam'][1]:.3e}; ring prefill of "
        f"{SP_RING_TOKENS} tokens, last-logit cosine {r0['ring_cos']:.6f}; pdrop "
        f"uni_14_0.8-attn_18_0.6 + TransV (a kv_valid cache, {r0['kv_valid_layers']} "
        f"attention layers with their own mask) on the sharded keep sets: cosine "
        f"{r0['pdrop_cos']:.6f}, tokens {r0['pdrop_gate']}; the one-card ranking's own attn "
        f"keep set shares {100 * r0['keep_overlap']:.1f}% with the sharded one (its softmax "
        f"takes in the left pad, as in the JAX package); a question on the pdrop prefix: cosine "
        f"{r0['question_cos']:.6f}, tokens equal for the first {r0['question_same']} of "
        f"{len(r0['question'])}; ServingEngine(mesh=) on the 3 requests: {r0['engine_gate']}")
    for r in ranks:
        log(f"[sp] rank {r['rank']}: peak {r['peak_gib']:.1f} GiB, launches {r['launches']}, "
            f"max abs err against the plain versions {r['errs']}, its run "
            f"{r['rank_s']:.1f} s")
    log(f"[sp] seconds (gloo ranks sharing one card, host-staged collectives: no multi-card "
        f"speed): sharded encode {r0['encode_s']:.3f} s, prefill {r0['prefill_s']:.3f} s; "
        f"one-card encode {r0['one_encode_s']:.3f} s, prefill {r0['one_prefill_s']:.3f} s; "
        f"ring prefill of {SP_RING_TOKENS} tokens {r0['ring_s']:.3f} s, one-card "
        f"{r0['one_ring_s']:.3f} s; bytes a rank handed to the collectives: "
        f"{r0['gen_bytes'] / 2**20:.1f} MiB for the 256-frame request's encode and prefill, "
        f"{r0['ring_bytes'] / 2**20:.1f} MiB for the ring prefill")
    log(f"[sp] phase 11: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phase 12: the training half of parallelism
# ---------------------------------------------------------------------------

MESH_ONE_COS = 0.999  # (a): one rank through the mesh code; (b)'s first logits
MESH_GRAD_COS = 0.99  # (b)-(d): gradient cosine by group against one card
# |g| / |g_ref| by group, within 1 +/- these: a cosine does not see a gradient
# scaled x2 or x1/2 (a missing / nd, a leaf summed twice over an axis)
MESH_ONE_NORM = 0.01  # (a)
MESH_GRAD_NORM = 0.02  # (b)-(d)
MESH_LOSS_RTOL = 1e-2
MESH_SEQ_TOKENS = 4096  # (d): one packed row of two segments
MESH_SEQ_CUT = 1500
MESH_TRAIN_KERNELS = ("ssd_fwd", "ssd_bwd", "flash_fwd", "flash_bwd")
MESH_SERVE_PLACES = {"ssd_conv_fwd": (nano_mod, "ssd_conv_scan_fused"),
                     "decode_fused": (nano_mod, "fused_mamba_decode"),
                     "layernorm": (vit_mod, "fused_ln"),
                     "vit_attn_qkv": (vit_mod, "encoder_attention_qkv")}
# (d): SpanAttnFn's K9 forward and its backward's two K2-bwd modes
MESH_SEQ_PLACES = {"block_attn": (sp_mod, "block_attn_lse"),
                   "flash_bwd": (sp_mod, "flash_attention_bwd"),
                   "flash_bwd_noncausal": (sp_mod, "cross_attention_bwd")}
MESH_KERNELS = MESH_TRAIN_KERNELS + tuple(MESH_SERVE_PLACES) + ("block_attn",
                                                                "flash_bwd_noncausal")
MESH_GROUPS = {
    "LoRA, Mamba in_proj": lambda n: ".lora_" in n and ".in_proj." in n,
    "LoRA, Mamba out_proj": lambda n: ".lora_" in n and ".out_proj." in n,
    "LoRA, attention": lambda n: ".lora_" in n and any(
        f".{p}." in n for p in ("q_proj", "k_proj", "v_proj", "o_proj")),
    "LoRA, MLP": lambda n: ".lora_" in n and (".up_proj." in n or ".down_proj." in n),
    "projector": lambda n: n.startswith("projector."),
}


def mesh_model(arch):
    """The 9B from the seed with LoRA rank 8 on the backbone, its lora_b drawn
    off zero (so that lora_a has a gradient); the projector trains too."""
    model = init_vlm_params(arch, torch.Generator(device=DEV).manual_seed(SEED),
                            dtype=torch.bfloat16, device=DEV)
    add_lora(model, rank=8, alpha=16.0,
             generator=torch.Generator(device=DEV).manual_seed(SEED + 2))
    g = torch.Generator(device=DEV).manual_seed(SEED + 12)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith(".lora_b"):
                p.normal_(0.0, 1e-3, generator=g)
    trainable_params(model, True, "projector")  # the rest frozen, as the Trainer sets it
    return model


def mesh_inputs(arch) -> dict:
    """Two 1,064-token rows of one plan, the 256-frame request and the
    4,096-token packed row of (d), all from the seed."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 3)
    rows = [training_row(arch, 64, g), training_row(arch, 64, g)]
    two = dataclasses.replace(rows[0], batch={k: np.concatenate([r.batch[k] for r in rows])
                                              for k in rows[0].batch})
    gs = torch.Generator(device=DEV).manual_seed(SEED + 13)
    emb = (torch.randn(1, MESH_SEQ_TOKENS, arch.llm.hidden_size, generator=gs, device=DEV)
           * 0.02).to(torch.bfloat16)
    seq_idx = (torch.arange(MESH_SEQ_TOKENS, device=DEV) >= MESH_SEQ_CUT).to(torch.int32)[None]
    return {"one": rows[0], "two": two, "request": make_requests(arch)[2][1],
            "emb": emb, "seq_idx": seq_idx}


def mesh_trainer(arch, model, mesh=None, data: int = 1, tp: int = 1):
    cfg = TrainerConfig(run_dir=tempfile.mkdtemp(prefix="chip_smoke_mesh_"), max_steps=1,
                        save_every=10**9, lora=True, trainable_modules="projector",
                        remat="full", resume=False, data_parallel=data, model_parallel=tp)
    return Trainer(arch, model, OptimConfig(learning_rate=1e-3, schedule="constant"), cfg,
                   device=DEV, mesh=mesh)


def mesh_step(trainer, cb):
    """The first step's (loss, f32 gradients) of a batch through the
    Trainer's step (this rank's rows on a data axis)."""
    batch = trainer._rows({k: torch.from_numpy(v).to(DEV) for k, v in cb.batch.items()})
    metrics, grads = grad_step(trainer.model, trainer.step_arch, trainer.opt.params, batch,
                               cb.plan, remat=trainer.remat, layout=trainer.layout)
    return float(metrics["loss"]), grads


def seq_loss_grads(llm, cfg, emb, seq_idx, mesh=None) -> tuple:
    """The JAX seq-parallel test's loss (the mean square of the last 8
    logits) and its gradient with respect to the LoRA factors: through
    nano_forward, or through nano_prefill_seq_parallel on a mesh (each
    rank's part psummed over `seq`)."""
    params = {n: p for n, p in llm.named_parameters() if ".lora_" in n}
    if mesh is None:
        logits = nano_forward(llm, cfg, inputs_embeds=emb, seq_idx=seq_idx,
                              logits_to_keep=8)["logits"]
    else:
        logits = nano_prefill_seq_parallel(llm, cfg, emb, mesh, logits_to_keep=8,
                                           seq_idx=seq_idx)
    loss = logits.float().square().mean()
    got = torch.autograd.grad(loss, list(params.values()))
    grads = {f"llm_backbone.{n}": g.float() for n, g in zip(params, got)}
    if mesh is not None:
        grads = {n: sharding_mod.psum(g, mesh, "seq") for n, g in grads.items()}
    return float(loss.detach()), grads


def mesh_agreement(got: dict, want: dict) -> dict:
    """Per MESH_GROUPS group, [the cosine of the gradients, |got| / |want|],
    summed in float64 (a float32 sum over tens of millions of elements reads
    a cosine above 1)."""
    out = {}
    for group, pick in MESH_GROUPS.items():
        names = [n for n in want if pick(n)]
        if names:
            a, b = (torch.cat([g[n].double().flatten().cpu() for n in names]) for g in (got, want))
            out[group] = [float(a @ b / (a.norm() * b.norm())), float(a.norm() / b.norm())]
    return out


def mesh_passes(loss: float, want_loss: float, agree: dict, min_cos: float,
                norm_tol: float) -> bool:
    return (abs(loss - want_loss) <= MESH_LOSS_RTOL * abs(want_loss)
            and all(c >= min_cos and abs(r - 1.0) <= norm_tol for c, r in agree.values()))


def mesh_gate(tag: str, loss: float, want_loss: float, agree: dict, min_cos: float,
              norm_tol: float) -> None:
    """The loss, each group's cosine and norm ratio against one card; the
    same gate must refuse the gradients doubled and halved (a planted x2 and
    x1/2, which leave every cosine as it is)."""
    log(f"[mesh] {tag}: loss {loss:.6f} against one card's {want_loss:.6f}; by group, "
        f"gradient cosine and norm ratio " + ", ".join(f"{g} {c:.6f} {r:.6f}"
                                                       for g, (c, r) in agree.items()))
    for scale in (2.0, 0.5):
        planted = {g: [c, r * scale] for g, (c, r) in agree.items()}
        if mesh_passes(loss, want_loss, planted, min_cos, norm_tol):
            raise AssertionError(f"mesh {tag}: the gate passes the gradients x{scale}")
    log(f"[mesh] {tag}: planted x2 reads norm ratios "
        + ", ".join(f"{2 * r:.6f}" for _, r in agree.values())
        + f" and x1/2 " + ", ".join(f"{r / 2:.6f}" for _, r in agree.values())
        + f": the gate (cosine {min_cos}, norm ratio 1 +/- {norm_tol}) refuses both")
    if not mesh_passes(loss, want_loss, agree, min_cos, norm_tol):
        raise AssertionError(f"mesh {tag}: against one card (cosine limit {min_cos}, norm "
                             f"ratio 1 +/- {norm_tol})")


@torch.no_grad()
def check_span_calls(tag: str, logs: dict, kernel_results: dict) -> None:
    """(d)'s first K9 call against its plain version, and the first call of
    each K2-bwd mode in SpanAttnFn's backward against the same formulas in
    f32 given the same merged output and row log-sum-exp
    (cross_attention_bwd_plain with that part's mask)."""
    for name, lg in logs.items():
        for key, (args, kw) in lg.calls.items():
            if name == "block_attn":
                got, want = block_attn_lse(*args, **kw), block_attn_lse_plain(*args, **kw)
            else:
                q, k, v, o, dout, lse = args[:6]
                seg = args[6] if len(args) > 6 else None
                mask = attn_mod.make_attention_mask(
                    q.shape[1], k.shape[1], causal=name == "flash_bwd", q_segment_ids=seg,
                    kv_segment_ids=seg, device=q.device)
                got = WRAPPERS[name](*args)
                want = cross_attention_bwd_plain(q, k, v, o, dout, lse=lse, mask=mask)
            err = compare(name, tuple(got), tuple(want))
            log(f"[{tag}] {name} on the path's own inputs "
                f"{[tuple(a.shape) for a in args[:3]]}: max abs err {err:.3e}")
            kernel_results[name]["max_abs_err"] = max(kernel_results[name]["max_abs_err"], err)


@torch.inference_mode()
def decode_margins(gen, ids, px, tokens) -> list:
    """The one-card greedy decode's top-2 logit margin at each of `tokens`,
    teacher-forced."""
    visual = gen.encode_frames(px)
    plan, bucket, pad, ids_arr, gidx, seq = gen._plan_prompt(ids, IMAGE_TOKEN)
    logits, cache = gen.prefill(ids_arr, gidx, seq, visual, pad, bucket + len(tokens) + 1)
    out = []
    for t in tokens:
        top = logits.float().topk(2, dim=-1).values[0]
        out.append(float(top[0] - top[1]))
        logits, cache = decode_step(gen.model, gen.arch, torch.tensor([[t]], device=DEV), cache)
    return out


def mesh_references(model, arch, inp) -> dict:
    """The one-card references, on the host."""
    set_fusions(False)
    trainer = mesh_trainer(arch, model)
    ref = {}
    for key in ("one", "two"):
        loss, grads = mesh_step(trainer, inp[key])
        ref[key] = (loss, {n: g.cpu() for n, g in grads.items()})
    loss, grads = seq_loss_grads(model.llm_backbone, arch.llm, inp["emb"], inp["seq_idx"])
    ref["seq"] = (loss, {n: g.cpu() for n, g in grads.items()})
    set_fusions(True)
    gen = Generator(model, arch, terminator_ids=[], max_new_tokens=MAX_NEW)
    ids, px = inp["request"]
    out = gen.generate(ids, pixels=px, image_token_id=IMAGE_TOKEN)
    ref["gen"] = (out.first_logits.float().cpu(), out.token_ids.tolist(),
                  decode_margins(gen, ids, px, out.token_ids.tolist()))
    set_fusions(False)
    return ref


def mesh_one_rank_nccl(model, arch, inp, ref) -> None:
    """(a) The Trainer's first step on a (1, 1, 1) mesh of one NCCL rank."""
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        trainer = mesh_trainer(arch, model, mesh)
        loss, grads = mesh_step(trainer, inp["one"])
        mesh_gate(f"(a) one NCCL rank, mesh {tuple(mesh.shape)}, one row of "
                  f"{inp['one'].plan.fused_len} tokens", loss, ref["one"][0],
                  mesh_agreement(grads, ref["one"][1]), MESH_ONE_COS, MESH_ONE_NORM)
    finally:
        dist.destroy_process_group()


def mesh_rank(rank: int, world: int, port: int, folder: str) -> None:
    """One rank of phase 12's gloo run on cuda:0."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        out = mesh_rank_work(rank, world, folder)
        with open(os.path.join(folder, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def mesh_rank_work(rank: int, world: int, folder: str) -> dict:
    arch = build_arch(VLMConfig())
    inp = mesh_inputs(arch)
    ref = torch.load(os.path.join(folder, "refs.pt"), weights_only=False)
    out = {"rank": rank, "steps": {}, "launches": {n: 0 for n in MESH_KERNELS},
           "errs": {n: 0.0 for n in MESH_KERNELS}, "gates": {}}
    errs = {n: dict(max_abs_err=0.0) for n in MESH_KERNELS}

    def in_turn(fn):  # one rank at a time holds a whole model on the card
        res = None
        for r in range(world):
            if r == rank:
                res = fn()
                torch.cuda.empty_cache()
            dist.barrier()
        return res

    def measured(tag: str, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        sent, t0 = sharding_mod.sent_bytes, time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out["steps"][tag] = dict(s=time.perf_counter() - t0,
                                 peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                                 sent_mib=(sharding_mod.sent_bytes - sent) / 2**20,
                                 launches={n: WRAPPERS[n].launches for n in MESH_KERNELS
                                           if WRAPPERS[n].launches})
        for n, v in out["steps"][tag]["launches"].items():
            out["launches"][n] += v
        return res

    set_fusions(False)
    # (d) seq 2: the whole model on each rank
    model = in_turn(lambda: mesh_model(arch))
    mesh = make_mesh(seq=world)
    with logging_calls(MESH_SEQ_PLACES, key=first_call) as logs:
        loss, grads = measured("(d) seq 2", lambda: seq_loss_grads(
            model.llm_backbone, arch.llm, inp["emb"], inp["seq_idx"], mesh))
    out["gates"]["d"] = (loss, mesh_agreement(grads, ref["seq"][1]))
    check_span_calls(f"mesh (d) rank {rank}", logs, errs)
    del grads, logs
    # (b) model 2: the same model, sharded
    trainer = mesh_trainer(arch, model, make_mesh(model=world), tp=world)
    torch.cuda.empty_cache()
    with logging_calls(TRAINING_PLACES["nano"]) as logs:
        loss, grads = measured("(b) model 2, step", lambda: mesh_step(trainer, inp["one"]))
    full = trainer.layout.full_state(grads)
    out["gates"]["b"] = (loss, mesh_agreement(full, ref["one"][1]))
    check_training_calls(f"mesh (b) rank {rank}", logs, errs)
    del logs, grads, full
    set_fusions(True)
    gen = Generator(trainer.model, arch, mesh=trainer.mesh, terminator_ids=[],
                    max_new_tokens=MAX_NEW)
    ids, px = inp["request"]
    with logging_calls(MESH_SERVE_PLACES, key=first_call) as logs:
        res = measured("(b) model 2, 256-frame request", lambda: gen.generate(
            ids, pixels=px, image_token_id=IMAGE_TOKEN))
    for name, lg in logs.items():
        compare_logged(name, lg.calls, f"mesh (b) rank {rank}", errs)
    first, tokens, margins = ref["gen"]
    got = res.token_ids.tolist()
    part = next((i for i, (a, b) in enumerate(zip(got, tokens)) if a != b), None)
    out["gates"]["serve"] = dict(cos=cosine(res.first_logits.cpu(), first), tokens=got,
                                 part=part, margin=None if part is None else margins[part])
    set_fusions(False)
    del gen, trainer, model, logs
    gc.collect()
    torch.cuda.empty_cache()
    # (c) data 2, the frozen base FSDP-split
    mesh_d = make_mesh(data=world)
    trainer = in_turn(lambda: mesh_trainer(arch, mesh_model(arch), mesh_d, data=world))
    loss, grads = measured("(c) data 2 FSDP, step", lambda: mesh_step(trainer, inp["two"]))
    out["gates"]["c"] = (loss, mesh_agreement(grads, ref["two"][1]))
    out["fsdp_leaves"] = len(trainer.layout.fsdp_leaves)
    out["errs"] = {n: e["max_abs_err"] for n, e in errs.items()}
    return out


def phase_mesh(smi: str, kernel_results: dict) -> None:
    """Phase 12 (module doc)."""
    t_phase = time.perf_counter()
    arch = build_arch(VLMConfig())
    inp = mesh_inputs(arch)
    model = mesh_model(arch)
    ref = mesh_references(model, arch, inp)
    mesh_one_rank_nccl(model, arch, inp, ref)
    del model, inp
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[mesh] this process holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card "
        f"({torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved) as the ranks start")
    folder = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        torch.save(ref, os.path.join(folder, "refs.pt"))
        torch.multiprocessing.spawn(mesh_rank, args=(2, free_port(), folder), nprocs=2)
        ranks = [json.load(open(os.path.join(folder, f"rank{r}.json"))) for r in range(2)]
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    for r in ranks:
        g = r["gates"]
        mesh_gate(f"(d) rank {r['rank']}, seq 2, the {MESH_SEQ_TOKENS}-token packed row's "
                  "last-8-logit loss", g["d"][0], ref["seq"][0], g["d"][1], MESH_GRAD_COS,
                  MESH_GRAD_NORM)
        mesh_gate(f"(b) rank {r['rank']}, model 2, one row", g["b"][0], ref["one"][0],
                  g["b"][1], MESH_GRAD_COS, MESH_GRAD_NORM)
        mesh_gate(f"(c) rank {r['rank']}, data 2 with FSDP ({r['fsdp_leaves']} leaves "
                  "data-sharded), two rows", g["c"][0], ref["two"][0], g["c"][1], MESH_GRAD_COS,
                  MESH_GRAD_NORM)
        sv = g["serve"]
        log(f"[mesh] (b) rank {r['rank']}, Generator(mesh=make_mesh(model=2)) on the 256-frame "
            f"request: first-logit cosine {sv['cos']:.6f} against one card; tokens "
            + ("equal" if sv["part"] is None else
               f"part at {sv['part']}, where the one-card top-2 margin is {sv['margin']:.3e} "
               f"(limit {MISS_GAP_LIMIT})") + f" {sv['tokens']}")
        if sv["cos"] < MESH_ONE_COS or (sv["part"] is not None
                                        and sv["margin"] > MISS_GAP_LIMIT):
            raise AssertionError("mesh (b): the model-2 Generator disagrees with one card")
        for tag, st in r["steps"].items():
            log(f"[mesh] rank {r['rank']} {tag} on {smi.strip()}: {st['s']:.3f} s, peak "
                f"{st['peak_gib']:.1f} GiB, {st['sent_mib']:.1f} MiB handed to the collectives, "
                f"launches {st['launches']}")
    for name in MESH_KERNELS:
        total = sum(r["launches"][name] for r in ranks)
        if total == 0:
            raise AssertionError(f"mesh: {name} was never launched on the mesh path")
        kernel_results[name]["launches"] += total
        kernel_results[name]["max_abs_err"] = max(kernel_results[name]["max_abs_err"],
                                                  *(r["errs"][name] for r in ranks))
    log(f"[mesh] phase 12 (gloo ranks sharing one card, host-staged collectives: no "
        f"multi-card speed): {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile the bf16 256-frame encode, a training step and an int8 "
                             "request after the checks")
    args = parser.parse_args()
    start = last = time.perf_counter()

    def lap(phase: str) -> None:  # each phase's seconds, to see where the run goes
        nonlocal last
        now = time.perf_counter()
        log(f"[time] {phase}: {now - last:.1f} s ({now - start:.1f} s in all)")
        last = now

    smi = phase_device()
    phase_build()
    lap("device and build")
    results = phase_kernels(torch.Generator(device=DEV).manual_seed(SEED))
    lap("kernels")
    phase_microbench(results)
    lap("microbenchmarks")
    arch = build_arch(VLMConfig())  # siglip-vit-so400m-384px + tome_mlp-16 + nano-9b-v2
    t0 = time.perf_counter()
    model = init_vlm_params(arch, torch.Generator(device=DEV).manual_seed(SEED),
                            dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[model] TimeViper-9B: {n_params / 1e9:.2f} B params, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB, init {time.perf_counter() - t0:.1f} s")
    bf16 = phase_serving(model, arch, results, profile=args.profile)
    lap("serving")
    phase_checkpoint(model, arch, smi, results, then=lambda ckpt: phases_training_entry(
        model, arch, ckpt, smi, results, lap))
    lap("checkpoint deleted")
    phase_long_video(model, arch, results)
    lap("long video")
    phase_engine(model, arch, smi, results)
    lap("engine")
    phase_pdrop(model, arch, smi, results)
    lap("pdrop")
    phase_speculative(model, arch, smi, results, "spec")
    lap("speculative")
    phase_training(model, arch, results, profile=args.profile)
    lap("training")
    phase_tower_training(model, arch, smi, results)
    lap("tower training")
    del model  # the int8 phase makes the weights again from the seed
    gc.collect()
    torch.cuda.empty_cache()
    phase_int8_serving(arch, smi, results, bf16, profile=args.profile)
    lap("int8 serving")
    gc.collect()
    torch.cuda.empty_cache()
    iv2 = phase_tower_serving("internvideo2-1b-16-224px", 3, "iv2", results, int8=True)
    results["vit_attn"]["launches"] = iv2["vit_attn"]
    lap("internvideo2")
    gc.collect()
    torch.cuda.empty_cache()
    phase_tower_serving("dinosiglip-vit-so-384px", 2, "dinosiglip", results)
    lap("dinov2 + siglip")
    gc.collect()
    torch.cuda.empty_cache()
    phase_qwen2(smi, results)
    lap("qwen2")
    gc.collect()
    torch.cuda.empty_cache()
    phase_seq_parallel(smi, results)
    lap("sequence-parallel serving")
    gc.collect()
    torch.cuda.empty_cache()
    phase_mesh(smi, results)
    lap("tensor, data and FSDP parallelism")
    line = {"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name]["source"],
             replaces=KERNELS[name]["replaces"], launches=r["launches"],
             max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
             bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
             **({"tile": list(FLASH_TILE)} if name == "flash_fwd" else {}))
        for name, r in results.items()]}
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
