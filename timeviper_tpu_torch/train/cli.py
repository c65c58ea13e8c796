"""Training CLI (counterpart of timeviper_tpu/train/cli.py): a YAML data
config and a checkpoint (or a fresh init) in, trained weights out, on the
card unless `--device` names another device.

  python -m timeviper_tpu_torch.train.cli --data_config data.yaml \\
      --pretrained_checkpoint ckpt/ --run_dir runs/exp1 \\
      --lora_enable --trainable_modules projector

It takes the JAX CLI's flags: the model ids, the per-module learning rates,
freezing by `--trainable_modules`, LoRA and QLoRA (`--lora_quantize_base`:
the LLM backbone's linears in int8 before the factors are planted), pdrop
and TransV, the remat flags, resume and `--debug_nans` (autograd's anomaly
mode). A checkpoint is the reference's torch weights directory that
models/api.py:load_pretrained_vlm reads; `--projector_checkpoint` takes a
reference `.bin` or a directory this CLI wrote with
train/checkpoint.py:save_params. The JAX package's orbax directories are not
read.

`--data_parallel` and `--model_parallel` above 1 train on a mesh of that
many ranks, launched by torchrun, one card a rank with NCCL between them
(gloo with `--device cpu`); `--no_fsdp` keeps every leaf whole over the
data axis (train/trainer.py). Every rank reads the same data in the same
order (the loader yields its batches in index order, whatever
`--num_workers`) and takes its rows; rank 0 alone writes the log file and
the artifacts, whole tensors gathered from the shards:

  torchrun --nproc_per_node 2 -m timeviper_tpu_torch.train.cli ... --data_parallel 2

The final artifacts (reference save_training_artifacts, train.py:240-273)
go to <run_dir>/final: the model's state dict (`params/params.pt`),
`meta.json` and `config.json` with the run's model ids and pdrop settings
and, under LoRA, `lora_state.npz` (the factors, bf16 ones as exact f32) with
their dtypes in `lora_state.dtypes.json`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys


def get_args(argv=None):
    p = argparse.ArgumentParser(description="TimeViper training (PyTorch + CUDA)")
    # model (reference ModelArguments, train.py:133-237)
    p.add_argument("--vision_backbone_id", default="siglip-vit-so400m-384px")
    p.add_argument("--llm_backbone_id", default="nano-9b-v2")
    p.add_argument("--arch_specifier", default="tome_mlp-16")
    p.add_argument("--conv_template", default="nano_base")
    p.add_argument("--pretrained_checkpoint", default=None,
                   help="VLM checkpoint dir to start from: the reference's torch weights "
                        "(.bin/.pt/.safetensors), config.json and tokenizer files (orbax "
                        "directories are the JAX package's format; the port reads these)")
    p.add_argument("--projector_checkpoint", default=None,
                   help="projector-only warm start (stage chaining; reference "
                        "train.py:339-345): a torch .bin with projector.* keys, or a "
                        "params directory this CLI wrote (final/params)")
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--use_pdrop", action="store_true")
    p.add_argument("--pdrop_type", default=None, help="e.g. uni_14_0.8-attn_21_0.6")
    p.add_argument("--merge_module", default="no_merge",
                   choices=["no_merge", "CrossAttention"])
    # LoRA / QLoRA (reference train.py:364-383)
    p.add_argument("--lora_enable", action="store_true")
    p.add_argument("--lora_r", type=int, default=8)
    p.add_argument("--lora_alpha", type=float, default=16.0)
    p.add_argument("--lora_quantize_base", action="store_true",
                   help="QLoRA: quantize the frozen LLM base to int8")
    p.add_argument("--trainable_modules", default=None,
                   help="comma substrings, e.g. 'projector,merge'")
    # data (reference DataArguments, train.py:79-131)
    p.add_argument("--data_config", required=True, help="YAML dataset list")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--num_workers", type=int, default=2)
    # optim (reference TrainingArguments, train.py:55-78)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--vision_lr", type=float, default=None)
    p.add_argument("--projector_lr", type=float, default=None)
    p.add_argument("--merge_lr", type=float, default=None)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--max_steps", type=int, default=1000)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    # run
    p.add_argument("--run_dir", default="runs/default")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--save_every", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no_resume", action="store_true")
    # parallelism
    p.add_argument("--data_parallel", type=int, default=1,
                   help="data-parallel ranks, one process each (torchrun)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor-parallel ranks, one process each (torchrun)")
    p.add_argument("--no_fsdp", action="store_true")
    p.add_argument("--no_remat", action="store_true")
    p.add_argument("--remat_policy", type=str, default="full",
                   choices=["full", "scan", "dots", "dots_scan"],
                   help="what each checkpointed block keeps for the backward "
                        "(models/remat.py)")
    p.add_argument("--debug_nans", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of the model (default: the CUDA card)")
    return p.parse_args(argv)


def _load_projector(model, path: str) -> None:
    """A projector warm start: a params directory of save_params (a whole
    model's, whose projector.* entries are taken, or a projector's) or a
    reference torch file. The weights take the model's dtypes."""
    from timeviper_tpu_torch.train.checkpoint import PARAMS_FILE, restore_params
    from timeviper_tpu_torch.train.convert import convert_projector, load_torch_state_dict

    if os.path.isdir(path):
        if not os.path.exists(os.path.join(path, PARAMS_FILE)):
            raise ValueError(f"{path} holds no {PARAMS_FILE}: the port reads the params "
                             "directories it writes (an orbax directory is the JAX "
                             "package's format)")
        sd = restore_params(path, map_location="cpu")
        sub = {k[len("projector."):]: v for k, v in sd.items() if k.startswith("projector.")}
        sd = sub or sd
    else:
        sd = convert_projector(load_torch_state_dict(path))
    model.projector.load_state_dict(sd)


def _run(args, device, overwatch):
    import numpy as np
    import torch

    from timeviper_tpu_torch.config import VLMConfig, get_vision_backbone_config
    from timeviper_tpu_torch.data.datasets import ConcatDataset, load_data_from_config
    from timeviper_tpu_torch.data.image_processing import transform_for_family
    from timeviper_tpu_torch.data.loader import DataLoader
    from timeviper_tpu_torch.data.processor import Processor
    from timeviper_tpu_torch.models.api import build_arch
    from timeviper_tpu_torch.models.vlm import init_vlm_params
    from timeviper_tpu_torch.train.checkpoint import save_params
    from timeviper_tpu_torch.train.lora import add_lora
    from timeviper_tpu_torch.train.optim import OptimConfig
    from timeviper_tpu_torch.train.trainer import Trainer, TrainerConfig
    from timeviper_tpu_torch.utils.profiling import nan_debug

    vlm_cfg = VLMConfig(vision_backbone_id=args.vision_backbone_id,
                        llm_backbone_id=args.llm_backbone_id,
                        arch_specifier=args.arch_specifier)
    arch = build_arch(vlm_cfg)
    if args.use_pdrop:
        arch = dataclasses.replace(arch, llm=dataclasses.replace(
            arch.llm, use_pdrop=True, pdrop_type=args.pdrop_type,
            merge_module=args.merge_module))

    if args.pretrained_checkpoint:
        from timeviper_tpu_torch.models.api import load_pretrained_vlm

        loaded = load_pretrained_vlm(args.pretrained_checkpoint, use_pdrop=args.use_pdrop,
                                     device=device)
        model, processor = loaded.model, loaded.processor
    else:
        overwatch.info("initializing fresh parameters")
        if not args.tokenizer_path:
            raise ValueError("--tokenizer_path is required without --pretrained_checkpoint")
        from transformers import AutoTokenizer

        model = init_vlm_params(arch, torch.Generator(device=device).manual_seed(args.seed),
                                dtype=torch.float32, device=device)
        ventry = get_vision_backbone_config(args.vision_backbone_id)
        processor = Processor.build(
            AutoTokenizer.from_pretrained(args.tokenizer_path, use_fast=True),
            transform_for_family(ventry["family"] if ventry["family"] != "multi" else "siglip",
                                 arch.vision.image_size),
            arch.llm_family)

    if args.projector_checkpoint:
        _load_projector(model, args.projector_checkpoint)
        overwatch.info(f"projector warm-started from {args.projector_checkpoint}")

    if args.lora_enable:
        if args.lora_quantize_base:
            from timeviper_tpu_torch.train.quantize import quantize_params_int8

            quantize_params_int8(model.llm_backbone)
            overwatch.info("QLoRA: LLM base quantized to int8")
        add_lora(model, rank=args.lora_r, alpha=args.lora_alpha,
                 generator=torch.Generator(device=device).manual_seed(args.seed + 1))
        overwatch.info(f"LoRA enabled: r={args.lora_r} alpha={args.lora_alpha}")

    datasets = load_data_from_config(args.data_config, processor,
                                     template_name=args.conv_template)
    loader = DataLoader(ConcatDataset(datasets), args.batch_size,
                        image_token_id=processor.image_token_id,
                        tokens_per_frame=arch.tokens_per_frame,
                        pad_token_id=processor.tokenizer.pad_token_id or 0,
                        num_workers=args.num_workers, seed=args.seed)
    if len(loader) == 0:
        raise ValueError(f"the data config gives no batch of {args.batch_size}")

    optim_cfg = OptimConfig(
        learning_rate=args.learning_rate, vision_lr=args.vision_lr,
        projector_lr=args.projector_lr, merge_lr=args.merge_lr,
        weight_decay=args.weight_decay, warmup_steps=args.warmup_steps,
        total_steps=args.max_steps, max_grad_norm=args.max_grad_norm)
    trainer_cfg = TrainerConfig(
        run_dir=args.run_dir, max_steps=args.max_steps, log_every=args.log_every,
        save_every=args.save_every, data_parallel=args.data_parallel,
        model_parallel=args.model_parallel, remat=not args.no_remat, remat_policy=args.remat_policy, use_pdrop=args.use_pdrop,
        trainable_modules=args.trainable_modules, lora=args.lora_enable,
        resume=not args.no_resume, fsdp_params=not args.no_fsdp)
    trainer = Trainer(arch, model, optim_cfg, trainer_cfg, device=device)
    writer = trainer.writer

    with nan_debug(args.debug_nans):
        epoch = 0
        while trainer.step < args.max_steps:
            overwatch.info(f"epoch {epoch}")
            trainer.train(loader.epoch(epoch))
            epoch += 1

    final = os.path.join(args.run_dir, "final")
    final_meta = {
        "vision_backbone_id": args.vision_backbone_id,
        "llm_backbone_id": args.llm_backbone_id,
        "arch_specifier": args.arch_specifier,
        "conv_template": args.conv_template,
        # pdrop settings travel with the checkpoint (reference keeps them on
        # the model config, configuration_nano.py:179)
        "use_pdrop": bool(args.use_pdrop),
        "pdrop_type": args.pdrop_type,
        "merge_module": args.merge_module,
    }
    if args.lora_enable:
        final_meta["lora"] = {"r": args.lora_r, "alpha": args.lora_alpha,
                              "quantized_base": args.lora_quantize_base}
    state = trainer.full_state_dict()  # whole tensors (a collective on a mesh)
    if not writer:
        return trainer
    save_params(os.path.join(final, "params"), state, meta=final_meta)
    if args.lora_enable:
        # the reference's lora vs non_lora_trainables.bin split (train.py:244-250);
        # npz has no bfloat16: bf16 factors as exact f32, their dtypes beside
        lora_sd = {k: v for k, v in state.items() if k.rpartition(".")[2].startswith("lora_")}
        np.savez(os.path.join(final, "lora_state.npz"),
                 **{k: v.detach().float().cpu().numpy() if v.dtype == torch.bfloat16
                    else v.detach().cpu().numpy() for k, v in lora_sd.items()})
        with open(os.path.join(final, "lora_state.dtypes.json"), "w") as f:
            json.dump({k: str(v.dtype).replace("torch.", "") for k, v in lora_sd.items()}, f,
                      indent=2)
    with open(os.path.join(final, "config.json"), "w") as f:
        json.dump(final_meta, f, indent=2)
    overwatch.info(f"final artifacts at {final}")
    return trainer


def main(argv=None):
    """Parse `argv`, train, write the final artifacts; returns the Trainer
    (its `history` holds each logged step's metrics)."""
    args = get_args(argv)
    from timeviper_tpu_torch.device import resolve_device
    from timeviper_tpu_torch.utils.overwatch import Tee, initialize_overwatch, tee_output

    rank = 0
    if args.data_parallel > 1 or args.model_parallel > 1:
        import torch.distributed as dist

        from timeviper_tpu_torch.utils.dist import initialize_distributed

        # NCCL between cards; gloo when the ranks run on the CPU
        initialize_distributed("gloo" if args.device == "cpu" else "nccl")
        rank = dist.get_rank() if dist.is_initialized() else 0
    device = resolve_device(args.device)  # the card, unless --device names another
    overwatch = initialize_overwatch("train")
    os.makedirs(args.run_dir, exist_ok=True)
    streams = sys.stdout, sys.stderr
    if rank == 0:
        tee_output(os.path.join(args.run_dir, "train.log"))
    # the trainer's step lines go to the tee as well, for this run
    pkg = logging.getLogger("timeviper_tpu_torch")
    handler, level = logging.StreamHandler(sys.stdout), pkg.level
    handler.setFormatter(logging.Formatter("%(asctime)s | %(levelname)-7s | %(name)s :: "
                                           "%(message)s", "%m/%d %H:%M:%S"))
    pkg.addHandler(handler)
    pkg.setLevel(logging.INFO)
    try:
        return _run(args, device, overwatch)
    finally:
        pkg.removeHandler(handler)
        pkg.setLevel(level)
        for s in (sys.stdout, sys.stderr):
            if isinstance(s, Tee):
                s.flush()
                s.file.close()
        sys.stdout, sys.stderr = streams


if __name__ == "__main__":
    main()
