"""The port's Trainer (train/trainer.py) on the CPU at a tiny size, with the
JAX package's trainer tests as the model (tests/test_train_loop.py): the loss
falls on a repeated batch; a checkpoint restores the state and resumes; an
exception leaves an emergency checkpoint; leftover microbatches still update;
bf16 LoRA factors keep f32 Adam moments."""

import numpy as np
import pytest
import torch

from timeviper_tpu_torch.config import VLMConfig, tiny_nano_config, tiny_vit_config
from timeviper_tpu_torch.data.fusion import HeteroPlan, fuse_labels, plan_fusion
from timeviper_tpu_torch.data.loader import collate, pad_to
from timeviper_tpu_torch.models.vlm import VLMArch, init_vlm_params
from timeviper_tpu_torch.train.checkpoint import latest_checkpoint
from timeviper_tpu_torch.train.lora import add_lora
from timeviper_tpu_torch.train.optim import OptimConfig
from timeviper_tpu_torch.train.trainer import Trainer, TrainerConfig

IMG = 500
ARCH = VLMArch(vlm=VLMConfig(arch_specifier="tome_mlp-2"), vision=tiny_vit_config(),
               llm=tiny_nano_config())
OPT = OptimConfig(learning_rate=3e-3, schedule="constant", total_steps=8)


def _model(dtype=torch.float32, lora=False):
    model = init_vlm_params(ARCH, torch.Generator().manual_seed(0), dtype, device="cpu")
    if lora:
        add_lora(model, generator=torch.Generator().manual_seed(1))
    return model


def _batches(n, rows=2, seed=0):
    rng = np.random.default_rng(seed)
    ids = [5, 6, IMG, IMG, 9, 10, 11, 12]
    items = [{"input_ids": np.asarray(ids), "labels": np.asarray([-100] * 5 + [10, 11, 12]),
              "pixels": rng.standard_normal((2, 28, 28, 3)).astype(np.float32)}
             for _ in range(rows)]
    cb = collate(items, IMG, ARCH.tokens_per_frame)
    return [cb] * n


def _cfg(tmp_path, **kw):
    base = dict(run_dir=str(tmp_path / "run"), max_steps=8, log_every=2, save_every=100,
                resume=False)
    base.update(kw)
    return TrainerConfig(**base)


def test_collate_matches_the_fusion_plan():
    cb = _batches(1)[0]
    plan = plan_fusion([5, 6, IMG, IMG, 9, 10, 11, 12], IMG, ARCH.tokens_per_frame)
    assert cb.plan.fused_len == plan.fused_len == 10
    np.testing.assert_array_equal(cb.batch["labels"][0],
                                  fuse_labels(plan, [-100] * 5 + [10, 11, 12]))
    assert cb.batch["input_ids"].dtype == np.int32 and (cb.batch["input_ids"] != IMG).all()
    np.testing.assert_array_equal(pad_to(np.arange(3), 5, -1), [0, 1, 2, -1, -1])
    # rows with other layouts: a heterogeneous batch, each row's plan as data
    # (tests/test_torch_hetero_batch.py)
    hb = collate([{"input_ids": np.asarray([5, IMG]), "labels": np.asarray([1, 2])},
                  {"input_ids": np.asarray([5, 6]), "labels": np.asarray([1, 2])}],
                 IMG, ARCH.tokens_per_frame)
    assert isinstance(hb.plan, HeteroPlan) and hb.batch["gather_idx"].shape == (2, hb.plan.fused_len)


@pytest.mark.parametrize("lora", [False, True])
def test_loss_decreases(tmp_path, lora):
    trainer = Trainer(ARCH, _model(lora=lora), OPT,
                      _cfg(tmp_path, lora=lora, trainable_modules="projector" if lora else None),
                      device="cpu")
    trainer.train(iter(_batches(8)))
    losses = [h["loss"] for h in trainer.history]
    assert trainer.step == 8 and len(losses) == 8
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_checkpoint_resume_restores_the_state(tmp_path):
    cfg = _cfg(tmp_path, max_steps=4, save_every=2, keep_checkpoints=1)
    trainer = Trainer(ARCH, _model(), OPT, cfg, device="cpu")
    trainer.train(iter(_batches(4)))
    assert trainer.step == 4
    assert latest_checkpoint(cfg.run_dir).endswith("checkpoint-4")
    assert len(list((tmp_path / "run").iterdir())) == 1  # keep=1 dropped step 2

    resumed = Trainer(ARCH, _model(), OPT, _cfg(tmp_path, max_steps=6, resume=True),
                      device="cpu")
    assert resumed.step == 4 and resumed.opt.count == 4
    for n, p in trainer.opt.params.items():
        torch.testing.assert_close(resumed.opt.params[n], p, rtol=0, atol=0)
        torch.testing.assert_close(resumed.opt.nu[n], trainer.opt.nu[n], rtol=0, atol=0)
    # both continue identically
    trainer.cfg.max_steps = 6
    trainer.train(iter(_batches(2)))
    resumed.train(iter(_batches(2)))
    for n, p in trainer.opt.params.items():
        torch.testing.assert_close(resumed.opt.params[n], p, rtol=0, atol=0)


def test_an_exception_leaves_an_emergency_checkpoint(tmp_path):
    def batches():
        yield from _batches(3)
        raise RuntimeError("data source died")

    trainer = Trainer(ARCH, _model(), OPT, _cfg(tmp_path), device="cpu")
    with pytest.raises(RuntimeError, match="data source died"):
        trainer.train(batches())
    # the feed copies two batches ahead, so the failure surfaces after step 1
    assert trainer.step == 1
    assert latest_checkpoint(trainer.cfg.run_dir).endswith("checkpoint-1")


def test_grad_accumulation_and_leftover_microbatches(tmp_path):
    trainer = Trainer(ARCH, _model(), OPT, _cfg(tmp_path, grad_accum_steps=2), device="cpu")
    trainer.train(iter(_batches(5)))
    assert trainer.step == 3  # two full updates and one from the leftover microbatch


def test_bf16_lora_factors_keep_f32_moments(tmp_path):
    trainer = Trainer(ARCH, _model(torch.bfloat16, lora=True), OPT,
                      _cfg(tmp_path, lora=True, trainable_modules="projector", max_steps=2),
                      device="cpu")
    factors = {n: p for n, p in trainer.opt.params.items() if ".lora_" in n}
    assert factors and all(p.dtype == torch.bfloat16 for p in factors.values())
    assert all(trainer.opt.mu[n].dtype == trainer.opt.nu[n].dtype == torch.float32
               for n in trainer.opt.params)
    before = {n: p.detach().clone() for n, p in factors.items()}
    trainer.train(iter(_batches(2)))
    assert all(p.dtype == torch.bfloat16 for p in factors.values())
    assert any(not torch.equal(before[n], p) for n, p in factors.items())
    frozen = dict(trainer.model.named_parameters())["vision_backbone.patch_embed.weight"]
    assert not frozen.requires_grad
    assert isinstance(trainer.history[-1]["loss"], float)
