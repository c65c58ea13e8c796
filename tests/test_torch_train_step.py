"""The port's training step (train/step.py) against the JAX package's
make_train_step and make_lora_train_step on one tiny VLM bridged from JAX
(f32, per-block remat on both sides): loss, gradient norm and parameters
after two updates, for the full step and for the LoRA step with the
projector unfrozen. Gradient accumulation over the two rows equals the
fused step on both.

Tolerances: loss 1e-5 relative and gradient norm 1e-4 (f32 sums in other
orders through six layers); parameters within a hundredth of one update's
learning rate (1e-5). Adam's eps is 1e-4 here: with the default 1e-8 an
update divides each gradient element by its own size, so for an element near
zero it is the two sides' f32 rounding divided by itself. The optimizer with
the default eps is held to optax on identical gradients by
tests/test_torch_optim.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, rng, t

from timeviper_tpu.config import VLMConfig, tiny_nano_config, tiny_vit_config
from timeviper_tpu.data.fusion import fuse_labels, plan_fusion
from timeviper_tpu.models import vlm as jax_vlm
from timeviper_tpu.train import lora as jax_lora
from timeviper_tpu.train import optim as jopt
from timeviper_tpu.train import step as jstep
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch
from timeviper_tpu_torch.params import from_jax_numpy
from timeviper_tpu_torch.train import optim as topt
from timeviper_tpu_torch.train.lora import add_lora
from timeviper_tpu_torch.train.step import (
    accumulate_grads,
    apply_step,
    grad_step,
    train_step,
    trainable_params,
)

VLM = VLMConfig(arch_specifier="tome_mlp-2")
IMG = 500
OPT = dict(learning_rate=1e-3, schedule="constant", max_grad_norm=1.0, weight_decay=0.01,
           total_steps=4, eps=1e-4)


def _setup(lora: bool):
    arch = VLMArch(vlm=VLM, vision=tiny_vit_config(), llm=tiny_nano_config())
    jarch = jax_vlm.VLMArch(vlm=VLM, vision=arch.vision, llm=arch.llm, llm_family="nano")
    params = jax.jit(jax_vlm.init_vlm_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jarch, jnp.float32)
    if lora:
        params = jax_lora.add_lora(params, rank=4, alpha=8.0, key=jax.random.PRNGKey(1))
    model = TimeViperVLM(arch, torch.float32, device="cpu")
    if lora:
        add_lora(model, rank=4, alpha=8.0, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(from_jax_numpy(params, arch))
    ids = [5, 6, IMG, IMG, 9, 10, 11, 12]
    plan = plan_fusion(ids, IMG, arch.tokens_per_frame)
    r = rng(0)
    labels = [fuse_labels(plan, [-100] * 4 + list(r.integers(0, 512, 4))) for _ in range(2)]
    batch = {"input_ids": np.tile(np.where(np.asarray(ids) == IMG, 0, ids), (2, 1)).astype(np.int32),
             "labels": np.stack(labels).astype(np.int32),
             "pixels": r.standard_normal((2, 2, 28, 28, 3)).astype(np.float32)}
    return arch, jarch, params, model, plan, batch


def _tbatch(batch, rows=slice(None)):
    return {k: t(v[rows]) for k, v in batch.items()}


@pytest.mark.parametrize("lora", [False, True])
def test_two_steps_match_jax(lora):
    arch, jarch, params, model, plan, batch = _setup(lora)
    cfg_j, cfg_t = jopt.OptimConfig(**OPT), topt.OptimConfig(**OPT)
    if lora:
        tx = jopt.build_optimizer(cfg_j, jax_lora.trainable_lora_state(params, "projector"))
        state = jstep.init_lora_train_state(params, tx, "projector")
        step = jax.jit(jstep.make_lora_train_step(jarch, tx, plan, remat=True,
                                                  trainable_modules="projector"))
    else:
        tx = jopt.build_optimizer(cfg_j, params)
        state = jstep.init_train_state(params, tx)
        step = jax.jit(jstep.make_train_step(jarch, tx, plan, remat=True))
    opt = topt.build_optimizer(cfg_t, trainable_params(model, lora, "projector" if lora else None))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for i in range(2):
        state, jm = step(state, jb)
        tm = train_step(model, arch, opt, _tbatch(batch), plan, remat=True)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        assert int(tm["n_tokens"]) == int(jm["n_tokens"]) == 8
    want = from_jax_numpy(jax.tree_util.tree_map(np.asarray, state.params), arch)
    got = model.state_dict()
    moved = 0
    for k, w in want.items():
        np.testing.assert_allclose(n(got[k]), n(w), rtol=0, atol=0.01 * OPT["learning_rate"],
                                   err_msg=k)
        moved += k in opt.params and not np.array_equal(n(w), n(from_jax_numpy(params, arch)[k]))
    assert moved > 0


@pytest.mark.parametrize("lora", [False, True])
def test_grad_accumulation_equals_the_fused_step(lora):
    arch, _, params, model, plan, batch = _setup(lora)
    cfg = topt.OptimConfig(**OPT)
    sub = "projector" if lora else None
    opt = topt.build_optimizer(cfg, trainable_params(model, lora, sub))
    fused = train_step(model, arch, opt, _tbatch(batch), plan)
    after_fused = {k: v.clone() for k, v in model.state_dict().items()}

    model2 = TimeViperVLM(arch, torch.float32, device="cpu")
    if lora:
        add_lora(model2, rank=4, alpha=8.0, generator=torch.Generator().manual_seed(0))
    model2.load_state_dict(from_jax_numpy(params, arch))
    opt2 = topt.build_optimizer(cfg, trainable_params(model2, lora, sub))
    acc, losses = None, []
    for row in (slice(0, 1), slice(1, 2)):
        m, g = grad_step(model2, arch, opt2.params, _tbatch(batch, row), plan)
        losses.append(float(m["loss"]))
        acc = accumulate_grads(acc, g)
    out = apply_step(opt2, acc, 2.0)
    np.testing.assert_allclose(np.mean(losses), float(fused["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(out["grad_norm"]), float(fused["grad_norm"]), rtol=1e-5)
    for k, v in model2.state_dict().items():
        np.testing.assert_allclose(n(v), n(after_fused[k]), rtol=0,
                                   atol=0.01 * OPT["learning_rate"], err_msg=k)
