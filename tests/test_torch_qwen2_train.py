"""Training on the Qwen2 backbone in the port against the JAX package: a tiny
VLM (tiny SigLIP, `tome_mlp-2`) over tiny_qwen2_config, tied and untied,
JAX-initialised weights with the JAX add_lora's factors (B drawn non-zero, so
that every factor takes a gradient) bridged with from_jax_numpy, f32 on the
CPU.

* add_lora targets on the qwen2 tree exactly the linears JAX's targets (q/k/v
  with their biases, o, gate/up/down).
* vlm_loss and the LoRA gradients (train/step.py:grad_step) on two rows of
  two packed segments against JAX's make_lora_grad_step (vmapped vlm_loss
  through qwen2_forward), with per-layer remat on and off.
* Trainer: three LoRA steps against JAX's make_lora_train_step (loss, grad
  norm, the factors after them), then a checkpoint that a new Trainer
  resumes from.

Tolerance: f32, loss 1e-5 relative, gradients 1e-4 of each tensor's largest
magnitude, parameters within a hundredth of one update's learning rate; Adam's
eps is 1e-4 as in tests/test_torch_train_step.py (which says why).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, rng, t

from timeviper_tpu.config import VLMConfig, tiny_qwen2_config, tiny_vit_config
from timeviper_tpu.data.fusion import fuse_labels, plan_fusion
from timeviper_tpu.models import vlm as jax_vlm
from timeviper_tpu.train import lora as jax_lora
from timeviper_tpu.train import optim as jopt
from timeviper_tpu.train import step as jstep
from timeviper_tpu_torch import config as tcfg
from timeviper_tpu_torch.data.loader import collate
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch, vlm_loss
from timeviper_tpu_torch.params import from_jax_numpy
from timeviper_tpu_torch.train import optim as topt
from timeviper_tpu_torch.train.lora import LoRALinear, add_lora
from timeviper_tpu_torch.train.step import grad_step, trainable_params
from timeviper_tpu_torch.train.trainer import Trainer, TrainerConfig

VLM = VLMConfig(arch_specifier="tome_mlp-2", llm_backbone_id="qwen2.5-7b-instruct")
IMG = 500
OPT = dict(learning_rate=1e-3, schedule="constant", max_grad_norm=1.0, weight_decay=0.01,
           total_steps=4, eps=1e-4)


@functools.lru_cache(maxsize=None)
def _setup(tied: bool):
    """(port arch, JAX arch, the JAX tree with LoRA factors)."""
    arch = VLMArch(vlm=VLM, vision=tiny_vit_config(),
                   llm=tcfg.tiny_qwen2_config(tie_word_embeddings=tied), llm_family="qwen2")
    jarch = jax_vlm.VLMArch(vlm=VLM, vision=arch.vision,
                            llm=tiny_qwen2_config(tie_word_embeddings=tied), llm_family="qwen2")
    params = jax.jit(jax_vlm.init_vlm_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jarch, jnp.float32)
    lp = jax_lora.add_lora(params, rank=4, alpha=8.0, key=jax.random.PRNGKey(1))
    r = rng(2)

    def fill_b(node):
        if isinstance(node, dict):
            out = {k: fill_b(v) for k, v in node.items()}
            if "lora_b" in node:
                out["lora_b"] = jnp.asarray(r.standard_normal(node["lora_b"].shape,
                                                              np.float32) * 0.05)
            return out
        if isinstance(node, list):
            return [fill_b(v) for v in node]
        return node

    return arch, jarch, fill_b(lp)


def _port(arch, lp):
    model = TimeViperVLM(arch, torch.float32, device="cpu")
    add_lora(model, rank=4, alpha=8.0, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(from_jax_numpy(lp, arch))
    return model


def _packed_batch(arch):
    """Two rows of two packed samples, a frame each; labels on the text after
    the frame."""
    ids = [5, 6, IMG, 9, 10, 11] + [12, IMG, 13, 14, 15, 16, 17]
    plan = plan_fusion(ids, IMG, arch.tokens_per_frame, [6, 7])
    r = rng(0)
    labels = [fuse_labels(plan, [-100] * 3 + list(r.integers(1, 512, 3))
                          + [-100] * 2 + list(r.integers(1, 512, 5))) for _ in range(2)]
    batch = {"input_ids": np.tile(np.where(np.asarray(ids) == IMG, 0, ids), (2, 1)).astype(np.int32),
             "labels": np.stack(labels).astype(np.int32),
             "pixels": r.standard_normal((2, 2, 28, 28, 3)).astype(np.float32)}
    return plan, batch


def test_lora_targets_match_jax():
    """The forward through the factors is held by the loss below."""
    arch, _, lp = _setup(False)
    model = _port(arch, lp)
    port = {name.replace(".", "/") for name, m in model.named_modules()
            if isinstance(m, LoRALinear)}
    assert port == {p.rsplit("/", 1)[0] for p in jax_lora.split_lora_state(lp)[0]}
    assert len(port) == 7 * arch.llm.num_hidden_layers
    q = model.llm_backbone.layers[0].self_attn.q_proj
    assert isinstance(q, LoRALinear) and q.bias is not None
    o = model.llm_backbone.layers[0].self_attn.o_proj
    assert isinstance(o, LoRALinear) and o.bias is None


@functools.lru_cache(maxsize=None)
def _jax_grads(tied: bool):
    arch, jarch, lp = _setup(tied)
    plan, batch = _packed_batch(arch)
    fn = jax.jit(jstep.make_lora_grad_step(jarch, plan, remat=True))
    metrics, grads = fn(lp, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(metrics["loss"]), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("tied", [False, True])
def test_loss_and_lora_grads_match_jax(tied):
    arch, _, lp = _setup(tied)
    model = _port(arch, lp)
    assert (model.llm_backbone.lm_head is None) == tied
    plan, batch = _packed_batch(arch)
    tb = {k: t(v) for k, v in batch.items()}
    jloss, jgrads = _jax_grads(tied)
    params = trainable_params(model, lora=True)
    out = {}
    for remat in (True, False):
        metrics, grads = grad_step(model, arch, params, tb, plan, remat=remat)
        out[remat] = grads
        np.testing.assert_allclose(float(metrics["loss"]), jloss, rtol=1e-5)
    with torch.no_grad():
        loss, aux = vlm_loss(model, arch, tb, plan)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    assert int(aux["n_tokens"]) == 16
    names = {k.replace(".", "/") for k in out[True]}
    assert names == set(jgrads)
    for name, g in out[True].items():
        want = jgrads[name.replace(".", "/")]
        err = np.abs(n(g) - want).max() / np.abs(want).max()
        assert np.abs(want).max() > 0 and err < 1e-4, (name, err)
        np.testing.assert_allclose(n(out[False][name]), n(g), rtol=0,
                                   atol=1e-6 * np.abs(want).max(), err_msg=name)


def test_trainer_steps_match_jax_and_a_checkpoint_resumes(tmp_path):
    arch, jarch, lp = _setup(False)
    ids = [5, 6, IMG, IMG, 9, 10, 11, 12]
    items = [{"input_ids": np.asarray(ids), "labels": np.asarray([-100] * 5 + [10, 11, 12]),
              "pixels": rng(s).standard_normal((2, 28, 28, 3)).astype(np.float32)}
             for s in (3, 4)]
    cb = collate(items, IMG, arch.tokens_per_frame)
    cfg_j = jopt.OptimConfig(**OPT)
    tx = jopt.build_optimizer(cfg_j, jax_lora.trainable_lora_state(lp))
    state = jstep.init_lora_train_state(lp, tx)
    step = jax.jit(jstep.make_lora_train_step(jarch, tx, cb.plan, remat=True))
    jb = {k: jnp.asarray(v) for k, v in cb.batch.items()}
    jm = []
    for _ in range(3):
        state, m = step(state, jb)
        jm.append(m)

    tcfg_ = TrainerConfig(run_dir=str(tmp_path / "run"), max_steps=3, log_every=1,
                          save_every=3, lora=True, remat=True, resume=False)
    trainer = Trainer(arch, _port(arch, lp), topt.OptimConfig(**OPT), tcfg_, device="cpu")
    trainer.train([cb] * 3)
    assert trainer.step == 3 and len(trainer.history) == 3
    for h, m in zip(trainer.history, jm):
        np.testing.assert_allclose(h["loss"], float(m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(h["grad_norm"], float(m["grad_norm"]), rtol=1e-4)
    want = from_jax_numpy(jax.tree_util.tree_map(np.asarray, state.params), arch)
    for name, p in trainer.opt.params.items():
        np.testing.assert_allclose(n(p), n(want[name]), rtol=0,
                                   atol=0.01 * OPT["learning_rate"], err_msg=name)

    resumed = Trainer(arch, _port(arch, lp), topt.OptimConfig(**OPT),
                      TrainerConfig(run_dir=tcfg_.run_dir, lora=True), device="cpu")
    assert resumed.step == 3 and resumed.opt.count == 3
    for name, p in trainer.opt.params.items():
        assert torch.equal(resumed.opt.params[name], p), name
        assert torch.equal(resumed.opt.mu[name], trainer.opt.mu[name]), name
