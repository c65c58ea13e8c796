"""Training with pdrop and TransV in the port against the JAX package, on both
backbones: a tiny VLM (tiny SigLIP, `tome_mlp-4`) over tiny_nano_config
(stages `uni_1_0.75-attn_3_0.5`, layer 3 its attention layer) and
tiny_qwen2_config (`uni_1_0.75-attn_2_0.5`), CrossAttention merge modules with
alpha drawn away from 0 (at tanh(0) = 0 the cross-attention gets a zero
cotangent, and a wrong backward would pass), JAX-initialised weights with the
JAX add_lora's factors (B drawn non-zero) bridged with from_jax_numpy, f32 on
the CPU. Every batch is two rows of two packed samples of two frames each,
whose question tokens carry no labels: the "attn" stage ranks by each row's
last question token, so the two rows keep different sets.

* vlm_loss(use_pdrop=True) and its gradients (train/step.py:grad_step with
  LoRA and trainable_modules="projector,merge": every LoRA factor, the
  projector and the merge modules), remat on and off, against
  make_lora_grad_step(use_pdrop=True), jax.value_and_grad of the JAX
  package's vmapped vlm_loss; the merge modules' q/k/v gradients are
  non-zero, and the rows' "attn" keep sets differ. vlm_forward(use_pdrop=True)
  over the plan's packed layouts (labels given, no query positions) against
  the JAX package's static branch, in the same jitted JAX call, and given
  the same ranking rows as `pdrop_query_positions` instead of labels.
* grad_step on two more microbatches, and the Trainer's update from the two
  accumulated, against the JAX package's grad, accumulate and
  make_lora_apply_step.
* Trainer(use_pdrop=True): three LoRA steps, with a merge_lr of their own,
  against the JAX package's grad and apply steps (make_lora_train_step is the
  two in one jit), then a checkpoint that a new Trainer resumes from (the
  merge modules in it).

* TransV's cross-attention (ops/attention.py:cross_attention) under
  autograd: its q, k and v gradients against jax.vjp of the JAX package's
  cross_attention, and those of ops/block_attention.py:BlockAttnFn (the card's
  path: K9 forward, K2-bwd's non-causal backward; their plain versions here)
  and of ops/flash_attention.py:cross_attention_bwd (the backward's plain
  version here, from the forward's output) against the same.

Tolerances are tests/test_torch_qwen2_train.py's: f32, loss 1e-5 relative,
gradients 1e-4 of each tensor's largest magnitude (of at least 1e-6: the
gradient of a key bias is 0 in theory, softmax ignoring a shift of a row's
logits, and ~1e-12 in f32), parameters within a hundredth of one update's
learning rate; Adam's eps 1e-4 as in tests/test_torch_train_step.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, rng, t

from timeviper_tpu import config as jcfg
from timeviper_tpu.models import vlm as jax_vlm
from timeviper_tpu.ops import attention as jax_attention
from timeviper_tpu.train import lora as jax_lora
from timeviper_tpu.train import optim as jopt
from timeviper_tpu.train import step as jstep
from timeviper_tpu_torch import config as tcfg
from timeviper_tpu_torch.data.loader import collate
from timeviper_tpu_torch.models import pdrop as pdrop_mod
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch, vlm_forward
from timeviper_tpu_torch.ops.attention import cross_attention
from timeviper_tpu_torch.ops.block_attention import BlockAttnFn
from timeviper_tpu_torch.ops.flash_attention import cross_attention_bwd
from timeviper_tpu_torch.params import from_jax_numpy
from timeviper_tpu_torch.train import optim as topt
from timeviper_tpu_torch.train.lora import add_lora
from timeviper_tpu_torch.train.step import grad_step, trainable_params
from timeviper_tpu_torch.train.trainer import Trainer, TrainerConfig

IMG = 500
TRAIN = "projector,merge"
PDROP = {"nano": "uni_1_0.75-attn_3_0.5", "qwen2": "uni_1_0.75-attn_2_0.5"}
ALPHAS = (0.7, -1.1)
OPT = dict(learning_rate=1e-3, merge_lr=3e-3, schedule="constant", max_grad_norm=1.0,
           weight_decay=0.01, total_steps=4, eps=1e-4)


@functools.lru_cache(maxsize=None)
def _setup(family: str):
    """(port arch, JAX arch, the JAX tree with LoRA factors and alphas)."""
    over = dict(use_pdrop=True, pdrop_type=PDROP[family], merge_module="CrossAttention")
    vlm = dict(arch_specifier="tome_mlp-4")
    if family == "qwen2":
        vlm["llm_backbone_id"] = "qwen2.5-7b-instruct"
        llm_j, llm_t = jcfg.tiny_qwen2_config(**over), tcfg.tiny_qwen2_config(**over)
    else:
        llm_j, llm_t = jcfg.tiny_nano_config(**over), tcfg.tiny_nano_config(**over)
    arch = VLMArch(vlm=tcfg.VLMConfig(**vlm), vision=tcfg.tiny_vit_config(), llm=llm_t,
                   llm_family=family)
    jarch = jax_vlm.VLMArch(vlm=jcfg.VLMConfig(**vlm), vision=jcfg.tiny_vit_config(),
                            llm=llm_j, llm_family=family)
    params = jax.jit(jax_vlm.init_vlm_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jarch, jnp.float32)
    params["merge_modules"] = [dict(m, alpha=jnp.asarray(a, jnp.float32))
                               for m, a in zip(params["merge_modules"], ALPHAS)]
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


def _batch(arch, seed: int):
    """Two rows of two packed samples: [text, 2 frames, 2 question tokens,
    answer] each, the answers labelled; the rows' text, labels and pixels
    differ, their layout does not."""
    r = rng(seed)
    items = []
    for _ in range(2):
        a, b = (list(r.integers(10, 400, k)) for k in (7, 6))
        ids = a[:2] + [IMG, IMG] + a[2:] + b[:1] + [IMG, IMG] + b[1:]
        labels = ([-100] * 6 + a[4:]) + ([-100] * 5 + b[3:])
        items.append({"input_ids": np.asarray(ids), "labels": np.asarray(labels),
                      "txt_seq_lens": [9, 8],
                      "pixels": r.standard_normal((4, 28, 28, 3)).astype(np.float32)})
    return collate(items, IMG, arch.tokens_per_frame)


def _jb(cb):
    return {k: jnp.asarray(v) for k, v in cb.batch.items()}


def _port_names(flat, lp, arch):
    """A JAX {path: gradient} over some leaves -> {port name: gradient}, the
    kernels transposed by the bridge."""
    sd = from_jax_numpy(jax_lora.graft_lora(lp, flat), arch)
    port = {k for k in sd if k.replace(".", "/").replace("/weight", "/kernel") in flat
            or k.replace(".", "/") in flat}
    return {k: sd[k] for k in port}


def _close_grads(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for name, g in got.items():
        w = n(want[name])
        scale = np.abs(w).max()
        err = np.abs(n(g) - w).max()
        assert err <= 1e-4 * max(scale, 1e-6), (name, err, scale)


@functools.lru_cache(maxsize=None)
def _jax_fns(family: str):
    """The JAX side, compiled once a family: (grad, apply, tx). grad(params,
    batch) is make_lora_grad_step(use_pdrop=True) (value_and_grad of the
    vmapped vlm_loss over the LoRA factors, the projector and the merge
    modules) together with the static branch's vlm_forward of row 0 and its
    labels; apply is make_lora_apply_step. A make_lora_train_step is the one
    and then the other in one jit, and the JAX Trainer runs them apart to
    accumulate, so one compiled model serves every test here."""
    arch, jarch, lp = _setup(family)
    plan = _batch(arch, 0).plan
    lora_grad = jstep.make_lora_grad_step(jarch, plan, use_pdrop=True, remat=False,
                                          trainable_modules=TRAIN)

    def grad(params, batch):
        metrics, grads = lora_grad(params, batch)
        out = jax_vlm.vlm_forward(params, jarch, input_ids=batch["input_ids"][0], plan=plan,
                                  pixels=batch["pixels"][0], labels=batch["labels"][0],
                                  use_pdrop=True)
        return metrics, grads, out["logits"], out["labels"]

    tx = jopt.build_optimizer(jopt.OptimConfig(**OPT), jax_lora.trainable_lora_state(lp, TRAIN))
    return jax.jit(grad), jax.jit(jstep.make_lora_apply_step(tx, trainable_modules=TRAIN)), tx


def _jax_steps(family: str, batches, n_updates: int = 1):
    """JAX LoRA updates from `lp`, each the mean of len(batches) microbatches'
    gradients: (the first microbatch's metrics at each update, the params)."""
    arch, _, lp = _setup(family)
    grad, apply, tx = _jax_fns(family)
    state = jstep.init_lora_train_state(lp, tx, TRAIN)
    metrics = []
    for _ in range(n_updates):
        outs = [grad(state.params, _jb(cb)) for cb in batches]
        metrics.append(outs[0][0])
        acc = functools.reduce(lambda a, b: jax.tree_util.tree_map(jnp.add, a, b),
                               [o[1] for o in outs])
        state, _ = apply(state, acc, jnp.float32(len(batches)))
    return metrics, from_jax_numpy(jax.tree_util.tree_map(np.asarray, state.params), arch)


@pytest.mark.parametrize("family", ["nano", "qwen2"])
def test_pdrop_loss_grads_and_forward_match_jax(family, monkeypatch):
    """vlm_loss(use_pdrop=True) and its LoRA, projector and merge gradients
    (grad_step), remat on and off; the rows' own keep sets; TransV's q/k/v
    gradients non-zero; vlm_forward's static branch."""
    arch, _, lp = _setup(family)
    cb = _batch(arch, 0)
    jm, jg, jlogits, jlabels = _jax_fns(family)[0](lp, _jb(cb))
    model = _port(arch, lp)
    tb = {k: t(v) for k, v in cb.batch.items()}
    params = trainable_params(model, lora=True, trainable_modules=TRAIN)
    keeps, keep_indices = [], pdrop_mod._keep_indices

    def logged(stage, *args, **kw):
        idx = keep_indices(stage, *args, **kw)
        if stage.compress_type == "attn":
            keeps.append(idx.tolist())
        return idx

    monkeypatch.setattr(pdrop_mod, "_keep_indices", logged)
    out = {}
    for remat in (True, False):
        metrics, grads = grad_step(model, arch, params, tb, cb.plan, remat=remat, use_pdrop=True)
        np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=1e-5)
        out[remat] = grads
    _close_grads(out[True], _port_names({k: np.asarray(v) for k, v in jg.items()}, lp, arch))
    for name, g in out[True].items():
        np.testing.assert_allclose(n(out[False][name]), n(g), rtol=0,
                                   atol=1e-6 * max(np.abs(n(g)).max(), 1e-6), err_msg=name)
    for si in range(2):
        for proj in ("q_proj", "k_proj", "v_proj"):
            assert float(out[True][f"merge_modules.{si}.cross_attn.{proj}.weight"].abs().max()) > 0
    # one attn stage, two samples a row, two rows, two runs: each row ranks
    # its own sets (sample by sample), the same in both runs
    assert len(keeps) == 8 and keeps[:4] == keeps[4:]
    assert keeps[0] != keeps[2] or keeps[1] != keeps[3], keeps[:4]

    with torch.no_grad():
        fwd = vlm_forward(model, arch, input_ids=tb["input_ids"][0].long(), plan=cb.plan,
                          pixels=tb["pixels"][0], labels=tb["labels"][0], use_pdrop=True)
    np.testing.assert_array_equal(fwd["labels"].numpy(), np.asarray(jlabels))
    got, want = n(fwd["logits"]), n(jlogits)
    assert got.shape == want.shape and got.shape[1] == cb.plan.fused_len - 8
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()
    # the same ranking rows given as query positions, no labels
    starts = np.cumsum([0] + [sum(lay) for lay in cb.plan.sample_layouts])
    qpos = [pdrop_mod._training_query_pos(tb["labels"][0][a:b]) for a, b in
            zip(starts[:-1], starts[1:])]
    with torch.no_grad():
        by_pos = vlm_forward(model, arch, input_ids=tb["input_ids"][0].long(), plan=cb.plan,
                             pixels=tb["pixels"][0], use_pdrop=True,
                             pdrop_query_positions=tuple(qpos))
    np.testing.assert_array_equal(n(by_pos["logits"]), got)


@pytest.mark.parametrize("family", ["nano", "qwen2"])
def test_lora_grad_step_and_accumulation_match_jax(family, tmp_path):
    """grad_step with LoRA and trainable_modules="projector,merge" on two
    microbatches, and the Trainer's one update from them accumulated."""
    arch, _, lp = _setup(family)
    cbs = [_batch(arch, s) for s in (3, 4)]
    grad = _jax_fns(family)[0]
    model = _port(arch, lp)
    params = trainable_params(model, lora=True, trainable_modules=TRAIN)
    for cb in cbs:
        _, grads = grad_step(model, arch, params, {k: t(v) for k, v in cb.batch.items()},
                             cb.plan, use_pdrop=True)
        jg = grad(lp, _jb(cb))[1]
        _close_grads(grads, _port_names({k: np.asarray(v) for k, v in jg.items()}, lp, arch))

    _, want = _jax_steps(family, cbs)
    trainer = Trainer(arch, model, topt.OptimConfig(**OPT),
                      TrainerConfig(run_dir=str(tmp_path / "run"), max_steps=1, lora=True,
                                    trainable_modules=TRAIN, use_pdrop=True, remat=True,
                                    grad_accum_steps=2, resume=False), device="cpu")
    trainer.train(cbs)
    assert trainer.step == 1 and trainer.opt.count == 1
    for name, p in trainer.opt.params.items():
        np.testing.assert_allclose(n(p), n(want[name]), rtol=0,
                                   atol=0.01 * OPT["learning_rate"], err_msg=name)


@pytest.mark.parametrize("family", ["nano", "qwen2"])
def test_trainer_steps_match_jax_and_a_checkpoint_resumes(family, tmp_path):
    """Three Trainer(use_pdrop=True) LoRA steps (the merge modules at their
    own merge_lr), then a resume from the checkpoint."""
    arch, _, lp = _setup(family)
    cb = _batch(arch, 5)
    jm, want = _jax_steps(family, [cb], n_updates=3)
    cfg = TrainerConfig(run_dir=str(tmp_path / "run"), max_steps=3, log_every=1, save_every=3,
                        lora=True, trainable_modules=TRAIN, use_pdrop=True, remat=True,
                        resume=False)
    trainer = Trainer(arch, _port(arch, lp), topt.OptimConfig(**OPT), cfg, device="cpu")
    trainer.train([cb] * 3)
    assert trainer.step == 3 and len(trainer.history) == 3
    for h, m in zip(trainer.history, jm):
        np.testing.assert_allclose(h["loss"], float(m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(h["grad_norm"], float(m["grad_norm"]), rtol=1e-4)
        assert h["grad_norm/merge_modules"] > 0
    merge = [k for k in trainer.opt.params if k.startswith("merge_modules.")]
    assert len(merge) == 2 * (9 if arch.llm.attention_bias else 5)
    for name, p in trainer.opt.params.items():
        np.testing.assert_allclose(n(p), n(want[name]), rtol=0,
                                   atol=0.01 * OPT["learning_rate"], err_msg=name)

    resumed = Trainer(arch, _port(arch, lp), topt.OptimConfig(**OPT),
                      TrainerConfig(run_dir=cfg.run_dir, lora=True, trainable_modules=TRAIN,
                                    use_pdrop=True), device="cpu")
    assert resumed.step == 3 and resumed.opt.count == 3
    for name in merge:
        assert torch.equal(resumed.opt.params[name], trainer.opt.params[name]), name
        assert torch.equal(resumed.opt.nu[name], trainer.opt.nu[name]), name


@pytest.mark.parametrize("B,Lq,Lk,Hq,Hkv", [(1, 32, 205, 4, 2), (2, 5, 17, 4, 4), (1, 1, 1, 2, 1)])
def test_cross_attention_gradients_match_jax_vjp(B, Lq, Lk, Hq, Hkv):
    r = rng(7)
    q, g = (r.standard_normal((B, Lq, Hq, 16), np.float32) for _ in range(2))
    k, v = (r.standard_normal((B, Lk, Hkv, 16), np.float32) for _ in range(2))
    want = jax.jit(lambda *a: jax.vjp(jax_attention.cross_attention, *a[:3])[1](a[3]))(
        q, k, v, g)

    def check(grads):
        for name, a, b in zip("qkv", grads, want):
            # one key: dq and dk are 0 in exact arithmetic (dP = delta); the
            # backward from the forward's output sums dO . v twice, in other
            # orders, and cancels to ~1e-7
            tol = 1e-6 if Lk == 1 and name != "v" else 1e-4 * np.abs(n(b)).max()
            assert np.abs(n(a) - n(b)).max() <= tol

    for fn in (cross_attention, BlockAttnFn.apply):
        leaves = [t(a).requires_grad_() for a in (q, k, v)]
        out = fn(*leaves)
        assert out.grad_fn is not None
        check(torch.autograd.grad(out, leaves, t(g)))
    # the non-causal backward's own plain version, from the forward's output
    check(cross_attention_bwd(t(q), t(k), t(v), out.detach(), t(g), None))
