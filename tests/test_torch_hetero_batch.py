"""Heterogeneous batches in the port (data/loader.py:collate_hetero,
models/vlm.py:vlm_loss and vlm_forward_dynamic) against the JAX package's
(tests/test_hetero_batch.py): rows with other lengths, frame counts and
image positions batch together, each row's plan as data, its pads in a
trailing segment of their own.

The collated arrays and the copied HeteroPlan / pad_row_plan equal the JAX
package's exactly. The loss of a heterogeneous batch equals the mean of each
row's loss through the static one-row path, on both backbones, to rtol 2e-4
(the JAX test's tolerance), and the JAX package's heterogeneous loss to 1e-5;
one row through vlm_forward_dynamic gives the JAX function's logits to 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, rng, t

from timeviper_tpu.config import VLMConfig, tiny_nano_config, tiny_qwen2_config, tiny_vit_config
from timeviper_tpu.data import fusion as j_fusion
from timeviper_tpu.data import loader as j_loader
from timeviper_tpu.models import vlm as jax_vlm
from timeviper_tpu.train import step as jstep
from timeviper_tpu_torch.data import fusion as t_fusion
from timeviper_tpu_torch.data.loader import collate
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch, vlm_forward_dynamic, vlm_loss
from timeviper_tpu_torch.params import from_jax_numpy
from timeviper_tpu_torch.train.optim import OptimConfig
from timeviper_tpu_torch.train.trainer import Trainer, TrainerConfig

IMG = 500
VLM = VLMConfig(arch_specifier="tome_mlp-2")


def _items(seed=1):
    r = rng(seed)
    a_ids = np.asarray([5, 6, IMG, IMG, 9, 10, 11, 12])
    b_ids = np.asarray([5, IMG, 9, 10, 11])
    return [
        {"input_ids": a_ids, "labels": np.asarray([-100] * 5 + [10, 11, 12]),
         "pixels": r.standard_normal((2, 28, 28, 3)).astype(np.float32)},
        {"input_ids": b_ids, "labels": np.asarray([-100] * 2 + [9, 10, 11]),
         "pixels": r.standard_normal((1, 28, 28, 3)).astype(np.float32)},
    ]


@functools.lru_cache(maxsize=None)
def _models(family):
    llm = tiny_nano_config() if family == "nano" else tiny_qwen2_config()
    arch = VLMArch(vlm=VLM, vision=tiny_vit_config(), llm=llm, llm_family=family)
    jarch = jax_vlm.VLMArch(vlm=VLM, vision=arch.vision, llm=llm, llm_family=family)
    params = jax.jit(jax_vlm.init_vlm_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jarch, jnp.float32)
    model = TimeViperVLM(arch, torch.float32, device="cpu")
    model.load_state_dict(from_jax_numpy(params, arch))
    return arch, jarch, params, model


def test_collate_matches_jax_and_pads_a_fresh_segment():
    items = _items()
    got = collate(items, IMG, 2)
    want = j_loader.collate(items, IMG, 2)
    assert isinstance(got.plan, t_fusion.HeteroPlan)
    assert got.plan == t_fusion.HeteroPlan(**{f: getattr(want.plan, f) for f in
                                              ("fused_len", "text_len", "num_visual",
                                               "num_frames")})
    assert set(got.batch) == set(want.batch)
    for k, v in want.batch.items():
        np.testing.assert_array_equal(got.batch[k], v, err_msg=k)
        assert got.batch[k].dtype == v.dtype, k
    seq_b = got.batch["seq_idx"][1]
    assert seq_b[-1] > seq_b[0] and (got.batch["labels"][1][got.plan.fused_len - 2:] == -100).all()
    # a padded and a packed row remap as the JAX package remaps them
    for ids, lens in (([5, IMG, 9, 10], None), ([5, IMG, 9, 5, 6, IMG, IMG, 7], [3, 5])):
        tp = t_fusion.plan_fusion(ids, IMG, 2, lens)
        jp = j_fusion.plan_fusion(ids, IMG, 2, lens)
        for dims in ((8, 16, 6), (len(ids), tp.fused_len, tp.num_visual)):
            for a, b in zip(t_fusion.pad_row_plan(tp, *dims), j_fusion.pad_row_plan(jp, *dims)):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        t_fusion.pad_row_plan(t_fusion.plan_fusion([5, IMG, 9], IMG, 2), 2, 8, 2)


@pytest.mark.parametrize("family", ["nano", "qwen2"])
def test_hetero_loss_matches_per_row_static_and_jax(family):
    arch, jarch, params, model = _models(family)
    items = _items()
    cb = collate(items, IMG, arch.tokens_per_frame)
    jb = {k: jnp.asarray(v) for k, v in cb.batch.items()}
    jloss_fn = jstep._make_loss_fn(jarch, j_loader.collate(items, IMG, 2).plan, use_pdrop=False,
                                   remat=False)
    want, _ = jax.jit(jloss_fn)(params, jb)
    tb = {k: t(v) for k, v in cb.batch.items()}
    with torch.no_grad():
        got, aux = vlm_loss(model, arch, tb, cb.plan, remat=False)
        per_row = []
        for it in items:
            row = collate([it], IMG, arch.tokens_per_frame)
            per_row.append(float(vlm_loss(model, arch, {k: t(v) for k, v in row.batch.items()},
                                          row.plan, remat=False)[0]))
    np.testing.assert_allclose(float(got), np.mean(per_row), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert int(aux["n_tokens"]) == 6
    with pytest.raises(ValueError, match="pdrop"):
        vlm_loss(model, arch, tb, cb.plan, use_pdrop=True)


def test_one_dynamic_row_matches_jax():
    arch, jarch, params, model = _models("nano")
    cb = collate(_items(), IMG, arch.tokens_per_frame)
    row = {k: v[1] for k, v in cb.batch.items()}
    want = jax.jit(functools.partial(jax_vlm.vlm_forward_dynamic, arch=jarch))(
        params, input_ids=row["input_ids"], gather_idx=row["gather_idx"],
        seq_idx=row["seq_idx"], pixels=row["pixels"], labels=row["labels"])
    with torch.no_grad():
        got = vlm_forward_dynamic(model, arch, input_ids=t(row["input_ids"]),
                                  gather_idx=t(row["gather_idx"]), seq_idx=t(row["seq_idx"]),
                                  pixels=t(row["pixels"]), labels=t(row["labels"]))
    np.testing.assert_allclose(n(got["logits"]), n(want["logits"]), rtol=1e-4, atol=1e-4)


def test_hetero_batches_train(tmp_path):
    """The Trainer takes heterogeneous batches: two alternating layouts, the
    loss falls (tests/test_hetero_batch.py:test_hetero_batch_trains)."""
    arch, _, params, _ = _models("nano")
    model = TimeViperVLM(arch, torch.float32, device="cpu")
    model.load_state_dict(from_jax_numpy(params, arch))
    a = collate(_items(1), IMG, arch.tokens_per_frame)
    b = collate(_items(2)[::-1], IMG, arch.tokens_per_frame)
    cfg = TrainerConfig(run_dir=str(tmp_path / "run"), max_steps=6, log_every=1,
                        save_every=100, resume=False, remat_policy="scan")
    trainer = Trainer(arch, model, OptimConfig(learning_rate=3e-3, schedule="constant",
                                               total_steps=6), cfg, device="cpu")
    trainer.train(iter([a, b] * 3))
    losses = [h["loss"] for h in trainer.history]
    assert trainer.step == 6 and all(np.isfinite(losses))
    assert losses[-2] < losses[0] and losses[-1] < losses[1], losses
