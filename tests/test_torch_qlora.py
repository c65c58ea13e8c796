"""QLoRA in the port (train/lora.py:LoRAInt8Linear, train/quantize.py)
against the JAX package's (tests/test_lora.py:test_qlora_*): the LLM
backbone's linears in int8, LoRA factors planted beside them, the forward the
weight-only dequantized product plus the LoRA delta, and gradients into the
factors only.

On a three-layer tiny nano backbone, one layer of each type (every linear
quantized, min_size 0), bridged from
JAX with non-zero lora_b: logits to 1e-5 and factor gradients to 1e-4 of each
factor's largest magnitude (f32 sums in other orders, as
tests/test_torch_pdrop_train.py holds its gradients) against jax.grad of the JAX QLoRA loss with
respect to the factors (the grafted factor set of make_lora_train_step);
zero lora_b is the int8 base; quantizing a LoRA'd model equals planting LoRA
on a quantized one; merge_lora gives the JAX merge's logits (1e-5) and, with
requantize, its int8 kernels exactly and its scales to 1e-6 relative (the
factors' product a b, summed by each library in its own order, moves a
channel's largest magnitude by an f32 ulp or two); one Trainer step moves
only the factors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, rng, t

from timeviper_tpu.config import tiny_nano_config
from timeviper_tpu.models import nano as jax_nano
from timeviper_tpu.train import lora as jax_lora
from timeviper_tpu.train import quantize as jax_quant
from timeviper_tpu_torch.models.nano import NanoModel, nano_forward
from timeviper_tpu_torch.ops.int8_linear import Int8Linear
from timeviper_tpu_torch.params import nano_state_dict
from timeviper_tpu_torch.train.lora import LoRAInt8Linear, add_lora, merge_lora
from timeviper_tpu_torch.train.quantize import quantize_params_int8

CFG = tiny_nano_config(num_hidden_layers=3, hybrid_override_pattern="M*-")
IDS = rng(1).integers(0, CFG.vocab_size, (2, 12))


@functools.lru_cache(maxsize=None)
def _jax():
    """The JAX QLoRA backbone (rank 4, f32 factors, lora_b drawn non-zero),
    its logits and the factor gradients of its mean next-token loss."""
    @jax.jit
    def build(key):
        params = jax_nano.init_nano_params(key, CFG, jnp.float32)
        q = jax_quant.quantize_params_int8(params, min_size=0)
        return jax_lora.add_lora({"llm_backbone": q}, rank=4, key=jax.random.PRNGKey(2),
                                 dtype=jnp.float32)

    r = rng(3)
    lp = jax.tree_util.tree_map_with_path(
        lambda path, x: r.standard_normal(x.shape).astype(np.float32) * 0.05
        if "lora_b" in jax.tree_util.keystr(path) else x, build(jax.random.PRNGKey(0)))
    ids = jnp.asarray(IDS)

    def loss(base, flat):
        out = jax_nano.nano_forward(jax_lora.graft_lora(base, flat)["llm_backbone"], CFG,
                                    input_ids=ids)
        lpx = jax.nn.log_softmax(out["logits"][:, :-1], axis=-1)
        return -jnp.take_along_axis(lpx, ids[:, 1:, None], axis=-1).mean(), out["logits"]

    @jax.jit
    def outputs(lp, flat):  # one compile for every JAX output the tests read
        (_, logits), grads = jax.value_and_grad(loss, argnums=1, has_aux=True)(lp, flat)
        merged = jax_lora.merge_lora(lp)["llm_backbone"]
        requant = jax_lora.merge_lora(lp, requantize=True)["llm_backbone"]
        return (logits, grads, jax_nano.nano_forward(merged, CFG, input_ids=ids)["logits"],
                requant)

    logits, grads, merged_logits, requant = jax.tree_util.tree_map(
        np.asarray, outputs(lp, jax_lora.trainable_lora_state(lp)))
    return (jax.tree_util.tree_map(np.asarray, lp["llm_backbone"]), logits, grads,
            merged_logits, requant)


def _port(tree=None):
    """The port's QLoRA backbone, bridged from the JAX one."""
    model = NanoModel(CFG, torch.float32, "cpu")
    quantize_params_int8(model, min_size=0)
    add_lora(model, rank=4, scope="", dtype=torch.float32)
    if tree is not None:
        model.load_state_dict(nano_state_dict(tree, CFG))
    return model


def _loss(model):
    logits = nano_forward(model, CFG, input_ids=t(IDS))["logits"]
    return torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, CFG.vocab_size), t(IDS)[:, 1:].reshape(-1).long()), logits


def test_qlora_forward_and_factor_grads_match_jax():
    tree, logits, grads, _, _ = _jax()
    model = _port(tree)
    assert sum(isinstance(m, LoRAInt8Linear) for m in model.modules()) * 2 == len(grads)
    loss, got_logits = _loss(model)
    np.testing.assert_allclose(n(got_logits), logits, rtol=1e-5, atol=1e-5)
    named = dict(model.named_parameters())
    train = [k for k in named if ".lora_" in k]
    assert all(not b.requires_grad for b in model.buffers())  # the int8 base has no gradient
    got = dict(zip(train, torch.autograd.grad(loss, [named[k] for k in train])))
    assert len(got) == len(grads)
    for path, w in grads.items():
        k = path.replace("llm_backbone/", "").replace("/", ".")
        np.testing.assert_allclose(n(got[k]), w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1e-6),
                                   err_msg=k)


def test_zero_factors_give_the_int8_base_and_the_order_does_not_matter():
    base = NanoModel(CFG, torch.float32, "cpu")
    base.reset_parameters(torch.Generator().manual_seed(0))
    a, b = _port(), _port()
    sd = base.state_dict()
    quantize_params_int8(base, min_size=0)
    a.load_state_dict({**a.state_dict(), **base.state_dict()})
    with torch.no_grad():
        want = _loss(base)[1]
        np.testing.assert_array_equal(n(_loss(a)[1]), n(want))
        # LoRA first, then quantize: the same int8 weights, the factors kept
        lora_first = NanoModel(CFG, torch.float32, "cpu")
        lora_first.load_state_dict(sd)
        add_lora(lora_first, rank=4, scope="", dtype=torch.float32)
        quantize_params_int8(lora_first, min_size=0)
        b.load_state_dict(lora_first.state_dict())
        for m in (lora_first, b):
            np.testing.assert_array_equal(n(_loss(m)[1]), n(want))


@pytest.mark.parametrize("requantize", [False, True])
def test_merge_matches_jax(requantize):
    tree, logits, _, merged_logits, requant = _jax()
    model = merge_lora(_port(tree), requantize=requantize)
    assert not any(".lora_" in k for k in model.state_dict())
    with torch.no_grad():
        got = _loss(model)[1]
    if requantize:
        assert all(type(m) is not LoRAInt8Linear for m in model.modules())
        want = nano_state_dict(requant, CFG)
        for k, v in model.state_dict().items():
            if k.endswith("kernel_scale"):
                np.testing.assert_allclose(n(v), n(want[k]), rtol=1e-6, err_msg=k)
            else:
                assert torch.equal(v, want[k]), k
        assert np.isfinite(n(got)).all()
    else:
        assert not any(isinstance(m, Int8Linear) for m in model.layers.modules())
        np.testing.assert_allclose(n(got), merged_logits, rtol=1e-5, atol=1e-5)


def test_a_qlora_step_moves_only_the_factors(tmp_path):
    from timeviper_tpu_torch.config import VLMConfig, tiny_vit_config
    from timeviper_tpu_torch.data.loader import collate
    from timeviper_tpu_torch.models.vlm import VLMArch, init_vlm_params
    from timeviper_tpu_torch.train.optim import OptimConfig
    from timeviper_tpu_torch.train.trainer import Trainer, TrainerConfig

    arch = VLMArch(vlm=VLMConfig(arch_specifier="tome_mlp-2"), vision=tiny_vit_config(),
                   llm=CFG)
    model = init_vlm_params(arch, torch.Generator().manual_seed(0), torch.float32, device="cpu")
    quantize_params_int8(model.llm_backbone, min_size=0)
    add_lora(model, rank=4, generator=torch.Generator().manual_seed(1))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    r = rng(4)
    cb = collate([{"input_ids": np.asarray([5, 6, 500, 9, 10, 11]),
                   "labels": np.asarray([-100] * 3 + [9, 10, 11]),
                   "pixels": r.standard_normal((1, 28, 28, 3)).astype(np.float32)}], 500,
                 arch.tokens_per_frame)
    trainer = Trainer(arch, model, OptimConfig(learning_rate=1e-2, schedule="constant"),
                      TrainerConfig(run_dir=str(tmp_path), max_steps=2, save_every=100,
                                    lora=True, resume=False), device="cpu")
    trainer.train(iter([cb, cb]))
    moved = {k for k, v in model.state_dict().items() if not torch.equal(v, before[k])}
    assert moved and all(".lora_" in k for k in moved), sorted(moved)[:4]
    assert any(k.endswith("lora_b") for k in moved)
