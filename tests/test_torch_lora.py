"""LoRA (train/lora.py) against the JAX package's train/lora.py: factors
planted by the JAX add_lora bridge into the port (params.py) and give the
same forward; merge_lora folds them the same way; the targets, the split and
the trainable set agree. f32, tiny VLM; logits tolerance 1e-3 as in
tests/test_torch_vlm.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_parity import n, rng, t

from timeviper_tpu.config import VLMConfig, tiny_nano_config, tiny_vit_config
from timeviper_tpu.data.fusion import plan_fusion
from timeviper_tpu.models import vlm as jax_vlm
from timeviper_tpu.train import lora as jax_lora
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch, vlm_forward
from timeviper_tpu_torch.params import from_jax_numpy
from timeviper_tpu_torch.train.lora import (
    LoRALinear,
    add_lora,
    merge_lora,
    split_lora_state,
    trainable_lora_state,
)

VLM = VLMConfig(arch_specifier="tome_mlp-2")
IMG = 500
TOL = dict(rtol=1e-3, atol=1e-3)


def _setup():
    arch = VLMArch(vlm=VLM, vision=tiny_vit_config(), llm=tiny_nano_config())
    jarch = jax_vlm.VLMArch(vlm=VLM, vision=arch.vision, llm=arch.llm, llm_family="nano")
    params = jax.jit(jax_vlm.init_vlm_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jarch, jnp.float32)
    lp = jax_lora.add_lora(params, rank=4, alpha=8.0, key=jax.random.PRNGKey(1))
    # non-zero B factors, so the delta shows in the forward
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


def _port(arch, jparams):
    model = TimeViperVLM(arch, torch.float32, device="cpu")
    add_lora(model, rank=4, alpha=8.0, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(from_jax_numpy(jparams, arch))
    return model


def _logits(model, arch, jarch, jparams):
    ids = np.array([5, 6, IMG, IMG, 9, 10, 11])
    pixels = rng(0).random((2, 28, 28, 3), np.float32)
    plan = plan_fusion(ids, IMG, arch.tokens_per_frame)
    want = jax.jit(functools.partial(jax_vlm.vlm_forward, arch=jarch, plan=plan))(
        jparams, input_ids=jnp.asarray(ids), pixels=jnp.asarray(pixels))["logits"]
    got = vlm_forward(model, arch, input_ids=t(ids), plan=plan, pixels=t(pixels))["logits"]
    return got, want


def test_lora_bridge_gives_the_jax_forward_and_the_same_targets():
    arch, jarch, lp = _setup()
    model = _port(arch, lp)
    jax_targets = {p.rsplit("/", 1)[0] for p in jax_lora.split_lora_state(lp)[0]}
    port_targets = {name.replace(".", "/") for name, m in model.named_modules()
                    if isinstance(m, LoRALinear)}
    assert port_targets == jax_targets and len(port_targets) == 3 * 6 + 4 + 2 * 2
    got, want = _logits(model, arch, jarch, lp)
    np.testing.assert_allclose(n(got), n(want), **TOL)
    lora, rest = split_lora_state(model)
    assert {k.replace(".", "/") for k in lora} == set(jax_lora.split_lora_state(lp)[0])
    assert not any("lora" in k for k in rest)
    trainable = trainable_lora_state(model, "projector")
    want_names = set(jax_lora.trainable_lora_state(lp, "projector"))
    assert {k.replace(".", "/").replace("/weight", "/kernel") for k in trainable} == want_names


def test_zero_init_is_the_base_model_and_merge_matches_jax():
    arch, jarch, lp = _setup()
    base = TimeViperVLM(arch, torch.float32, device="cpu")
    base.load_state_dict(from_jax_numpy(jax_lora.merge_lora(lp), arch))
    model = _port(arch, lp)
    got_lora, _ = _logits(model, arch, jarch, lp)
    merge_lora(model)
    assert not any(isinstance(m, LoRALinear) for m in model.modules())
    for (k, a), (k2, b) in zip(model.state_dict().items(), base.state_dict().items()):
        assert k == k2
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-6, err_msg=k)
    got_merged, _ = _logits(model, arch, jarch, lp)
    np.testing.assert_allclose(n(got_merged), n(got_lora), **TOL)

    fresh = TimeViperVLM(arch, torch.float32, device="cpu")
    fresh.load_state_dict(base.state_dict())
    before = _logits(fresh, arch, jarch, lp)[0]
    add_lora(fresh, generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(n(_logits(fresh, arch, jarch, lp)[0]), n(before))
