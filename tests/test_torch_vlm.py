"""models/vlm.py (encode_visual, fuse_rows, vlm_forward with cache
fill) and models/api.py:build_arch against the JAX package, f32, at tiny
sizes (tiny ViT, ToMe to 2 tokens per frame, tiny Nemotron-H)."""

import functools
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_parity import n, rng, t

from timeviper_tpu.config import VLMConfig, tiny_nano_config, tiny_vit_config
from timeviper_tpu.data.fusion import plan_fusion
from timeviper_tpu.models import vlm as jax_vlm
from timeviper_tpu.models.api import build_arch as jax_build_arch
from timeviper_tpu_torch.config import VLMConfig as PortVLMConfig
from timeviper_tpu_torch.models.api import build_arch
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch, encode_visual, vlm_forward
from timeviper_tpu_torch.params import from_jax_numpy

VLM = VLMConfig(arch_specifier="tome_mlp-2")
IMG = 500


def _models():
    arch = VLMArch(vlm=VLM, vision=tiny_vit_config(), llm=tiny_nano_config())
    jarch = jax_vlm.VLMArch(vlm=VLM, vision=arch.vision, llm=arch.llm, llm_family="nano")
    params = jax.jit(jax_vlm.init_vlm_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jarch, jnp.float32)
    model = TimeViperVLM(arch, torch.float32, device="cpu")
    model.load_state_dict(from_jax_numpy(params, arch))
    return arch, jarch, params, model


def test_encode_and_prefill_match_jax():
    arch, jarch, params, model = _models()
    pixels = rng(0).random((3, 28, 28, 3), np.float32)
    got = encode_visual(model, arch, t(pixels))
    want = jax.jit(functools.partial(jax_vlm.encode_visual, arch=jarch))(
        params, pixels=jnp.asarray(pixels))
    assert got.shape == (3, 2, arch.llm.hidden_size)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-4, atol=1e-4)

    ids = np.array([5, 6, IMG, IMG, IMG, 9, 10, 11])
    plan = plan_fusion(ids, IMG, arch.tokens_per_frame)
    fwd = jax.jit(functools.partial(jax_vlm.vlm_forward, arch=jarch, plan=plan,
                                    fill_cache=True, cache_max_len=16))
    out_j = fwd(params, input_ids=jnp.asarray(ids), pixels=jnp.asarray(pixels))
    out_t = vlm_forward(model, arch, input_ids=t(ids), plan=plan, pixels=t(pixels),
                        fill_cache=True, cache_max_len=16)
    np.testing.assert_allclose(n(out_t["logits"]), n(out_j["logits"]), rtol=1e-3, atol=1e-3)
    assert out_t["cache"]["length"] == plan.fused_len


def test_build_arch_matches_jax_for_the_9b():
    cfg = VLMConfig()  # siglip-vit-so400m-384px + tome_mlp-16 + nano-9b-v2
    arch, jarch = build_arch(PortVLMConfig()), jax_build_arch(cfg)
    # the port's own config classes hold the same fields as the JAX package's
    assert (asdict(arch.vision), asdict(arch.llm), arch.tokens_per_frame) == (
        asdict(jarch.vision), asdict(jarch.llm), jarch.tokens_per_frame)
    # the qwen2 ids build too, with the JAX package's configs
    for lid in ("qwen2.5-7b-instruct", "qwen2.5-7b-base", "qwen2.5-3b-instruct", "qwen2-7b",
                "qwen2-1.5b"):
        arch, jarch = build_arch(PortVLMConfig(llm_backbone_id=lid)), jax_build_arch(
            VLMConfig(llm_backbone_id=lid))
        assert arch.llm_family == jarch.llm_family == "qwen2"
        assert asdict(arch.llm) == asdict(jarch.llm)
