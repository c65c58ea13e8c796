"""The DINOv2 tower (CLS and register tokens, LayerScale), multi-tower
assembly (one tower and one projector per backbone, tokens interleaved per
frame) and build_arch's other families, against the JAX package. f32, tiny
towers (tests/test_vision_towers.py's pair), same numpy inputs into both
packages. Tolerances: 1e-4 for tower features and visual tokens, 1e-3 for
logits, greedy tokens equal."""

import functools
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, rng, t

from timeviper_tpu.config import VLMConfig, tiny_nano_config, tiny_vit_config
from timeviper_tpu.models import generate as jax_gen
from timeviper_tpu.models import vit as jax_vit
from timeviper_tpu.models import vlm as jax_vlm
from timeviper_tpu.models.api import build_arch as jax_build_arch
from timeviper_tpu_torch import config as tcfg
from timeviper_tpu_torch.models import vit as vit_mod
from timeviper_tpu_torch.models.api import build_arch
from timeviper_tpu_torch.models.generate import Generator
from timeviper_tpu_torch.models.vit import ViT, vit_forward
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch, encode_visual
from timeviper_tpu_torch.ops.layernorm import fused_ln
from timeviper_tpu_torch.params import from_jax_numpy, vit_state_dict

IMG = 500
VLM = VLMConfig(arch_specifier="tome_mlp-2")
DINO = dict(use_class_token=True, num_register_tokens=1, use_layer_scale=True,
            hidden_act="gelu")


def _perturbed(params, seed):
    """Non-trivial 1-D leaves (norms, biases, LayerScale) and prefix tokens,
    so that each counts in the comparison."""
    r = rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.1 * r.standard_normal(a.shape)).astype(np.float32)
        if a.ndim == 1 or (a.ndim == 3 and a.shape[1] <= 4) else np.asarray(a), params)


@functools.lru_cache(maxsize=None)
def _towers():  # built once per file; no test changes it
    towers = (("tiny-a", "siglip", tiny_vit_config()), ("tiny-b", "dinov2", tiny_vit_config(**DINO)))
    ptowers = tuple((bid, fam, tcfg.tiny_vit_config(**asdict(cfg))) for bid, fam, cfg in towers)
    arch = VLMArch(vlm=VLM, vision=ptowers[0][2], llm=tiny_nano_config(), vision_family="multi",
                   vision_backbones=ptowers)
    jarch = jax_vlm.VLMArch(vlm=VLM, vision=towers[0][2], llm=arch.llm, llm_family="nano",
                            vision_family="multi", vision_backbones=towers)
    params = jax.jit(jax_vlm.init_vlm_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jarch, jnp.float32)
    params = _perturbed(params, 3)
    model = TimeViperVLM(arch, torch.float32, device="cpu")
    model.load_state_dict(from_jax_numpy(params, arch))
    return arch, jarch, params, model


@pytest.mark.parametrize("fused", [False, True])
def test_dinov2_tower_matches_jax(fused, monkeypatch):
    """CLS and a register token prepended after the position add, LayerScale
    on both branches, prefix tokens dropped from the features; through the
    plain block loop and through TIMEVIPER_VIT_FUSED_LN=1 (width 128, the
    fused norm's width), one fused_ln per norm."""
    monkeypatch.setenv("TIMEVIPER_VIT_FUSED_LN", "1" if fused else "0")
    cfg = tiny_vit_config(**DINO, hidden_size=128, intermediate_size=256)
    params = jax.jit(jax_vit.init_vit_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), cfg, jnp.float32)
    params = _perturbed(params, 1)
    model = ViT(cfg, torch.float32, "cpu")
    model.load_state_dict(vit_state_dict(params, cfg))
    calls = []
    monkeypatch.setattr(vit_mod, "fused_ln", lambda *a, **k: calls.append(1) or fused_ln(*a, **k))
    px = rng(2).random((2, 28, 28, 3), np.float32)
    got = vit_forward(model, cfg, t(px))
    want = jax_vit.vit_forward(params, cfg, jnp.asarray(px))
    assert got.shape == (2, cfg.num_patches, cfg.hidden_size)
    assert len(calls) == (2 * (cfg.num_hidden_layers - 1) if fused else 0)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-4, atol=1e-4)


def test_multi_tower_encode_visual_matches_jax():
    arch, jarch, params, model = _towers()
    assert arch.tokens_per_frame == jarch.tokens_per_frame == 4
    assert set(model.vision_backbone) == set(params["vision_backbone"]) == {"tiny_a", "tiny_b"}
    pixels = rng(4).random((3, 28, 28, 3), np.float32)
    got = encode_visual(model, arch, t(pixels))
    want = jax.jit(functools.partial(jax_vlm.encode_visual, arch=jarch))(
        params, pixels=jnp.asarray(pixels))
    assert got.shape == (3, 4, arch.llm.hidden_size)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-4, atol=1e-4)


def test_multi_tower_generate_matches_jax():
    arch, jarch, params, model = _towers()
    ids = [5, IMG, IMG, 9]
    pixels = rng(5).random((2, 28, 28, 3), np.float32)
    want = jax_gen.Generator(params, jarch, terminator_ids=[-2], pad_token_id=0,
                             max_new_tokens=4, cache_dtype=jnp.float32).generate(
        ids, pixels=pixels, image_token_id=IMG)
    got = Generator(model, arch, terminator_ids=[-2], pad_token_id=0,
                    max_new_tokens=4).generate(ids, pixels=pixels, image_token_id=IMG)
    assert got.token_ids.tolist() == want.token_ids.tolist()


@pytest.mark.parametrize("vid", ["internvideo2-1b-16-224px", "dinov2-vit-l",
                                 "dinosiglip-vit-so-384px",
                                 "siglip-vit-so400m-384px+dinov2-vit-l"])
def test_build_arch_matches_jax(vid):
    arch = build_arch(tcfg.VLMConfig(vision_backbone_id=vid))
    jarch = jax_build_arch(VLMConfig(vision_backbone_id=vid))
    assert (arch.vision_family, arch.tokens_per_frame, arch.local_num_frames) == (
        jarch.vision_family, jarch.tokens_per_frame, jarch.local_num_frames)
    assert asdict(arch.vision) == asdict(jarch.vision)
    assert [(b, f, asdict(c)) for b, f, c in arch.vision_backbones or ()] == [
        (b, f, asdict(c)) for b, f, c in jarch.vision_backbones or ()]
    with pytest.raises(NotImplementedError):
        build_arch(tcfg.VLMConfig(vision_backbone_id=vid, llm_backbone_id="qwen2.5-7b-instruct"))
