"""models/internvideo2.py and the InternVideo2 VLM path against the JAX
package, f32, on a tiny tower (tests/test_vision_towers.py's: 28 px frames,
clips of 2, width 32, 2 blocks of features) with a tiny Nemotron-H. Same
numpy inputs into both packages. Tolerances: 1e-4 for tower features and
visual tokens (f32 matmuls, norms and softmax summed in other orders), 1e-3
for logits (the SSD orderings' band after several layers), greedy tokens
equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, rng, t

from timeviper_tpu.config import InternVideo2Config as JaxIV2Config
from timeviper_tpu.config import VLMConfig, tiny_nano_config
from timeviper_tpu.models import generate as jax_gen
from timeviper_tpu.models import internvideo2 as jax_iv2
from timeviper_tpu.models import vlm as jax_vlm
from timeviper_tpu_torch.config import InternVideo2Config
from timeviper_tpu_torch.models import internvideo2 as iv2_mod
from timeviper_tpu_torch.models.generate import Generator
from timeviper_tpu_torch.models.internvideo2 import (
    InternVideo2,
    encode_frames_iv2,
    get_3d_sincos_pos_embed,
    internvideo2_forward,
)
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch, encode_visual
from timeviper_tpu_torch.ops.vit_attention import vit_attention_plain
from timeviper_tpu_torch.params import from_jax_numpy, iv2_state_dict

IMG = 500
TINY = dict(image_size=28, patch_size=14, num_frames=2, hidden_size=32, intermediate_size=64,
            num_hidden_layers=3, num_attention_heads=2, x_vis_return_idx=-2)
VLM = VLMConfig(arch_specifier="tome_mlp-2")


@functools.lru_cache(maxsize=None)
def _tower():  # built once per file; no test changes it
    cfg, jcfg = InternVideo2Config(**TINY), JaxIV2Config(**TINY)
    params = jax.jit(jax_iv2.init_internvideo2_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jcfg, jnp.float32)
    # non-trivial norms, LayerScale and CLS, so that each leaf counts
    r = rng(7)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.1 * r.standard_normal(a.shape)).astype(np.float32)
        if a.ndim == 1 or a.shape == (1, 1, 32) else np.asarray(a), params)
    model = InternVideo2(cfg, torch.float32, "cpu")
    model.load_state_dict(iv2_state_dict(params))
    return cfg, jcfg, params, model


@functools.lru_cache(maxsize=None)
def _vlm():  # built once per file; no test changes it
    cfg = InternVideo2Config(**TINY)
    arch = VLMArch(vlm=VLM, vision=cfg, llm=tiny_nano_config(), vision_family="internvideo2")
    jarch = jax_vlm.VLMArch(vlm=VLM, vision=JaxIV2Config(**TINY), llm=arch.llm,
                            llm_family="nano", vision_family="internvideo2")
    params = jax.jit(jax_vlm.init_vlm_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jarch, jnp.float32)
    model = TimeViperVLM(arch, torch.float32, device="cpu")
    model.load_state_dict(from_jax_numpy(params, arch))
    return arch, jarch, params, model


def test_pos_embed_is_the_jax_table():
    """At the real tower's size: 4 temporal positions, a 16 x 16 grid, 1408."""
    np.testing.assert_array_equal(get_3d_sincos_pos_embed(1408, 16, 4),
                                  jax_iv2.get_3d_sincos_pos_embed(1408, 16, 4))


@pytest.mark.parametrize("keep_cls", [False, True])
def test_internvideo2_forward_matches_jax(keep_cls):
    cfg, jcfg, params, model = _tower()
    clips = rng(1).standard_normal((3, 2, 28, 28, 3), np.float32)
    got = internvideo2_forward(model, cfg, t(clips), keep_cls=keep_cls)
    want = jax.jit(jax_iv2.internvideo2_forward, static_argnums=(1, 3))(
        params, jcfg, jnp.asarray(clips), keep_cls)
    assert got.shape == (3, 8 + keep_cls, 32)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-4, atol=1e-4)


def test_encode_frames_iv2_matches_jax_and_runs_the_dispatcher(monkeypatch):
    cfg, jcfg, params, model = _tower()
    frames = rng(2).standard_normal((4, 28, 28, 3), np.float32)
    calls = []
    monkeypatch.setattr(iv2_mod, "encoder_attention",
                        lambda *a: calls.append(a[2].is_contiguous()) or
                        vit_attention_plain(*a))
    got = encode_frames_iv2(model, cfg, t(frames))
    want = jax_iv2.encode_frames_iv2(params, jcfg, jnp.asarray(frames))
    np.testing.assert_allclose(n(got), n(want), rtol=1e-4, atol=1e-4)
    # one call per block, v handed over as a strided slice of qkv
    assert calls == [False] * cfg.effective_depth
    with pytest.raises(ValueError):
        encode_frames_iv2(model, cfg, t(frames[:3]))


def test_reset_parameters_draws_the_jax_init():
    cfg = InternVideo2Config(**TINY)
    model = InternVideo2(cfg, torch.float32, "cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    assert len(model.layers) == cfg.effective_depth == 2
    assert model.layers[0].attn["qkv"].bias is None
    assert model.layers[1].ls2.gamma.eq(1e-5).all() and model.cls_token.eq(0).all()
    np.testing.assert_allclose(n(model.pos_embed[0]), get_3d_sincos_pos_embed(32, 2, 2),
                               rtol=1e-6, atol=1e-7)


def test_encode_visual_with_clip_tome_matches_jax():
    arch, jarch, params, model = _vlm()
    assert arch.local_num_frames == jarch.local_num_frames == 2
    pixels = rng(3).random((4, 28, 28, 3), np.float32)
    got = encode_visual(model, arch, t(pixels))
    want = jax.jit(functools.partial(jax_vlm.encode_visual, arch=jarch))(
        params, pixels=jnp.asarray(pixels))
    assert got.shape == (4, 2, arch.llm.hidden_size)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-4, atol=1e-4)


def test_generate_matches_jax():
    arch, jarch, params, model = _vlm()
    ids = [5] + [IMG] * 4 + [9, 10]
    pixels = rng(4).random((4, 28, 28, 3), np.float32)
    want = jax_gen.Generator(params, jarch, terminator_ids=[-2], pad_token_id=0,
                             max_new_tokens=4, cache_dtype=jnp.float32).generate(
        ids, pixels=pixels, image_token_id=IMG)
    tg = Generator(model, arch, terminator_ids=[-2], pad_token_id=0, max_new_tokens=4)
    got = tg.generate(ids, pixels=pixels, image_token_id=IMG)
    assert got.token_ids.tolist() == want.token_ids.tolist()
    # a chunk that splits a clip raises
    with pytest.raises(ValueError):
        Generator(model, arch, terminator_ids=[-2], max_new_tokens=1, clip_size=3).generate(
            ids, pixels=pixels, image_token_id=IMG)
