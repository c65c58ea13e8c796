"""The model pieces that were the port's last refusals, against the JAX
package, f32 on the CPU:

- nano with tied embeddings (no lm_head; logits from the embedding table);
- the `fused_tome_mlp` projector (fc0, vision width -> 4 x, exact GELU, before
  fc1);
- the ViT position table resized to the input's grid whenever the two differ
  (jax.image.resize's cubic): growing (a 2 x 2 table fed a 3 x 3 grid, as
  siglip-vit-so400m's 16 x 16 fed 384 px) and shrinking (4 x 4 -> 3 x 3, as a
  DINOv2 checkpoint's 37 x 37 at 27 x 27), through `vit_forward` with the
  table bridged at its own size, and the resize alone at the real grids;
- InternVideo2's `interpolate_pos_embed` (host numpy: temporal linear, then
  torch's bicubic) against the JAX package's numpy;
- InternVideo2's `attention_pool`, its leaves bridged from the JAX init.

Tolerances: 1e-5 where one f32 formula runs in both packages, 1e-4 for
tower features, 1e-3 for logits after six layers (tests/test_torch_nano.py's
band)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, rng, t

from timeviper_tpu.config import InternVideo2Config as JaxIV2Config
from timeviper_tpu.config import tiny_nano_config, tiny_vit_config
from timeviper_tpu.models import internvideo2 as jax_iv2
from timeviper_tpu.models import nano as jax_nano
from timeviper_tpu.models import projector as jax_proj
from timeviper_tpu.models import vit as jax_vit
from timeviper_tpu_torch import config as tcfg
from timeviper_tpu_torch.config import InternVideo2Config
from timeviper_tpu_torch.models.internvideo2 import (
    InternVideo2,
    attention_pool,
    interpolate_pos_embed,
    internvideo2_forward,
)
from timeviper_tpu_torch.models.nano import NanoModel, nano_forward
from timeviper_tpu_torch.models.projector import Projector, projector_forward
from timeviper_tpu_torch.models.vit import ViT, resize_pos_embed, vit_forward
from timeviper_tpu_torch.params import (
    iv2_state_dict,
    nano_state_dict,
    projector_state_dict,
    vit_state_dict,
)

IV2 = dict(image_size=28, patch_size=14, num_frames=2, hidden_size=32, intermediate_size=64,
           num_hidden_layers=3, num_attention_heads=2, x_vis_return_idx=-2,
           clip_embed_dim=24, attn_pool_num_heads=4)


def test_nano_with_tied_embeddings_matches_jax():
    cfg = tiny_nano_config(tie_word_embeddings=True)
    params = jax.jit(jax_nano.init_nano_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), cfg, jnp.float32)
    assert "lm_head" not in params
    model = NanoModel(tcfg.tiny_nano_config(tie_word_embeddings=True), torch.float32, "cpu")
    assert model.lm_head is None
    model.load_state_dict(nano_state_dict(params, cfg))
    ids = rng(0).integers(0, cfg.vocab_size, (2, 24))
    want = jax.jit(functools.partial(jax_nano.nano_forward, cfg=cfg))(
        params, input_ids=jnp.asarray(ids))["logits"]
    got = nano_forward(model, model.cfg, input_ids=t(ids))["logits"]
    np.testing.assert_allclose(n(got), n(want), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("compress", [True, False])
def test_fused_tome_mlp_projector_matches_jax(compress):
    params = jax_proj.init_projector_params(jax.random.PRNGKey(0), 32, 48, "fused_tome_mlp",
                                            jnp.float32)
    proj = Projector(32, 48, "fused_tome_mlp", torch.float32, "cpu")
    assert proj.fc0.weight.shape == (128, 32) and proj.fc1.weight.shape == (48, 128)
    proj.load_state_dict(projector_state_dict(params))
    feats = rng(1).standard_normal((4, 9, 32), np.float32)
    kw = dict(projector_type="fused_tome_mlp", num_compressed_tokens=2, compress=compress)
    got = projector_forward(proj, t(feats), **kw)
    want = jax.jit(jax_proj.projector_forward, static_argnames=tuple(kw))(
        params, jnp.asarray(feats), **kw)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("g0,grid", [(16, 27), (37, 27), (27, 16)])
def test_position_table_resize_matches_jax_image_resize(g0, grid):
    """The resize alone at the real grids: siglip-vit-so400m's 16 x 16 fed
    384 px, a DINOv2 checkpoint's 37 x 37 at the registry's 27 x 27, and
    27 -> 16."""
    pos = rng(2).standard_normal((1, g0 * g0, 16)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(pos).reshape(1, g0, g0, 16), (1, grid, grid, 16),
                            method="cubic").reshape(1, grid * grid, 16)
    got = resize_pos_embed(t(pos), grid)
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("table,pixels", [(2, 42), (4, 42)])
def test_vit_resizes_its_loaded_table_as_jax(table, pixels):
    """A DINOv2-style tower (CLS, a register, LayerScale) whose pos_embed
    comes from the tree at `table` x `table` and is fed a 3 x 3 grid: the
    bridge gives the module the loaded size, vit_forward resizes it."""
    cfg = tiny_vit_config(use_class_token=True, num_register_tokens=1, use_layer_scale=True,
                          hidden_act="gelu")
    params = jax.jit(jax_vit.init_vit_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), cfg, jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, params)
    params["pos_embed"] = rng(3).standard_normal((1, table * table, 32)).astype(np.float32)
    pcfg = tcfg.tiny_vit_config(**{f.name: getattr(cfg, f.name)
                                   for f in dataclasses.fields(cfg)})
    model = ViT(pcfg, torch.float32, "cpu")
    model.load_state_dict(vit_state_dict(params, cfg))
    assert model.pos_embed.shape == (1, table * table, 32)
    px = rng(4).random((2, pixels, pixels, 3), np.float32)
    got = vit_forward(model, pcfg, t(px))
    want = jax.jit(functools.partial(jax_vit.vit_forward, cfg=cfg))(params, pixels=jnp.asarray(px))
    assert got.shape == (2, 9, 32)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("orig_t,new_t,orig_grid,new_grid", [(8, 4, 16, 16), (4, 8, 2, 3),
                                                             (4, 4, 16, 12), (1, 1, 4, 6)])
def test_interpolate_pos_embed_matches_jax(orig_t, new_t, orig_grid, new_grid):
    pos = rng(5).standard_normal((1, orig_t * orig_grid ** 2 + 1, 24))
    want = jax_iv2.interpolate_pos_embed(pos, orig_t, new_t, new_grid)
    got = interpolate_pos_embed(pos, orig_t, new_t, new_grid)
    assert got.dtype == np.float32 and got.shape == (1, new_t * new_grid ** 2 + 1, 24)
    np.testing.assert_array_equal(got, want)


def test_attention_pool_matches_jax():
    """The pooling head on the tower's features with CLS kept
    (internvideo2_forward(keep_cls=True)), its leaves from the JAX init with
    non-trivial norms and biases, bridged with the tower's."""
    jcfg, cfg = JaxIV2Config(**IV2), InternVideo2Config(**IV2)
    tower = jax.jit(jax_iv2.init_internvideo2_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jcfg, jnp.float32)
    pool = jax_iv2.init_attention_pool_params(jax.random.PRNGKey(1), jcfg, jnp.float32)
    r = rng(6)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.1 * r.standard_normal(a.shape)).astype(np.float32)
        if a.ndim == 1 else np.asarray(a), dict(tower, attn_pool=pool))
    model = InternVideo2(cfg, torch.float32, "cpu", attn_pool=True)
    model.load_state_dict(iv2_state_dict(tree))
    clips = r.random((2, 2, 28, 28, 3), np.float32)
    feats = jax.jit(functools.partial(jax_iv2.internvideo2_forward, cfg=jcfg, keep_cls=True))(
        tree, clips=jnp.asarray(clips))
    want = jax.jit(functools.partial(jax_iv2.attention_pool, cfg=jcfg))(
        tree["attn_pool"], x=feats)
    got = attention_pool(model.attn_pool,
                         internvideo2_forward(model, cfg, t(clips), keep_cls=True))
    assert got.shape == (2, 24)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-4, atol=1e-4)


@torch.no_grad()
def test_attention_pool_init_draws_as_jax():
    """N(0, 0.02) matrices, zero biases, unit LayerNorms: the same
    statistics as JAX init_attention_pool_params."""
    cfg = InternVideo2Config(**IV2)
    model = InternVideo2(cfg, torch.float32, "cpu", attn_pool=True)
    model.reset_parameters(torch.Generator().manual_seed(0))
    pool = model.attn_pool
    for lin in (pool.q, pool.k, pool.v, pool.proj):
        assert lin.bias.abs().max() == 0 and abs(float(lin.weight.std()) - 0.02) < 0.005
    for norm in (pool.norm1_q, pool.norm1_k, pool.norm1_v):
        assert torch.equal(norm.weight, torch.ones(32)) and norm.bias.abs().max() == 0
    assert pool.proj.weight.shape == (24, 32)
