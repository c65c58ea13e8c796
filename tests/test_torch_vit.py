"""models/vit.py (SigLIP tower, penultimate features) against the JAX
package's vit_forward at tiny_vit_config, f32. Tolerance 1e-4: three blocks
of f32 matmuls, LayerNorms and softmax summed in other orders."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_parity import n, rng, t

from timeviper_tpu.config import tiny_vit_config
from timeviper_tpu.models import vit as jax_vit
from timeviper_tpu_torch.models.vit import ViT, vit_forward
from timeviper_tpu_torch.params import vit_state_dict


def test_vit_forward_matches_jax():
    cfg = tiny_vit_config()
    params = jax.jit(jax_vit.init_vit_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), cfg, jnp.float32)
    model = ViT(cfg, torch.float32)
    model.load_state_dict(vit_state_dict(params, cfg))
    pixels = rng(0).standard_normal((3, 28, 28, 3), np.float32)
    got = vit_forward(model, cfg, t(pixels))
    want = jax.jit(jax_vit.vit_forward, static_argnums=1)(params, cfg, jnp.asarray(pixels))
    assert got.shape == (3, cfg.num_patches, cfg.hidden_size)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-4, atol=1e-4)


def test_vit_reset_parameters_is_seeded():
    cfg = tiny_vit_config()
    a, b = ViT(cfg, torch.float32), ViT(cfg, torch.float32)
    a.reset_parameters(torch.Generator().manual_seed(1))
    b.reset_parameters(torch.Generator().manual_seed(1))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert a.layers[0].norm1.weight.eq(1).all() and a.layers[0].attn["qkv"].bias.eq(0).all()
