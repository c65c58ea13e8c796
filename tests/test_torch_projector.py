"""models/projector.py (ToMe-16 + MLP, here ToMe to 2 tokens at tiny width)
against the JAX package's projector_forward, f32, tolerance 1e-5. Random
features keep the ToMe scores separated, so no merge flips at a near-tie."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, rng, t

from timeviper_tpu.models import projector as jax_proj
from timeviper_tpu_torch.models.projector import Projector, projector_forward
from timeviper_tpu_torch.params import projector_state_dict


@pytest.mark.parametrize("projector_type,compress", [("tome_mlp", True), ("gelu_mlp", False)])
def test_projector_forward_matches_jax(projector_type, compress):
    params = jax_proj.init_projector_params(jax.random.PRNGKey(0), 32, 48, projector_type,
                                            jnp.float32)
    proj = Projector(32, 48, projector_type, torch.float32)
    proj.load_state_dict(projector_state_dict(params))
    feats = rng(0).standard_normal((4, 9, 32), np.float32)
    kw = dict(projector_type=projector_type, num_compressed_tokens=2, compress=compress)
    got = projector_forward(proj, t(feats), **kw)
    fwd = jax.jit(jax_proj.projector_forward, static_argnames=tuple(kw))
    want = fwd(params, jnp.asarray(feats), **kw)
    assert got.shape == ((4, 2, 48) if compress else (4, 9, 48))
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)
