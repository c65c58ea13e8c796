"""K8's plain version (ops/layernorm.py:fused_ln on CPU tensors) against the
JAX package's fused_ln, its Pallas kernel run in interpret mode: all four
variants (plain or residual, bf16-style or int8 output), rows that are not a
multiple of the row block, and the ViT's fused-LN block loop. f32 outputs
within 1e-5; int8 codes equal but for ties, where the two round y * act_inv
from sums taken in another order: at most 0.1% of codes may differ, and
only by 1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, rng, t

from timeviper_tpu.config import tiny_vit_config
from timeviper_tpu.models.vit import init_vit_params
from timeviper_tpu.models.vit import vit_forward as jax_vit_forward
from timeviper_tpu.ops.layernorm import fused_ln as jax_fused_ln
from timeviper_tpu_torch.models import vit as vit_mod
from timeviper_tpu_torch.models.vit import ViT, vit_forward
from timeviper_tpu_torch.ops.layernorm import fused_ln, fused_ln_supported
from timeviper_tpu_torch.params import vit_state_dict


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("D", [128, 256])
def test_fused_ln_matches_jax(D, residual, quant):
    r = rng(D + 2 * residual + quant)
    shape = (3, 13, D)  # 39 rows, blocks of 16
    x = (r.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    res = r.standard_normal(shape).astype(np.float32) if residual else None
    w = (1 + 0.2 * r.standard_normal(D)).astype(np.float32)
    b = (0.1 * r.standard_normal(D)).astype(np.float32)
    inv = np.float32(127.0 / 5.0) if quant else None
    want = jax_fused_ln(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), eps=1e-6,
                        residual=None if res is None else jnp.asarray(res),
                        act_inv=None if inv is None else jnp.asarray(inv),
                        rows_per_block=16, interpret=True)
    got = fused_ln(t(x), t(w), t(b), eps=1e-6, residual=None if res is None else t(res),
                   act_inv=None if inv is None else torch.tensor(inv))
    if residual:
        np.testing.assert_allclose(n(got[0]), n(want[0]), rtol=1e-5, atol=1e-5)
        got, want = got[1], want[1]
    if quant:
        assert got.dtype == torch.int8
        diff = n(got) - n(want)
        assert np.abs(diff).max() <= 1
        assert (diff != 0).mean() <= 1e-3
    else:
        np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)


def test_fused_ln_supported_is_the_jax_gate():
    assert fused_ln_supported(1152) and fused_ln_supported(128)
    assert not fused_ln_supported(32)


def test_vit_fused_ln_blocks_match_jax(monkeypatch):
    """TIMEVIPER_VIT_FUSED_LN=1 (no int8): the port's fused-LN block loop
    against the JAX package's, f32, within 1e-4 after two blocks."""
    monkeypatch.setenv("TIMEVIPER_VIT_FUSED_LN", "1")
    cfg = tiny_vit_config(hidden_size=128, intermediate_size=256)
    params = jax.jit(init_vit_params, static_argnums=(1, 2))(jax.random.PRNGKey(0), cfg,
                                                             jnp.float32)
    model = ViT(cfg, torch.float32, "cpu")
    model.load_state_dict(vit_state_dict(params, cfg))
    px = rng(3).random((2, 28, 28, 3), np.float32)
    calls = []
    monkeypatch.setattr(vit_mod, "fused_ln",
                        lambda *a, **k: calls.append(1) or fused_ln(*a, **k))
    got = vit_forward(model, cfg, t(px))
    assert len(calls) == 2 * (cfg.num_hidden_layers - 1)
    want = jax_vit_forward(params, cfg, jnp.asarray(px))
    np.testing.assert_allclose(n(got), n(want), rtol=1e-4, atol=1e-4)
