"""The port's int8 serving pieces against the JAX package's: quantize
(kernel_q and kernel_scale bitwise equal), the W8A8 and weight-only applies
and the prequantized product, the fused in_proj leaf, and calibrated
activation scales (within f32 rounding: the forwards sum in other orders
before the amax). JAX parameters are made by jax.jit with their dicts put
back in insertion order (`jit_in_order`), the order the JAX calibration
pairs maxima with leaves by; the port's calibration pairs them by module,
whatever the order."""

import functools


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from test_torch_int8_generate import jit_in_order
from torch_parity import n, rng, t

from timeviper_tpu.config import tiny_nano_config, tiny_vit_config
from timeviper_tpu.models.nano import init_nano_params as jax_init_nano
from timeviper_tpu.models.nano import nano_forward as jax_nano_forward
from timeviper_tpu.models.vit import init_vit_params as jax_init_vit
from timeviper_tpu.models.vit import vit_forward as jax_vit_forward
from timeviper_tpu.ops import int8_linear as jax_int8
from timeviper_tpu.train import quantize as jax_quant
from timeviper_tpu_torch.models.nano import NanoModel, mamba_in_proj, nano_forward
from timeviper_tpu_torch.models.vit import ViT, vit_forward
from timeviper_tpu_torch.ops.int8_linear import (
    Int8Linear,
    apply_linear_w8a8,
    w8a8_matmul_prequant,
)
from timeviper_tpu_torch.params import nano_state_dict, vit_state_dict
from timeviper_tpu_torch.train.quantize import (
    apply_linear_maybe_quantized,
    calibrate_act_scales,
    fuse_decode_in_proj,
    quantize_params_int8,
)


@functools.lru_cache(maxsize=None)
def _init(which: str, dtype):
    """The JAX init, jitted once a (model, dtype), its dicts in the init's
    order; callers get the same (immutable) arrays."""
    if which == "nano":
        cfg = tiny_nano_config()
        return cfg, jit_in_order(lambda key: jax_init_nano(key, cfg, dtype), jax.random.PRNGKey(0))
    cfg = tiny_vit_config()
    return cfg, jit_in_order(lambda key: jax_init_vit(key, cfg, dtype), jax.random.PRNGKey(1))


def _nano(dtype=jnp.float32):
    cfg, params = _init("nano", dtype)
    model = NanoModel(cfg, torch.float32 if dtype == jnp.float32 else torch.bfloat16, "cpu")
    model.load_state_dict(nano_state_dict(params, cfg))
    return cfg, params, model


def _vit():
    cfg, params = _init("vit", jnp.float32)
    model = ViT(cfg, torch.float32, "cpu")
    model.load_state_dict(vit_state_dict(params, cfg))
    return cfg, params, model


def _leaves(tree, path=()):
    """(path, leaf) of every dict holding kernel_q, in dict order."""
    if isinstance(tree, dict):
        if "kernel_q" in tree:
            yield path, tree
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))


def _module(model, path):
    return model.get_submodule(".".join(path))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_matches_jax_bitwise(dtype):
    cfg, params, model = _nano(dtype)
    qp = jax_quant.quantize_params_int8(params, min_size=1)
    quantize_params_int8(model, min_size=1)
    leaves = list(_leaves(qp))
    assert len(leaves) == sum(isinstance(m, Int8Linear) for m in model.modules()) > 10
    for path, leaf in leaves:
        mod = _module(model, path)
        np.testing.assert_array_equal(mod.kernel_q.numpy(), np.asarray(leaf["kernel_q"]).T)
        np.testing.assert_array_equal(mod.kernel_scale.numpy(), np.asarray(leaf["kernel_scale"]))
    # min_size keeps small kernels in full precision, as in the JAX package
    qbig = jax_quant.quantize_params_int8(params)
    _, _, fresh = _nano(dtype)
    quantize_params_int8(fresh)
    assert len(list(_leaves(qbig))) == sum(isinstance(m, Int8Linear) for m in fresh.modules())


def test_vit_patch_embed_stays_full_precision():
    _, _, model = _vit()
    quantize_params_int8(model, min_size=1)
    assert type(model.patch_embed) is nn.Linear
    assert isinstance(model.layers[0].attn["qkv"], Int8Linear)


def _linear_case(dtype, bias=True):
    r = rng(5)
    kq = r.integers(-127, 128, (48, 40)).astype(np.int8)  # (in, out)
    ks = (r.random(40) * 0.02 + 0.001).astype(np.float32)
    b = (r.standard_normal(40) * 0.1).astype(np.float32)
    x = (r.standard_normal((3, 7, 48)) * 2).astype(np.float32)
    jleaf = {"kernel_q": jnp.asarray(kq), "kernel_scale": jnp.asarray(ks),
             "act_inv": jnp.asarray(np.float32(127 / 6.0))}
    if bias:
        jleaf["bias"] = jnp.asarray(b, dtype)
    mod = Int8Linear(t(kq.T.copy()), t(ks), t(np.asarray(jleaf["bias"], np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32) if bias else None,
        torch.tensor(np.float32(127 / 6.0)))
    tx = t(x).to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    return jleaf, mod, jnp.asarray(x, dtype), tx


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("mxu", [True, False])
def test_apply_linear_w8a8_matches_jax(mxu, dtype):
    jleaf, mod, jx, tx = _linear_case(dtype)
    want = jax_int8.apply_linear_w8a8(jleaf, jx, use_int8_mxu=mxu)
    got = apply_linear_w8a8(mod, tx, use_int8_mxu=mxu)
    assert got.dtype == tx.dtype
    tol = 1e-6 if dtype == jnp.float32 else 1e-2
    if mxu:  # same int8 codes, exact int32 sums, the same epilogue
        tol = 1e-6 if dtype == jnp.float32 else 0
    np.testing.assert_allclose(n(got), np.asarray(want, np.float64), rtol=tol, atol=tol)


def test_w8a8_matmul_prequant_matches_jax():
    jleaf, mod, _, _ = _linear_case(jnp.float32)
    xq = rng(6).integers(-127, 128, (5, 48)).astype(np.int8)
    want = jax_int8.w8a8_matmul_prequant(jleaf, jnp.asarray(xq), jnp.bfloat16)
    got = w8a8_matmul_prequant(mod, t(xq), torch.bfloat16)
    np.testing.assert_array_equal(n(got), np.asarray(want, np.float64))


def test_apply_linear_maybe_quantized_matches_jax():
    jleaf, mod, jx, tx = _linear_case(jnp.float32, bias=False)
    np.testing.assert_allclose(n(apply_linear_maybe_quantized(mod, tx)),
                               np.asarray(jax_quant.apply_linear_maybe_quantized(jleaf, jx)),
                               rtol=1e-6, atol=1e-6)


def test_fuse_decode_in_proj_matches_jax_and_the_split_leaves():
    cfg, params, model = _nano()
    ids = jax.random.randint(jax.random.PRNGKey(2), (1, 12), 0, cfg.vocab_size)
    qp = jax_quant.quantize_params_int8(params, min_size=1)
    qp = jax_quant.calibrate_act_scales(
        lambda p, b: jax_nano_forward(p, cfg, input_ids=b)["logits"], qp, [ids])
    quantize_params_int8(model, min_size=1)
    calibrate_act_scales(lambda m, b: nano_forward(m, cfg, input_ids=b), model,
                         [t(np.asarray(ids)).long()])
    m0 = model.layers[0].mixer
    x = t(rng(3).standard_normal((2, cfg.hidden_size)).astype(np.float32))
    split = mamba_in_proj(m0, cfg, x)
    jfused = jax_quant.fuse_decode_in_proj(qp)
    fuse_decode_in_proj(model)
    assert list(m0.in_proj) == ["fused"]
    want = jfused["layers"][0]["mixer"]["in_proj"]["fused"]
    got = m0.in_proj["fused"]
    np.testing.assert_array_equal(got.kernel_q.numpy(), np.asarray(want["kernel_q"]).T)
    np.testing.assert_array_equal(got.kernel_scale.numpy(), np.asarray(want["kernel_scale"]))
    np.testing.assert_allclose(float(got.act_inv), float(want["act_inv"]), rtol=1e-5)
    # weight-only (the CPU default): the fused leaf gives the split outputs
    for a, b in zip(mamba_in_proj(m0, cfg, x), split):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-6)


def _check_scales(qp, model):
    leaves = list(_leaves(qp))
    n_cal = 0
    for path, leaf in leaves:
        mod = _module(model, path)
        assert ("act_inv" in leaf) == (mod.act_inv is not None), path
        if "act_inv" in leaf:
            n_cal += 1
            np.testing.assert_allclose(float(mod.act_inv), float(leaf["act_inv"]), rtol=1e-5)
    return n_cal


def test_calibrate_vit_matches_jax():
    cfg, params, model = _vit()
    px = rng(4).standard_normal((2, 28, 28, 3)).astype(np.float32)
    qp = jax_quant.quantize_params_int8(params, min_size=1)
    qp = jax_quant.calibrate_act_scales(lambda p, b: jax_vit_forward(p, cfg, b), qp,
                                        [jnp.asarray(px)])
    qp["layers"] = qp["layers"][: cfg.num_hidden_layers - 1]  # the port builds no last block
    quantize_params_int8(model, min_size=1)
    calibrate_act_scales(lambda m, b: vit_forward(m, cfg, b), model, [t(px)])
    assert _check_scales(qp, model) == 4 * (cfg.num_hidden_layers - 1)


def test_calibrate_nano_matches_jax():
    cfg, params, model = _nano()
    batches = [jax.random.randint(jax.random.PRNGKey(s), (1, 10), 0, cfg.vocab_size)
               for s in (3, 4)]
    qp = jax_quant.quantize_params_int8(params, min_size=1)
    qp = jax_quant.calibrate_act_scales(
        lambda p, b: jax_nano_forward(p, cfg, input_ids=b)["logits"], qp, batches)
    quantize_params_int8(model, min_size=1)
    calibrate_act_scales(lambda m, b: nano_forward(m, cfg, input_ids=b), model,
                         [t(np.asarray(b)).long() for b in batches])
    # every linear the forward runs; the lm_head (f32 logits) is never calibrated
    assert _check_scales(qp, model) == sum(isinstance(m, Int8Linear) for m in model.modules()) - 1
    assert model.lm_head.act_inv is None


class _TwoLinears(nn.Module):
    """Registers `late` before `early` but calls `early` first."""

    def __init__(self):
        super().__init__()
        self.late = nn.Linear(8, 8)
        self.early = nn.Linear(8, 8)

    def forward(self, x):
        return self.late(self.early(x) * 100.0)


def test_calibration_pairs_scales_with_modules_not_call_order():
    torch.manual_seed(0)
    model = quantize_params_int8(_TwoLinears(), min_size=1)
    x = torch.randn(4, 8)
    calibrate_act_scales(lambda m, b: m(b), model, [x])
    with torch.no_grad():
        mid = apply_linear_maybe_quantized(model.early, x) * 100.0
    for mod, inp in ((model.early, x), (model.late, mid)):
        want = 127.0 / (float(inp.abs().max()) * 1.05)
        np.testing.assert_allclose(float(mod.act_inv), want, rtol=1e-6)
