"""K3's and K2's plain versions against the JAX package at the shapes their
CUDA kernels (csrc/vit_attn_qkv.cu, csrc/flash_fwd.cu on csrc/attn_sm90.cuh)
treat specially, and the helpers the K2 wrapper runs in Python.

- vit_attention_qkv_plain against JAX's encoder_attention_qkv (off the TPU it
  splits the heads and runs the jnp oracle, as its own tests run it) for one
  frame of DINOv2-L (T 734 = 1 + 4 + 729, hd 64) and of SigLIP (T 729, hd
  72): the kernel reads q, k and v in place from the fused rows and runs the
  last 30 or 25 keys as a narrow step.
- flash_attention_plain against JAX's flash_attention (its jnp oracle off the
  TPU) at B 3 with a -1 left pad of its own per row (the engine's batched
  prefill), at L 203 (not a multiple of 4: the key ids are padded) and L 1.
- flash_lse_plain, the row log-sum-exp that K2 writes for K2-bwd, against
  torch.logsumexp of the masked, scaled logits (a causal row with the ids of
  its own segment always sees itself, so no row is keyless here);
  pad_key_ids, the key ids as the kernels' TMA reads them.

Tolerance 2e-4 is tests/test_ops_attention_tome.py's; the LSE helper is held
to 1e-5 (f32 on both sides). The kernels themselves are held against these
plain versions on the card by tests/test_torch_kernels_cuda.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, rng, row_pads, t

from timeviper_tpu.ops.flash_pallas import flash_attention as jax_flash_attention
from timeviper_tpu.ops.vit_attention import encoder_attention_qkv as jax_encoder_attention_qkv
from timeviper_tpu_torch.ops.block_attention import pad_key_ids
from timeviper_tpu_torch.ops.flash_attention import flash_attention_plain, flash_lse_plain
from timeviper_tpu_torch.ops.vit_attention import vit_attention_qkv_plain

PADS = (0, 17, 130)  # each row's -1 left pad


@pytest.fixture(scope="module")
def jax_fns():
    """The JAX functions, jitted once for the module."""
    return {
        "qkv": jax.jit(jax_encoder_attention_qkv, static_argnums=(1, 2)),
        "flash": jax.jit(lambda q, k, v, seg: jax_flash_attention(q, k, v, segment_ids=seg)),
    }


@pytest.mark.parametrize("T,hd", [(734, 64), (729, 72)])
def test_vit_qkv_plain_matches_jax_at_the_tower_shapes(jax_fns, T, hd):
    H = 4
    qkv = rng(20).standard_normal((1, T, 3 * H * hd), np.float32)
    got = vit_attention_qkv_plain(t(qkv), H, hd)
    want = jax_fns["qkv"](jnp.asarray(qkv), H, hd)
    assert got.shape == (1, T, H * hd)
    np.testing.assert_allclose(n(got), n(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("L", [203, 1])
def test_flash_plain_matches_jax_with_a_pad_per_row(jax_fns, L):
    r = rng(21)
    B, Hq, Hkv, D = len(PADS), 8, 2, 16
    q = r.standard_normal((B, L, Hq, D), np.float32)
    k, v = (r.standard_normal((B, L, Hkv, D), np.float32) for _ in range(2))
    seg = row_pads(len(PADS), L, PADS)
    got = flash_attention_plain(t(q), t(k), t(v), segment_ids=t(seg))
    want = jax_fns["flash"](jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg))
    np.testing.assert_allclose(n(got), n(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("L", [203, 1])
def test_flash_lse_plain_is_the_masked_logsumexp(L):
    r = rng(22)
    B, Hq, Hkv, D = len(PADS), 8, 2, 16
    q = t(r.standard_normal((B, L, Hq, D), np.float32))
    k = t(r.standard_normal((B, L, Hkv, D), np.float32))
    seg = t(row_pads(len(PADS), L, PADS))
    got = flash_lse_plain(q, k, seg)
    assert got.shape == (B, Hq, L) and got.dtype == torch.float32
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(Hq // Hkv, 2)) / math.sqrt(D)
    pos = torch.arange(L)
    keep = (pos[None, :, None] >= pos[None, None, :]) & (seg[:, :, None] == seg[:, None, :])
    want = torch.logsumexp(s.masked_fill(~keep[:, None], -math.inf), dim=-1)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("L", [203, 204, 1])
def test_pad_key_ids_gives_whole_16_byte_rows(L):
    seg = t(row_pads(len(PADS), L, PADS))
    got = pad_key_ids(seg)
    assert got.shape == (len(PADS), -(-L // 4) * 4) and got.dtype == torch.int32
    assert got.is_contiguous() and got.data_ptr() % 16 == 0
    assert torch.equal(got[:, :L], seg)
    assert not got[:, L:].any()
