"""K3 (ops/vit_attention.py:vit_attention_qkv) against the JAX package's
whole-frame kernel on the fused qkv layout, and K6's plain version
(vit_attention_plain, encoder_attention) against its whole-clip kernel.

On the CPU the wrapper takes its plain version; the JAX side runs the Pallas
kernel in interpret mode (tests/test_ops_attention_tome.py:155-200), whose
clamped one-pass softmax equals the max-subtracted one at these logits.
Tolerance 2e-4 is that file's. The CUDA kernel itself is held against the
plain version on the card by tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import n, rng, t

from timeviper_tpu.ops.vit_attention import encoder_attention as jax_encoder_attention
from timeviper_tpu.ops.vit_attention import encoder_attention_qkv as jax_encoder_attention_qkv
from timeviper_tpu.ops.vit_attention import vit_attention as jax_vit_attention
from timeviper_tpu.ops.vit_attention import vit_attention_qkv as jax_vit_attention_qkv
from timeviper_tpu_torch.ops.vit_attention import (
    encoder_attention,
    encoder_attention_qkv,
    vit_attention,
    vit_attention_plain,
    vit_attention_qkv,
)


def test_vit_attention_qkv_matches_jax_kernel():
    B, T, H, hd = 2, 100, 2, 64  # H*hd = 128: the TPU kernel's column alignment
    qkv = rng(0).standard_normal((B, T, 3 * H * hd), np.float32)
    got = encoder_attention_qkv(t(qkv), H, hd)
    want = jax_vit_attention_qkv(jnp.asarray(qkv), H, hd, interpret=True)
    np.testing.assert_allclose(n(got), n(want), rtol=2e-4, atol=2e-4)


def test_encoder_attention_qkv_matches_jax_dispatch():
    B, T, H, hd = 2, 50, 3, 24
    qkv = rng(1).standard_normal((B, T, 3 * H * hd), np.float32)
    got = encoder_attention_qkv(t(qkv), H, hd)
    want = jax_encoder_attention_qkv(jnp.asarray(qkv), H, hd)
    np.testing.assert_allclose(n(got), n(want), rtol=2e-4, atol=2e-4)


def test_kernel_refuses_a_cpu_tensor():
    """Only the dispatcher takes the plain version; the kernel never does."""
    with pytest.raises(ValueError):
        vit_attention_qkv(t(rng(2).standard_normal((1, 8, 3 * 2 * 64), np.float32)), 2, 64)



def test_vit_attention_plain_matches_jax_kernel():
    """K6's plain version against the whole-clip Pallas kernel, which pads T
    300 to 384 and hd 88 to 128 and masks the padded columns."""
    B, T, H, hd = 2, 300, 2, 88
    r = rng(3)
    q, k, v = (r.standard_normal((B, T, H, hd), np.float32) for _ in range(3))
    got = vit_attention_plain(t(q), t(k), t(v))
    want = jax_vit_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    assert got.shape == (B, T, H, hd)
    np.testing.assert_allclose(n(got), n(want), rtol=2e-4, atol=2e-4)


def test_encoder_attention_matches_jax_dispatch():
    """v strided, as the InternVideo2 tower hands it over (a column slice of
    the fused qkv buffer)."""
    B, T, H, hd = 2, 50, 3, 24
    qkv = rng(4).standard_normal((B, T, 3 * H * hd), np.float32)
    q, k, v = (qkv[..., i * H * hd:(i + 1) * H * hd].reshape(B, T, H, hd) for i in range(3))
    tv = t(qkv)[..., 2 * H * hd:].view(B, T, H, hd)
    assert not tv.is_contiguous()
    got = encoder_attention(t(np.ascontiguousarray(q)), t(np.ascontiguousarray(k)), tv)
    want = jax_encoder_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(n(got), n(want), rtol=2e-4, atol=2e-4)


def test_vit_attention_kernel_refuses_a_cpu_tensor():
    q = t(rng(5).standard_normal((1, 8, 2, 88), np.float32))
    with pytest.raises(ValueError):
        vit_attention(q, q, q)
