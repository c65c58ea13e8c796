"""K3 (ops/vit_attention.py:vit_attention_qkv) against the JAX package's
whole-frame kernel on the fused qkv layout.

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

from timeviper_tpu.ops.vit_attention import encoder_attention_qkv as jax_encoder_attention_qkv
from timeviper_tpu.ops.vit_attention import vit_attention_qkv as jax_vit_attention_qkv
from timeviper_tpu_torch.ops.vit_attention import encoder_attention_qkv, vit_attention_qkv


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

