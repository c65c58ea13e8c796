"""K2 (ops/flash_attention.py:flash_attention) against the JAX package's
flash_attention.

On the CPU both sides take their plain path (JAX's flash_attention uses the
jnp oracle off the TPU); tolerance 2e-4 is tests/test_ops_attention_tome.py's.
The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import n, packed_seq, rng, t

from timeviper_tpu.ops.flash_pallas import flash_attention as jax_flash_attention
from timeviper_tpu_torch.ops.flash_attention import flash_attention


@pytest.mark.parametrize("packed", [False, True])
def test_flash_attention_matches_jax(packed):
    r = rng(0)
    B, L, Hq, Hkv, D = 2, 37, 8, 2, 16
    q = r.standard_normal((B, L, Hq, D), np.float32)
    k, v = r.standard_normal((B, L, Hkv, D), np.float32), r.standard_normal((B, L, Hkv, D), np.float32)
    seg = packed_seq(B, L, 6, 20) if packed else None
    got = flash_attention(t(q), t(k), t(v), segment_ids=None if seg is None else t(seg))
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               segment_ids=None if seg is None else jnp.asarray(seg))
    np.testing.assert_allclose(n(got), n(want), rtol=2e-4, atol=2e-4)

