"""K1 (ops/ssd_kernel.py:ssd_scan) against the JAX package's SSD kernel.

On the CPU the wrapper takes its plain version; the JAX side runs the Pallas
kernel in interpret mode, as tests/test_ops_ssd_pallas.py does. Tolerance
1e-4 is that file's. The CUDA kernel itself is held against the plain
version on the card by tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import n, packed_seq, rng, t

from timeviper_tpu.ops.ssd_pallas import ssd_pallas
from timeviper_tpu_torch.ops.ssd_kernel import ssd_scan


def _inputs(seed, B, L, H, P, G, N):
    r = rng(seed)
    return (r.standard_normal((B, L, H, P), np.float32),
            r.standard_normal((B, L, H), np.float32) * 0.5,
            -np.exp(r.standard_normal(H).astype(np.float32)),
            r.standard_normal((B, L, G, N), np.float32),
            r.standard_normal((B, L, G, N), np.float32),
            r.standard_normal(H).astype(np.float32),
            (r.standard_normal(H) * 0.1).astype(np.float32))


@pytest.mark.parametrize("n_groups", [2, 8])
@pytest.mark.parametrize("packed", [False, True])
def test_ssd_scan_matches_jax_kernel(n_groups, packed):
    """H = 8 heads over 2 or 8 groups (head h reads group h // (H/G)); L = 40
    leaves a ragged tail after two chunks of 16; packed rows carry a -1 pad
    segment and a boundary inside a chunk."""
    B, L, H, P, N = 2, 40, 8, 16, 32
    x, dt, A, Bm, Cm, D, dtb = _inputs(0, B, L, H, P, n_groups, N)
    seq = packed_seq(B, L, 5, 23) if packed else None
    yt, st = ssd_scan(t(x), t(dt), t(A), t(Bm), t(Cm), chunk_size=16, D=t(D),
                      dt_bias=t(dtb), seq_idx=None if seq is None else t(seq))
    yj, sj = ssd_pallas(*(jnp.asarray(v) for v in (x, dt, A, Bm, Cm)), chunk_size=16,
                        D=jnp.asarray(D), dt_bias=jnp.asarray(dtb),
                        seq_idx=None if seq is None else jnp.asarray(seq), interpret=True)
    np.testing.assert_allclose(n(yt), n(yj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(n(st), n(sj), rtol=1e-4, atol=1e-4)


def test_ssd_scan_initial_state_matches_jax_kernel():
    B, L, H, P, G, N = 1, 48, 4, 8, 2, 16
    x, dt, A, Bm, Cm, D, dtb = _inputs(1, B, L, H, P, G, N)
    h0 = rng(2).standard_normal((B, H, P, N), np.float32)
    yt, st = ssd_scan(t(x), t(dt), t(A), t(Bm), t(Cm), chunk_size=16, D=t(D),
                      dt_bias=t(dtb), initial_state=t(h0))
    yj, sj = ssd_pallas(*(jnp.asarray(v) for v in (x, dt, A, Bm, Cm)), chunk_size=16,
                        D=jnp.asarray(D), dt_bias=jnp.asarray(dtb),
                        initial_state=jnp.asarray(h0), interpret=True)
    np.testing.assert_allclose(n(yt), n(yj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(n(st), n(sj), rtol=1e-4, atol=1e-4)

