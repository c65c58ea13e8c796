"""SSD gradients of the port (ops/ssd_kernel.py:ssd_scan, which on the CPU
is autograd through the plain ops/ssd.py:ssd_chunked) against the JAX
package's Pallas backward kernel K4 (_ssd_pallas_bwd, interpret mode, as
tests/test_ops_ssd_pallas.py runs it) and against jax.vjp of its jnp
ssd_chunked. K4's own CUDA kernel is held against the same plain version on
the card by tests/test_torch_kernels_cuda.py.

Inputs are float32 from a numpy seed; the metric is the RMS error over the
RMS of the reference, below 1e-4 (tests/test_ops_ssd_pallas.py's bound for
the Pallas backward against autodiff).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import packed_seq, rng, t

from timeviper_tpu.ops.ssd import ssd_chunked as jax_ssd_chunked
from timeviper_tpu.ops.ssd_pallas import _ssd_pallas_bwd, _ssd_pallas_fwd
from timeviper_tpu_torch.ops.ssd_kernel import ssd_scan, ssd_scan_bwd

NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "ddt_bias")
NO_LIMIT = (0.0, float("inf"))


def _inputs(seed, B, L, H, P, G, N):
    r = rng(seed)
    return dict(
        x=r.standard_normal((B, L, H, P), np.float32),
        dt=r.standard_normal((B, L, H), np.float32) * 1.5,
        A=-np.exp(r.standard_normal(H).astype(np.float32)),
        Bm=r.standard_normal((B, L, G, N), np.float32),
        Cm=r.standard_normal((B, L, G, N), np.float32),
        D=r.standard_normal(H).astype(np.float32),
        dtb=(r.standard_normal(H) * 0.1).astype(np.float32),
        gy=r.standard_normal((B, L, H, P), np.float32),
        gst=r.standard_normal((B, H, P, N), np.float32),
    )


def _port_grads(v, cs, seq, dt_limit, init=None):
    leaves = [torch.from_numpy(v[k].copy()).requires_grad_()
              for k in ("x", "dt", "A", "Bm", "Cm", "D", "dtb")]
    h0 = None if init is None else torch.from_numpy(init.copy()).requires_grad_()
    y, st = ssd_scan(*leaves[:5], chunk_size=cs, D=leaves[5], dt_bias=leaves[6],
                     dt_limit=dt_limit, seq_idx=None if seq is None else t(seq),
                     initial_state=h0)
    loss = (y * t(v["gy"])).sum() + (st * t(v["gst"])).sum()
    live = leaves + ([h0] if h0 is not None else [])
    return [g.numpy() for g in torch.autograd.grad(loss, live)]


def _close(name, got, want, tol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    rms = np.sqrt((want ** 2).mean()) or 1.0
    rel = np.sqrt(((got - want) ** 2).mean()) / rms
    assert rel < tol, (name, rel)


# (L, chunk, packed (pad, cut) or None, dt_limit): a ragged tail; a -1 left
# pad with a boundary inside a chunk; a boundary on a chunk edge (the cut at
# 32 = 2 chunks of 16); dt_limit clipping that saturates both ends.
CASES = [
    (40, 16, None, NO_LIMIT),
    (40, 16, (5, 23), NO_LIMIT),
    (48, 16, (16, 32), NO_LIMIT),
    (48, 16, (3, 29), (0.05, 1.0)),
]


@pytest.mark.parametrize("L,cs,packed,lim", CASES)
def test_ssd_grads_match_the_jax_backward_kernel(L, cs, packed, lim):
    B, H, P, G, N = 2, 4, 8, 2, 16
    v = _inputs(L, B, L, H, P, G, N)
    seq = packed_seq(B, L, *packed) if packed else None
    got = _port_grads(v, cs, seq, lim)
    j = {k: jnp.asarray(a) for k, a in v.items()}
    jseq = None if seq is None else jnp.asarray(seq)
    _, _, hin = _ssd_pallas_fwd(j["x"], j["dt"], j["A"], j["Bm"], j["Cm"], cs, j["D"],
                                j["dtb"], True, lim, jseq, interpret=True, save_prev=True)
    want = _ssd_pallas_bwd(j["x"], j["dt"], j["A"], j["Bm"], j["Cm"], j["D"], j["dtb"], jseq,
                           hin, j["gy"], j["gst"], cs, True, lim, interpret=True)
    for name, g, w in zip(NAMES, got, want):
        _close(name, g, w)


@pytest.mark.parametrize("packed", [None, (5, 23)])
def test_ssd_grads_match_jax_vjp_with_an_initial_state(packed):
    """jax.vjp of the jnp ssd_chunked, the initial state's cotangent too."""
    B, L, H, P, G, N, cs = 2, 40, 4, 8, 2, 16, 16
    v = _inputs(7, B, L, H, P, G, N)
    h0 = rng(8).standard_normal((B, H, P, N), np.float32)
    seq = packed_seq(B, L, *packed) if packed else None
    got = _port_grads(v, cs, seq, NO_LIMIT, init=h0)

    def f(x, dt, A, Bm, Cm, D, dtb, init):
        return jax_ssd_chunked(x, dt, A, Bm, Cm, chunk_size=cs, D=D, dt_bias=dtb,
                               seq_idx=None if seq is None else jnp.asarray(seq),
                               initial_state=init, return_final_state=True)

    args = [jnp.asarray(v[k]) for k in ("x", "dt", "A", "Bm", "Cm", "D", "dtb")]
    _, vjp = jax.vjp(f, *args, jnp.asarray(h0))
    want = vjp((jnp.asarray(v["gy"]), jnp.asarray(v["gst"])))
    for name, g, w in zip(NAMES + ("dinit",), got, want):
        _close(name, g, w)


def test_ssd_scan_bwd_on_the_cpu_is_the_plain_autograd():
    """K4's wrapper takes its plain version for a CPU tensor: the same
    gradients as differentiating ssd_scan itself."""
    B, L, H, P, G, N, cs = 1, 36, 4, 8, 2, 16, 16
    v = _inputs(3, B, L, H, P, G, N)
    seq = packed_seq(B, L, 4, 20)
    want = _port_grads(v, cs, seq, NO_LIMIT)
    args = [t(v[k]) for k in ("x", "dt", "A", "Bm", "Cm", "D", "dtb")]
    got = ssd_scan_bwd(*args, t(seq), None, t(v["gy"]), t(v["gst"]), cs, NO_LIMIT)
    assert got[-1] is None  # no initial state, no cotangent for it
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6, err_msg=name)
