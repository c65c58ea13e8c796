"""Gradients of the port's causal flash attention (ops/flash_attention.py,
on the CPU autograd through its plain version) against jax.grad of the JAX
package's flash_attention (ops/flash_pallas.py, which on the CPU runs its
jnp oracle, the function the TPU kernel computes), with GQA, packed segments
and a -1 left pad. K2-bwd's own CUDA kernel is held against the same plain
version on the card by tests/test_torch_kernels_cuda.py. float32; tolerance
1e-5, what two f32 evaluations of the same formulas leave."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, packed_seq, rng, t

from timeviper_tpu.ops.flash_pallas import flash_attention as jax_flash_attention
from timeviper_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("Hq,Hkv,packed", [(4, 2, None), (8, 2, (3, 11)), (4, 4, (6, 16))])
def test_flash_grads_match_jax(Hq, Hkv, packed):
    B, L, D = 2, 24, 16
    r = rng(Hq + Hkv)
    q, k, v = (r.standard_normal((B, L, h, D), np.float32) for h in (Hq, Hkv, Hkv))
    g = r.standard_normal((B, L, Hq, D), np.float32)
    seg = packed_seq(B, L, *packed) if packed else None

    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*leaves, segment_ids=None if seg is None else t(seg))
    got = torch.autograd.grad(out, leaves, t(g))

    def f(q, k, v):
        return jax_flash_attention(q, k, v, segment_ids=None if seg is None else jnp.asarray(seg))

    @jax.jit  # one compile a case, not one per primitive
    def fwd_bwd(q, k, v, g):
        o, vjp = jax.vjp(f, q, k, v)
        return o, vjp(g)

    want_out, want = fwd_bwd(*(jnp.asarray(a) for a in (q, k, v, g)))
    np.testing.assert_allclose(n(out), n(want_out), **TOL)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(n(a), n(b), err_msg=name, **TOL)

    # K2-bwd's wrapper on CPU tensors is the same plain autograd
    bwd = flash_attention_bwd(t(q), t(k), t(v), out.detach(), t(g), None,
                              None if seg is None else t(seg))
    for name, a, b in zip(("dq", "dk", "dv"), bwd, got):
        np.testing.assert_allclose(n(a), n(b), err_msg=name, rtol=1e-6, atol=1e-6)
