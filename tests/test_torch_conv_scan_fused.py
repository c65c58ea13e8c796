"""K5's plain version (ops/ssd_kernel.py:ssd_conv_scan_fused on CPU
tensors) against the JAX package's ssd_conv_scan_fused, its Pallas kernel
run in interpret mode, as tests/test_ops_ssd_pallas.py:142-179 runs it: L 512
unpacked, L 500 packed, C's conv without a bias; plus the Generator's -1 left
pads with a segment boundary inside a chunk. f32, within the JAX test's 3e-4.
Also: the port's Mamba prefill with fused_conv takes the fused call, which is
inference only."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, packed_seq, rng, t

from timeviper_tpu.ops.ssd_pallas import ssd_conv_scan_fused as jax_fused
from timeviper_tpu_torch.config import tiny_nano_config
from timeviper_tpu_torch.models import nano as nano_mod
from timeviper_tpu_torch.models.nano import MambaMixer, mamba_mixer_forward
from timeviper_tpu_torch.ops.ssd_kernel import ssd_conv_scan_fused


def _inputs(L, seed=0):
    B, H, P, G, N, K = 1, 4, 32, 2, 64, 4
    di, gn = H * P, G * N
    r = rng(seed)
    f = lambda *s, k=1.0: (r.standard_normal(s) * k).astype(np.float32)  # noqa: E731
    wB = f(gn, K, k=0.3)
    return dict(x=f(B, L, H, P), dt=f(B, L, H, k=0.5), A=-np.exp(f(H)), B=f(B, L, G, N),
                C=f(B, L, G, N), D=f(H), dtb=f(H, k=0.1), wx=f(di, K, k=0.3),
                bx=np.linspace(-0.1, 0.1, di, dtype=np.float32), wB=wB,
                bB=np.linspace(0.1, -0.1, gn, dtype=np.float32),
                wC=(np.roll(wB, 1, axis=0) * 0.7).astype(np.float32))


@pytest.mark.parametrize("L,seq", [(512, None), (500, "thirds"), (300, "pads")])
def test_fused_conv_scan_matches_jax(L, seq):
    c = _inputs(L)
    if seq == "thirds":  # the JAX test's packing
        seq = (np.arange(L)[None] // (L // 3)).astype(np.int32)
    elif seq == "pads":  # 37 left pads of -1, a boundary inside the second chunk
        seq = packed_seq(1, L, 37, 170)
    jconv = {"wx": jnp.asarray(c["wx"]), "bx": jnp.asarray(c["bx"]), "wB": jnp.asarray(c["wB"]),
             "bB": jnp.asarray(c["bB"]), "wC": jnp.asarray(c["wC"]), "bC": None}
    want_y, want_st = jax_fused(
        jnp.asarray(c["x"]), jnp.asarray(c["dt"]), jnp.asarray(c["A"]), jnp.asarray(c["B"]),
        jnp.asarray(c["C"]), jconv, chunk_size=128, D=jnp.asarray(c["D"]),
        dt_bias=jnp.asarray(c["dtb"]), seq_idx=None if seq is None else jnp.asarray(seq),
        interpret=True)
    conv = {"wx": t(c["wx"]), "bx": t(c["bx"]), "wB": t(c["wB"]), "bB": t(c["bB"]),
            "wC": t(c["wC"]), "bC": None}
    got_y, got_st = ssd_conv_scan_fused(
        t(c["x"]), t(c["dt"]), t(c["A"]), t(c["B"]), t(c["C"]), conv, chunk_size=128,
        D=t(c["D"]), dt_bias=t(c["dtb"]), seq_idx=None if seq is None else t(seq))
    np.testing.assert_allclose(n(got_y), n(want_y), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(n(got_st), n(want_st), rtol=3e-4, atol=3e-4)


def _mixer():
    cfg = tiny_nano_config(chunk_size=128, mamba_head_dim=16)
    m = MambaMixer(cfg, torch.float32, "cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    x = t(rng(2).standard_normal((1, 150, cfg.hidden_size)).astype(np.float32))
    return cfg, m, x, t(packed_seq(1, 150, 9, 70))


def test_prefill_takes_the_fused_call(monkeypatch):
    """fused_conv=True calls ssd_conv_scan_fused, whose plain version is the
    unfused arithmetic: the mixer's output and cache are the same."""
    cfg, m, x, seq = _mixer()
    calls = []
    monkeypatch.setattr(nano_mod, "ssd_conv_scan_fused",
                        lambda *a, **k: calls.append(1) or ssd_conv_scan_fused(*a, **k))
    with torch.no_grad():
        want, wc = mamba_mixer_forward(m, cfg, x, seq, fill_cache=True)
        assert not calls
        got, gc = mamba_mixer_forward(m, cfg, x, seq, fill_cache=True, fused_conv=True)
    assert calls == [1]
    np.testing.assert_allclose(n(got), n(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n(gc["ssm_state"]), n(wc["ssm_state"]), rtol=1e-6, atol=1e-6)
    for k in ("x", "B", "C"):  # the conv state comes from the raw streams
        np.testing.assert_array_equal(n(gc["conv_state"][k]), n(wc["conv_state"][k]))


def test_fused_conv_is_inference_only():
    cfg, m, x, seq = _mixer()
    with pytest.raises(RuntimeError, match="inference only"):
        mamba_mixer_forward(m, cfg, x, seq, fused_conv=True)
