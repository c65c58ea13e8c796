"""K7's plain version (ops/decode_fused.py:fused_mamba_decode on CPU
tensors) against the JAX package's fused_mamba_decode, its Pallas kernel run
in interpret mode, at the JAX test's shapes (tests/test_ops_ssd.py:94-131:
G 2, H 16, P 16, N 128, B 2), f32, within 1e-5; and the port's decode step
with TIMEVIPER_FUSED_DECODE=1 taking the fused call."""

import jax.numpy as jnp
import numpy as np
import torch
from torch_parity import n, rng, t

from timeviper_tpu.config import NanoConfig as JaxNanoConfig
from timeviper_tpu.ops.decode_fused import fused_mamba_decode as jax_fused_decode
from timeviper_tpu.ops.ssd import _process_dt as jax_process_dt
from timeviper_tpu_torch.config import NanoConfig
from timeviper_tpu_torch.models import nano as nano_mod
from timeviper_tpu_torch.models.nano import MambaMixer, mamba_mixer_decode
from timeviper_tpu_torch.ops.decode_fused import fused_mamba_decode, fused_mamba_decode_supported

SHAPES = dict(hidden_size=256, mamba_num_heads=16, mamba_head_dim=16, mamba_n_groups=2,
              ssm_state_size=128, vocab_size=64, num_hidden_layers=1,
              hybrid_override_pattern="M")


def _case(seed=0):
    G, N, H, P, B, K = 2, 128, 16, 16, 2, 4
    d_inner, gn = H * P, G * N
    r = rng(seed)
    f = lambda *s, k=1.0: (r.standard_normal(s) * k).astype(np.float32)  # noqa: E731
    return dict(xr=f(B, d_inner), Bv=f(B, gn), Cv=f(B, gn), dt=f(B, H, k=0.5),
                gate=f(B, d_inner), csx=f(B, d_inner, K), ssm=f(B, H, P, N, k=0.3),
                wx=f(d_inner, K, k=0.3), bx=np.linspace(-0.1, 0.1, d_inner, dtype=np.float32),
                A_log=np.linspace(-1.0, 0.5, H, dtype=np.float32),
                D=np.linspace(0.5, 1.5, H, dtype=np.float32),
                dt_bias=np.linspace(-0.2, 0.2, H, dtype=np.float32),
                nw=np.linspace(0.8, 1.2, d_inner, dtype=np.float32))


def test_fused_decode_matches_jax():
    c = _case()
    cfg = JaxNanoConfig(**SHAPES)
    j = {k: jnp.asarray(v) for k, v in c.items()}
    dtf = jax_process_dt(j["dt"], j["dt_bias"], True, cfg.time_step_limit)
    params = {"conv1d": {"x": {"weight": j["wx"], "bias": j["bx"]}}, "A_log": j["A_log"],
              "D": j["D"], "norm": {"weight": j["nw"]}}
    want = jax_fused_decode(j["xr"], j["Bv"], j["Cv"], dtf, j["gate"], j["csx"], j["ssm"], params,
                            n_groups=2, head_dim=16, eps=cfg.layer_norm_epsilon, interpret=True)
    got = fused_mamba_decode(t(c["xr"]), t(c["Bv"]), t(c["Cv"]), t(np.asarray(dtf)), t(c["gate"]),
                             t(c["csx"]), t(c["ssm"]), t(c["wx"]), t(c["bx"]), t(c["A_log"]),
                             t(c["D"]), t(c["nw"]), n_groups=2, head_dim=16,
                             eps=cfg.layer_norm_epsilon)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(n(g), n(w), rtol=1e-5, atol=1e-5)


def test_fused_decode_supported_drops_only_the_backend_clause():
    assert fused_mamba_decode_supported(NanoConfig(**SHAPES))
    assert fused_mamba_decode_supported(NanoConfig())  # the 9B: CpG 1024, N 128
    assert not fused_mamba_decode_supported(NanoConfig(**{**SHAPES, "ssm_state_size": 64}))
    assert not fused_mamba_decode_supported(NanoConfig(**{**SHAPES, "mamba_head_dim": 8}))


def test_decode_step_takes_the_fused_call(monkeypatch):
    """With the switch on, mamba_mixer_decode calls the fused step (its plain
    version on the CPU) and gives what the unfused step gives, in f32."""
    cfg = NanoConfig(**SHAPES, use_conv_bias=True)
    torch.manual_seed(0)
    m = MambaMixer(cfg, torch.float32, "cpu")
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn_like(p) * 0.05)
    r = rng(1)
    x = t(r.standard_normal((2, 1, 256)).astype(np.float32))
    K, di, gn = cfg.mamba_d_conv, 256, 256
    cache = {"conv_state": {k: t(r.standard_normal((2, c, K)).astype(np.float32))
                            for k, c in (("x", di), ("B", gn), ("C", gn))},
             "ssm_state": t(r.standard_normal((2, 16, 16, 128)).astype(np.float32) * 0.3)}
    calls = []
    monkeypatch.setattr(nano_mod, "fused_mamba_decode",
                        lambda *a, **k: calls.append(1) or fused_mamba_decode(*a, **k))
    monkeypatch.setenv("TIMEVIPER_FUSED_DECODE", "0")
    want, wc = mamba_mixer_decode(m, cfg, x, cache)
    assert not calls
    monkeypatch.setenv("TIMEVIPER_FUSED_DECODE", "1")
    got, gc = mamba_mixer_decode(m, cfg, x, cache)
    assert calls == [1]
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(gc["ssm_state"]), n(wc["ssm_state"]), rtol=1e-5, atol=1e-5)
    for k in ("x", "B", "C"):
        np.testing.assert_array_equal(n(gc["conv_state"][k]), n(wc["conv_state"][k]))
