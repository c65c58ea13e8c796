"""The SSD forward that csrc/ssd_fwd.cu (K1) computes, written out pass by
pass as its kernels run it, against the JAX package's ssd_chunked.

The write-out follows the kernels' split, their order of the sums and their
rounding points:

- chunks of at most four tiles: a longer chunk runs as chunks of four
  tiles (the wrapper's kernel_chunk, 256 rows of 64-row tiles on the card;
  here tiles of 8 rows);
- chunk_state: the row weights w_j = dt_j exp(acs_last - acs_j) (0 outside
  the chunk's last segment), x w rounded, then (x w)^T B summed over the
  chunk's rows;
- state_pass: the f32 walk over the chunks; chunk_scan reads the inbound
  states rounded;
- chunk_scan, per tile of rows i0..: C_i B_j^T in f32 per tile pair, x dt
  rounded; (C_i h_in^T) exp(acs_i0) on the rows of the inbound state's
  segment, plus, for each tile below the block's, M' (x dt)_j with M' = C_i
  B_j^T exp(acs_i0 - acs_j) masked to one segment and rounded; that sum
  times exp(acs_i - acs_i0); plus the diagonal tile's M (x dt)_j, M = C_i
  B_j^T exp(acs_i - acs_j) masked to j <= i and one segment, rounded; plus
  D x; y rounded.

Two modes: with every rounding point the identity, the write-out must match
the JAX package's f32 ssd_chunked (run at the caller's chunk size) to 1e-5
of its RMS, which holds the algebra (the split decay, the inbound state's
weight split the same way, the shorter chunks); with bf16 at the rounding
points (bf16-valued inputs on both sides), to 1e-2 of the largest
magnitude, the tolerance the card tests hold the kernel to. Three cases of
tests/test_torch_ssd_kernel.py's kind: a -1 pad and a boundary inside
chunks, an initial state, and chunks of 64 run as chunks of 32 over 8
groups. The JAX side is jitted once per case in a module fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import packed_seq, rng, t

from timeviper_tpu.ops.ssd import ssd_chunked as jax_ssd_chunked

TILE = 8
CASES = [  # (L, chunk_size, n_groups, packed, initial state)
    (40, 16, 2, (5, 23), False),
    (48, 16, 2, None, True),
    (40, 64, 8, (5, 23), True),
]
B, H, P, N = 2, 8, 16, 32


def _bf16(v):
    return torch.from_numpy(v).to(torch.bfloat16).float().numpy()


def _inputs(seed, L, G):
    r = rng(seed)
    return dict(
        x=_bf16(r.standard_normal((B, L, H, P), np.float32)),
        dt=_bf16(r.standard_normal((B, L, H), np.float32) * 0.5),
        A=-np.exp(r.standard_normal(H).astype(np.float32)),
        Bm=_bf16(r.standard_normal((B, L, G, N), np.float32)),
        Cm=_bf16(r.standard_normal((B, L, G, N), np.float32)),
        D=r.standard_normal(H).astype(np.float32),
        dtb=(r.standard_normal(H) * 0.1).astype(np.float32),
        h0=r.standard_normal((B, H, P, N)).astype(np.float32),
    )


def _rows(v, Lp):
    """v (B, L, ...) padded with zero rows to Lp."""
    return torch.cat([v, v.new_zeros(v.shape[0], Lp - v.shape[1], *v.shape[2:])], 1)


def k1_as_the_kernels_run_it(x, dt, A, Bm, Cm, D, dtb, seq, h0, cs, tile, rnd):
    """(y, final state) from f32 inputs; `rnd` is applied at the kernels'
    bf16 rounding points."""
    Bs, L, H_, P_ = x.shape
    G, N_ = Bm.shape[2:]
    hg = torch.arange(H_) // (H_ // G)
    kc = min(cs, 4 * tile)  # the kernels' chunk
    nc, T = -(-L // kc), kc // tile
    Lp = nc * kc
    seg = torch.zeros(Bs, Lp, dtype=torch.int64) if seq is None else torch.cat(
        [seq.long(), seq[:, -1:].long().expand(Bs, Lp - L)], 1)  # the tail repeats the last id
    segc = seg.reshape(Bs, nc, kc)
    # pass 1: processed dt (0 on the tail), chunk-local cumsum, carry
    dtp = _rows(torch.nn.functional.softplus(dt + dtb), Lp).permute(0, 2, 1).reshape(Bs, H_, nc, kc)
    acs = torch.cumsum(dtp * A[None, :, None, None], -1)
    sprev = torch.cat([segc[:, :1, 0], segc[:, :-1, -1]], 1)  # (B, nc)
    keep = (segc[:, :, 0] == segc[:, :, -1]) & (segc[:, :, 0] == sprev)
    carry = torch.where(keep[:, None], torch.exp(acs[..., -1]), 0.0)  # (B, H, nc)
    xc = _rows(x, Lp).reshape(Bs, nc, kc, H_, P_)
    Bc = _rows(Bm, Lp).reshape(Bs, nc, kc, G, N_)[:, :, :, hg]  # per head
    Cc = _rows(Cm, Lp).reshape(Bs, nc, kc, G, N_)[:, :, :, hg]
    # pass 2: chunk states, (x w)^T B with x w rounded
    last = (segc == segc[:, :, -1:])[:, None]  # rows of the chunk's last segment
    w = torch.where(last, dtp * torch.exp(acs[..., -1:] - acs), 0.0)  # (B, H, nc, kc)
    xw = rnd(xc * w.permute(0, 2, 3, 1)[..., None])
    local = torch.einsum("bcjhp,bcjhn->bchpn", xw, Bc)
    # pass 3: the walk; chunk_scan reads the inbound states rounded
    s = h0.clone() if h0 is not None else torch.zeros(Bs, H_, P_, N_)
    inbound = []
    for c in range(nc):
        inbound.append(s)
        s = s * carry[:, :, c, None, None] + local[:, c]
    hin = rnd(torch.stack(inbound, 1))
    # pass 4: per tile of rows
    y = torch.zeros(Bs, Lp, H_, P_)
    xd = rnd(xc * dtp.permute(0, 2, 3, 1)[..., None])  # x dt rounded
    causal = torch.ones(tile, tile, dtype=torch.bool).tril()
    for c in range(nc):
        for it in range(T):
            i0 = it * tile
            own = slice(i0, i0 + tile)
            Ci, acs_i, seg_i = Cc[:, c, own], acs[:, :, c, own], segc[:, c, own]
            a0 = acs[:, :, c, i0:i0 + 1]
            w_i = torch.where((seg_i == sprev[:, c:c + 1])[:, None], torch.exp(a0), 0.0)
            acc = torch.einsum("bihn,bhpn->bihp", Ci, hin[:, c]) * w_i.permute(0, 2, 1)[..., None]
            for jt in range(it):
                cols = slice(jt * tile, jt * tile + tile)
                cb = torch.einsum("bihn,bjhn->bhij", Ci, Bc[:, c, cols])
                g = torch.exp(a0 - acs[:, :, c, cols])
                same = (seg_i[:, :, None] == segc[:, c, None, cols])[:, None]
                m = rnd(torch.where(same, cb * g[:, :, None, :], 0.0))
                acc = acc + torch.einsum("bhij,bjhp->bihp", m, xd[:, c, cols])
            acc = acc * torch.exp(acs_i - a0).permute(0, 2, 1)[..., None]
            cb = torch.einsum("bihn,bjhn->bhij", Ci, Bc[:, c, own])
            decay = torch.exp(acs_i[..., :, None] - acs_i[..., None, :])
            same = (causal & (seg_i[:, :, None] == seg_i[:, None, :]))[:, None]
            m = rnd(torch.where(same, cb * decay, 0.0))
            acc = acc + torch.einsum("bhij,bjhp->bihp", m, xd[:, c, own])
            y[:, c * kc + i0:c * kc + i0 + tile] = rnd(acc + D[:, None] * xc[:, c, own])
    return y[:, :L], s


@pytest.fixture(scope="module")
def jax_outputs():
    """The JAX package's f32 ssd_chunked for each case, jitted once."""
    out = {}
    for L, cs, G, packed, init in CASES:
        v = _inputs(L + cs + G, L, G)
        seq = None if packed is None else jnp.asarray(packed_seq(B, L, *packed))
        fn = jax.jit(lambda x, dt, A, Bm, Cm, D, dtb, h0, seq=seq, cs=cs: jax_ssd_chunked(
            x, dt, A, Bm, Cm, chunk_size=cs, D=D, dt_bias=dtb, seq_idx=seq, initial_state=h0,
            return_final_state=True))
        keys = ("x", "dt", "A", "Bm", "Cm", "D", "dtb")
        h0 = jnp.asarray(v["h0"]) if init else None
        out[L, cs] = (v, [np.asarray(a) for a in fn(*(jnp.asarray(v[k]) for k in keys), h0)])
    return out


def _bf16_round(v):
    return v.to(torch.bfloat16).float()


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("L,cs,G,packed,init", CASES)
def test_k1_passes_match_jax(jax_outputs, L, cs, G, packed, init, mode):
    v, (yj, sj) = jax_outputs[L, cs]
    got = k1_as_the_kernels_run_it(
        t(v["x"]), t(v["dt"]), t(v["A"]), t(v["Bm"]), t(v["Cm"]), t(v["D"]), t(v["dtb"]),
        None if packed is None else t(packed_seq(B, L, *packed)), t(v["h0"]) if init else None,
        cs, TILE, (lambda u: u) if mode == "f32" else _bf16_round)
    for name, g, w in zip(("y", "final state"), got, (yj, sj)):
        g, w = g.numpy().astype(np.float64), w.astype(np.float64)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if mode == "f32":
            rel = np.sqrt(((g - w) ** 2).mean()) / np.sqrt((w ** 2).mean())
            assert rel < 1e-5, (name, rel)
        else:
            err = np.abs(g - w).max()
            assert err <= 1e-2 * np.abs(w).max(), (name, err, np.abs(w).max())
