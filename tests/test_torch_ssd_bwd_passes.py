"""The SSD backward that csrc/ssd_bwd.cu (K4) computes, written out in f32
pass by pass as its kernels run it, against jax.vjp of the JAX package's
ssd_chunked; and the conv stage of csrc/ssd_fwd.cu (K5), written out in its
row tiles with their 3-row halo, against the JAX package's causal_conv1d.

The K4 write-out follows the kernels' split and order of the sums:

- dstate: the cotangent dh_out(c) of each chunk's end state by a reverse
  walk, and dh_out(c) . h_in(c) as partial sums over blocks of 128 state
  elements, summed in block order (dtfinal's carry term);
- dc / db: one block per (chunk, tile of rows, group, slice of the group's
  heads); in a block, two warpgroups take the slice's heads in turn (0, 2,
  .. and 1, 3, ..) and sum their dC or dB rows over their heads, warpgroup
  0's sum then warpgroup 1's is added, and the slices' partials are summed
  slice 0 first. dt scales dM's columns (dc) or rows (db) after the product;
  the decay is exp(acs_i - acs_j) per pair; db walks its tiles from the
  chunk's last down to its own;
- dtfinal: the suffix sum of the cumsum cotangent, the sigmoid and clip of
  the raw dt, and the per-chunk partials of dA, d dt_bias and dD (whose
  per-row terms db writes).

Three cases of tests/test_torch_ssd_grad.py (a pad and a boundary inside a
chunk, a boundary on a chunk edge, dt_limit clipping), chunks of 16 in
tiles of 8, one and two head slices; f32 on both sides, to 1e-5 of the
reference's RMS. The JAX side is jitted once per case in a module fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import packed_seq, rng, t

from timeviper_tpu.ops.conv import causal_conv1d as jax_causal_conv1d
from timeviper_tpu.ops.ssd import ssd_chunked as jax_ssd_chunked

NO_LIMIT = (0.0, float("inf"))
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "ddt_bias", "dinit")


def _rows(v, Lp):
    """v (B, L, ...) padded with zero rows to Lp."""
    return torch.cat([v, v.new_zeros(v.shape[0], Lp - v.shape[1], *v.shape[2:])], 1)


def k4_as_the_kernels_run_it(x, dt, A, Bm, Cm, D, dtb, seq, dy, dfin, cs, tile, S, lim):
    """(dx, ddt, dA, dB, dC, dD, ddt_bias, dinit) from f32 inputs."""
    B, L, H, P = x.shape
    G, N = Bm.shape[2:]
    R, nc, T = H // G, -(-L // cs), cs // tile
    Lp, Rs = nc * cs, R // S
    clamp = lim[0] > 0.0 or lim[1] != float("inf")
    seg = torch.zeros(B, Lp, dtype=torch.int64) if seq is None else torch.cat(
        [seq.long(), seq[:, -1:].long().expand(B, Lp - L)], 1)  # the tail repeats the last id
    x_, dy_, B_, C_ = (_rows(v, Lp) for v in (x, dy, Bm, Cm))

    # pass 1: processed dt, chunk-local cumsum, carry; the forward's inbound states
    raw = dt + (dtb if dtb is not None else 0.0)
    dtp = torch.nn.functional.softplus(raw)
    if clamp:
        dtp = dtp.clamp(lim[0], lim[1])
    dtp = _rows(dtp, Lp).permute(0, 2, 1).reshape(B, H, nc, cs)  # 0 on the tail
    acs = torch.cumsum(dtp * A[None, :, None, None], -1)
    segc = seg.reshape(B, nc, cs)
    sprev = torch.cat([segc[:, :1, 0], segc[:, :-1, -1]], 1)  # (B, nc)
    keep = (segc[:, :, 0] == segc[:, :, -1]) & (segc[:, :, 0] == sprev)
    carry = torch.where(keep[:, None], torch.exp(acs[..., -1]), 0.0)  # (B, H, nc)
    xc = x_.reshape(B, nc, cs, H, P)
    dyc = dy_.reshape(B, nc, cs, H, P)
    Bc, Cc = B_.reshape(B, nc, cs, G, N), C_.reshape(B, nc, cs, G, N)
    hg = torch.arange(H) // R
    last = segc[:, :, -1:] == segc  # rows of the chunk's last segment
    w_st = torch.where(last[:, None], torch.exp(acs[..., -1:] - acs), 0.0)  # (B, H, nc, cs)
    states = torch.zeros(B, nc, H, P, N)
    h = torch.zeros(B, H, P, N)
    for c in range(nc):
        states[:, c] = h
        wx = xc[:, c] * (w_st[:, :, c] * dtp[:, :, c]).permute(0, 2, 1)[..., None]
        h = carry[:, :, c, None, None] * h + torch.einsum("bjhp,bjhn->bhpn", wx, Bc[:, c][:, :, hg])

    # passes 2-4: C.B^T, the chunks' contributions, the reverse walk
    cb = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)
    first = segc == sprev[:, :, None]
    w_out = torch.where(first[:, None], torch.exp(acs), 0.0)  # (B, H, nc, cs)
    contrib = torch.einsum("bcih,bcihp,bcihn->bchpn", w_out.permute(0, 2, 3, 1), dyc,
                           Cc[:, :, :, hg])
    dh_out = torch.zeros(B, nc, H, P, N)
    v = torch.zeros(B, H, nc)
    s = dfin.clone() if dfin is not None else torch.zeros(B, H, P, N)
    for c in reversed(range(nc)):
        dh_out[:, c] = s
        blocks = (s * states[:, c]).reshape(B, H, -1, 128).sum(-1)  # per 128-element block
        for k in range(blocks.shape[-1]):
            v[:, :, c] = v[:, :, c] + blocks[..., k]
        s = s * carry[:, :, c, None, None] + contrib[:, c]
    dinit = s

    # pass 5: dc and db, per (chunk, tile, group, slice), warpgroups over heads
    da = torch.zeros(B, H, nc, cs)
    ubuf, ddt1 = torch.zeros(B, H, nc, cs), torch.zeros(B, H, nc, cs)
    dxc = torch.zeros(B, nc, cs, H, P)
    part = {"dC": torch.zeros(S, B, nc, cs, G, N), "dB": torch.zeros(S, B, nc, cs, G, N)}
    pos = torch.arange(cs)
    for b in range(B):
        for c in range(nc):
            for own in range(T):
                ro = slice(own * tile, (own + 1) * tile)
                for g in range(G):
                    for sl in range(S):
                        for db in (False, True):
                            acc = []
                            for wg in (0, 1):
                                a_wg = torch.zeros(tile, N)
                                for hh in range(wg, Rs, 2):
                                    hd = g * R + sl * Rs + hh
                                    a_wg = a_wg + _head(db, b, c, own, ro, g, hd, T, tile, pos,
                                                        xc, dyc, Bc, Cc, cb, acs, dtp, segc,
                                                        sprev, states, dh_out, w_out, w_st,
                                                        da, ubuf, ddt1, dxc, D)
                                acc.append(a_wg)
                            part["dB" if db else "dC"][sl, b, c, ro, g] = acc[0] + acc[1]
    dC = part["dC"][0]
    dB = part["dB"][0]
    for sl in range(1, S):
        dC = dC + part["dC"][sl]
        dB = dB + part["dB"][sl]

    # pass 7: dtfinal
    usum = ubuf.sum(-1)
    da[..., -1] += usum + v * carry
    ddA = torch.flip(torch.cumsum(torch.flip(da, [-1]), -1), [-1])
    rawp = _rows(raw, Lp).permute(0, 2, 1).reshape(B, H, nc, cs)
    grad = (ddt1 + ddA * A[None, :, None, None]) * torch.sigmoid(rawp)
    if clamp:
        sp = torch.nn.functional.softplus(rawp)
        grad = torch.where((sp > lim[0]) & (sp < lim[1]), grad, 0.0)
    valid = (torch.arange(Lp) < L).reshape(nc, cs)
    grad = torch.where(valid, grad, 0.0)
    ddt = grad.reshape(B, H, Lp).permute(0, 2, 1)[:, :L]
    dA = (ddA * dtp).sum((0, 2, 3))
    ddtb = grad.sum((0, 2, 3))
    dD = (dy * x).sum(-1).sum((0, 1))  # db's per-row terms, then dtfinal's sum
    dx = dxc.reshape(B, Lp, H, P)[:, :L]
    return (dx, ddt, dA, dB.reshape(B, Lp, G, N)[:, :L], dC.reshape(B, Lp, G, N)[:, :L], dD,
            ddtb, dinit)


def _head(db, b, c, own, ro, g, h, T, tile, pos, xc, dyc, Bc, Cc, cb, acs, dtp, segc, sprev,
          states, dh_out, w_out, w_st, da, ubuf, ddt1, dxc, D):
    """One head's units of a dc (db False) or db block: returns its dC (or
    dB) rows and writes its per-row results."""
    a_h = acs[b, h, c]
    d_h = dtp[b, h, c]
    sg = segc[b, c]
    if not db:
        wo = w_out[b, h, c, ro]
        dy_i = dyc[b, c, ro, h]
        C_i = Cc[b, c, ro, g]
        hin = states[b, c, h]
        t_i = wo * (dy_i * (C_i @ hin.T)).sum(-1)
        acc = (wo[:, None] * dy_i) @ hin
        row_e = torch.zeros(tile)
        for jt in range(own + 1):
            rj = slice(jt * tile, (jt + 1) * tile)
            dm = (dy_i @ xc[b, c, rj, h].T) * d_h[rj][None, :]
            ok = (pos[rj][None, :] <= pos[ro][:, None]) & (sg[rj][None, :] == sg[ro][:, None])
            dcb = torch.where(ok, dm * torch.exp(a_h[ro][:, None] - a_h[rj][None, :]), 0.0)
            row_e = row_e + (dcb * cb[b, c, g][ro, rj]).sum(-1)
            acc = acc + dcb @ Bc[b, c, rj, g]
        da[b, h, c, ro] = row_e + t_i
        return acc
    ws = w_st[b, h, c, ro]
    x_j = xc[b, c, ro, h]
    B_j = Bc[b, c, ro, g]
    dh = dh_out[b, c, h]
    ax = ws[:, None] * (B_j @ dh.T)
    u_j = (x_j * d_h[ro][:, None] * ax).sum(-1)
    acc = ((ws * d_h[ro])[:, None] * x_j) @ dh
    col_e = torch.zeros(tile)
    for it in range(T - 1, own - 1, -1):
        ri = slice(it * tile, (it + 1) * tile)
        dmt = (x_j @ dyc[b, c, ri, h].T) * d_h[ro][:, None]
        ok = (pos[ri][None, :] >= pos[ro][:, None]) & (sg[ri][None, :] == sg[ro][:, None])
        lt = torch.where(ok, torch.exp(a_h[ri][None, :] - a_h[ro][:, None]), 0.0)
        cbt = cb[b, c, g][ri, ro].T
        d = dmt * lt
        col_e = col_e + (d * cbt).sum(-1)
        ax = ax + (cbt * lt) @ dyc[b, c, ri, h]
        acc = acc + d @ Cc[b, c, ri, g]
    dh_d = 0.0 if D is None else D[h]
    dxc[b, c, ro, h] = ax * d_h[ro][:, None] + dh_d * dyc[b, c, ro, h]
    ddt1[b, h, c, ro] = (ax * x_j).sum(-1)
    da[b, h, c, ro] -= col_e + u_j
    ubuf[b, h, c, ro] = u_j
    return acc


# (L, chunk, (pad, cut), dt_limit, head slices), of tests/test_torch_ssd_grad.py's cases
CASES = [
    (40, 16, (5, 23), NO_LIMIT, 1),
    (48, 16, (16, 32), NO_LIMIT, 2),
    (48, 16, (3, 29), (0.05, 1.0), 2),
]
B, H, P, G, N = 2, 8, 8, 2, 16


def _inputs(seed, L):
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
        h0=np.zeros((B, H, P, N), np.float32),
    )


@pytest.fixture(scope="module")
def jax_grads():
    """jax.vjp of the jnp ssd_chunked for each case, jitted once."""
    out = {}
    for L, cs, packed, lim, _ in CASES:
        v = _inputs(L + cs, L)
        seq = jnp.asarray(packed_seq(B, L, *packed))

        @jax.jit
        def grads(x, dt, A, Bm, Cm, D, dtb, h0, gy, gst, seq=seq, cs=cs, lim=lim):
            def f(*a):
                return jax_ssd_chunked(*a[:5], chunk_size=cs, D=a[5], dt_bias=a[6],
                                       dt_limit=lim, seq_idx=seq, initial_state=a[7],
                                       return_final_state=True)
            _, vjp = jax.vjp(f, x, dt, A, Bm, Cm, D, dtb, h0)
            return vjp((gy, gst))

        keys = ("x", "dt", "A", "Bm", "Cm", "D", "dtb", "h0", "gy", "gst")
        out[L, packed] = (v, [np.asarray(a) for a in grads(*(jnp.asarray(v[k]) for k in keys))])
    return out


def _close(name, got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    rms = np.sqrt((want ** 2).mean()) or 1.0
    rel = np.sqrt(((got - want) ** 2).mean()) / rms
    assert rel < tol, (name, rel)


@pytest.mark.parametrize("L,cs,packed,lim,S", CASES)
def test_k4_passes_match_jax_vjp(jax_grads, L, cs, packed, lim, S):
    v, want = jax_grads[L, packed]
    got = k4_as_the_kernels_run_it(
        t(v["x"]), t(v["dt"]), t(v["A"]), t(v["Bm"]), t(v["Cm"]), t(v["D"]), t(v["dtb"]),
        t(packed_seq(B, L, *packed)), t(v["gy"]), t(v["gst"]), cs, cs // 2, S, lim)
    for name, g, w in zip(NAMES, got, want):
        _close(name, g.numpy(), w)


def conv_as_the_stage_runs_it(raw, w, bias, seq, rows):
    """K5's conv stage on raw (B, L, C) f32: tiles of `rows` rows, each
    holding the 3 raw rows before it; tap j = 0 first; SiLU(sum + bias)."""
    Bsz, L, C = raw.shape
    out = torch.empty_like(raw)
    for b in range(Bsz):
        for r0 in range(0, L, rows):
            win = [raw[b, r] if r >= 0 else raw.new_zeros(C) for r in (r0 - 3, r0 - 2, r0 - 1)]
            for pos in range(r0, min(r0 + rows, L)):
                acc = raw[b, pos] * w[:, 3]
                for j in (1, 2, 3):
                    on = pos - j >= 0 and (seq is None or seq[b, pos - j] == seq[b, pos])
                    if on:
                        acc = acc + win[3 - j] * w[:, 3 - j]
                acc = acc + (bias if bias is not None else 0.0)
                out[b, pos] = acc * torch.sigmoid(acc)
                win = [win[1], win[2], raw[b, pos]]
    return out


@pytest.mark.parametrize("packed", [(5, 18), (9, 16), None])
def test_conv_stage_tiles_match_jax_causal_conv1d(packed):
    """Tiles of 8 rows over 29 rows: boundaries 1 row after a tile edge, on
    one, and none; a halo that crosses a tile and a segment."""
    Bsz, L, C = 2, 29, 24
    r = rng(11)
    raw = r.standard_normal((Bsz, L, C), np.float32)
    w = (r.standard_normal((C, 4)) * 0.5).astype(np.float32)
    bias = (r.standard_normal(C) * 0.1).astype(np.float32)
    seq = packed_seq(Bsz, L, *packed) if packed else None
    got = conv_as_the_stage_runs_it(t(raw), t(w), t(bias), None if seq is None else t(seq), 8)
    want = jax_causal_conv1d(jnp.asarray(raw), jnp.asarray(w), jnp.asarray(bias), "silu",
                             None if seq is None else jnp.asarray(seq))
    _close("conv", got.numpy(), np.asarray(want))
