"""Mamba-2 SSD scan in plain PyTorch (counterpart of timeviper_tpu/ops/ssd.py).

`ssd_chunked` is the plain version of the CUDA kernel in ops/ssd_kernel.py
(and of the TPU kernel ops/ssd_pallas.py:_ssd_kernel): the same chunked
algorithm, all state math in float32. The chunk states are combined by a
sequential loop over chunks, which is what the kernel's state pass does.

Shapes (Mamba-2 convention):
  x (B, L, H, P); dt (B, L, H) raw, taken through softplus(dt + dt_bias)
  and clamped to dt_limit; A (H,) negative; B_, C (B, L, G, N); D, dt_bias
  (H,); seq_idx (B, L) int packed-segment ids; head h reads group h // (H/G).
  initial_state / final state (B, H, P, N) float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _process_dt(dt, dt_bias, dt_limit: Tuple[float, float]):
    dt = dt.float()
    if dt_bias is not None:
        dt = dt + dt_bias.float()
    dt = F.softplus(dt)
    lo, hi = dt_limit
    if lo > 0.0 or hi != float("inf"):
        dt = dt.clamp(lo, hi)
    return dt


def _segsum_exp(acs: torch.Tensor) -> torch.Tensor:
    """exp(acs_i - acs_j) for j <= i, else 0. acs: (..., T) -> (..., T, T)."""
    T = acs.shape[-1]
    diff = acs[..., :, None] - acs[..., None, :]
    causal = torch.ones(T, T, dtype=torch.bool, device=acs.device).tril()
    return torch.where(causal, diff, float("-inf")).exp()


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B_: torch.Tensor,
    C: torch.Tensor,
    chunk_size: int = 256,
    D: Optional[torch.Tensor] = None,
    dt_bias: Optional[torch.Tensor] = None,
    dt_limit: Tuple[float, float] = (0.0, float("inf")),
    seq_idx: Optional[torch.Tensor] = None,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan -> (y (B, L, H, P) in x.dtype, final state (B, H, P, N)
    float32)."""
    Bsz, L, H, P = x.shape
    G, N = B_.shape[-2:]
    rep = H // G
    cs = chunk_size
    pad = (cs - L % cs) % cs
    nc = (L + pad) // cs

    # the ragged tail gets effective dt = 0: it adds nothing and decays nothing
    dtf = F.pad(_process_dt(dt, dt_bias, dt_limit), (0, 0, 0, pad))
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad))
    Bf = F.pad(B_.float(), (0, 0, 0, 0, 0, pad))
    Cf = F.pad(C.float(), (0, 0, 0, 0, 0, pad))
    Af = A.float()

    xc = xf.reshape(Bsz, nc, cs, H, P)
    dtc = dtf.reshape(Bsz, nc, cs, H)
    Bc = Bf.reshape(Bsz, nc, cs, G, N)
    Cc = Cf.reshape(Bsz, nc, cs, G, N)
    acs = torch.cumsum((dtc * Af).permute(0, 1, 3, 2), dim=-1)  # (B,nc,H,cs)

    if seq_idx is not None:
        seq = seq_idx.long()
        if pad:
            seq = torch.cat([seq, seq[:, -1:].expand(Bsz, pad)], dim=1)
        sc = seq.reshape(Bsz, nc, cs)
        seg_last = sc[:, :, -1]
        seg_prev = torch.cat([sc[:, :1, 0], seg_last[:, :-1]], dim=1)

    # 1. intra-chunk: (C_i . B_j) exp(acs_i - acs_j), masked to j <= i, same segment
    decay = _segsum_exp(acs)  # (B,nc,H,cs,cs)
    if seq_idx is not None:
        decay = decay * (sc[:, :, :, None] == sc[:, :, None, :])[:, :, None]
    CB = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc).repeat_interleave(rep, dim=2)
    xdt = xc * dtc[..., None]  # (B,nc,cs,H,P)
    y = torch.einsum("bchij,bcjhp->bcihp", CB * decay, xdt)

    # 2. what each chunk adds to the state at its end
    w = torch.exp(acs[..., -1:] - acs)  # (B,nc,H,cs)
    if seq_idx is not None:
        w = w * (sc == seg_last[:, :, None])[:, :, None]
    Bh = Bc.repeat_interleave(rep, dim=3)  # (B,nc,cs,H,N)
    states = torch.einsum("bcjhp,bcjhn->bchpn", xdt * w.permute(0, 1, 3, 2)[..., None], Bh)

    # 3. inbound state of every chunk, walking the chunks in order
    carry = torch.exp(acs[..., -1])  # (B,nc,H)
    if seq_idx is not None:
        carry = carry * ((sc[:, :, 0] == seg_last) & (seg_prev == sc[:, :, 0]))[..., None]
    s = (torch.zeros(Bsz, H, P, N, dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    inbound = []
    for c in range(nc):
        inbound.append(s)
        s = s * carry[:, c, :, None, None] + states[:, c]
    prev = torch.stack(inbound, dim=1)  # (B,nc,H,P,N)

    # 4. the inbound state seen from each row
    out_w = torch.exp(acs)  # (B,nc,H,cs)
    if seq_idx is not None:
        out_w = out_w * (sc == seg_prev[:, :, None])[:, :, None]
    Ch = Cc.repeat_interleave(rep, dim=3)
    y = y + torch.einsum("bcihn,bchpn->bcihp", Ch, prev) * out_w.permute(0, 1, 3, 2)[..., None]

    y = y.reshape(Bsz, nc * cs, H, P)
    if D is not None:
        y = y + D.float()[:, None] * xf
    return y[:, :L].to(x.dtype), s


def ssd_update_step(
    ssm_state: torch.Tensor,
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B_: torch.Tensor,
    C: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    dt_bias: Optional[torch.Tensor] = None,
    dt_limit: Tuple[float, float] = (0.0, float("inf")),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode token. ssm_state (B, H, P, N) f32; x (B, H, P); dt (B, H);
    B_, C (B, G, N). Returns (y (B, H, P) in x.dtype, new state f32)."""
    H = x.shape[1]
    rep = H // B_.shape[1]
    dtf = _process_dt(dt, dt_bias, dt_limit)
    xf = x.float()
    Bf = B_.float().repeat_interleave(rep, dim=1)
    Cf = C.float().repeat_interleave(rep, dim=1)
    dA = torch.exp(dtf * A.float())
    new_state = ssm_state * dA[..., None, None] + (dtf[..., None] * Bf)[:, :, None, :] * xf[..., None]
    y = torch.einsum("bhpn,bhn->bhp", new_state, Cf)
    if D is not None:
        y = y + D.float()[None, :, None] * xf
    return y.to(x.dtype), new_state
