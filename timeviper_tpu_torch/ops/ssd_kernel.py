"""K1: the Mamba-2 SSD chunked-scan forward as a hand-written CUDA kernel.

Counterpart of timeviper_tpu/ops/ssd_pallas.py:ssd_auto (the Pallas kernel
_ssd_kernel), which models/nano.py calls as `ssd_chunked`. The kernel lives in
csrc/ssd_fwd.cu; its plain version is ops/ssd.py:ssd_chunked. A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from timeviper_tpu_torch.ops import _cuda
from timeviper_tpu_torch.ops.ssd import ssd_chunked


def ssd_scan(
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
    """SSD forward -> (y (B, L, H, P) in x.dtype, final state (B, H, P, N) f32).

    Same arguments and result as ops/ssd.py:ssd_chunked."""
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, B_, C, chunk_size=chunk_size, D=D,
                           dt_bias=dt_bias, dt_limit=dt_limit, seq_idx=seq_idx,
                           initial_state=initial_state)
    return _launch(x, dt, A, B_, C, chunk_size, D, dt_bias, dt_limit, seq_idx,
                   initial_state)


ssd_scan.launches = 0


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssd_scan kernel: {msg}")


def _launch(x, dt, A, B_, C, cs, D, dt_bias, dt_limit, seq_idx, initial_state):
    Bsz, L, H, P = x.shape
    G, N = B_.shape[-2:]
    dev = x.device
    _require(x.is_cuda, "x must be a CUDA tensor")
    for name, t in (("x", x), ("dt", dt), ("B", B_), ("C", C)):
        _require(t.device == dev and t.dtype == torch.bfloat16 and t.is_contiguous(),
                 f"{name} must be a contiguous bf16 tensor on {dev}")
    _require(dt.shape == (Bsz, L, H), f"dt shape {tuple(dt.shape)}")
    _require(B_.shape == (Bsz, L, G, N) and C.shape == B_.shape, "B/C shape")
    _require(P == 64 and N == 128, f"takes head dim 64 and state 128, got {P}, {N}")
    _require(H % G == 0, "heads must split evenly over groups")
    _require(cs % 64 == 0 and 64 <= cs <= 1024, f"chunk size {cs}")
    _require(A is not None, "A is required")
    for name, t in (("A", A), ("D", D), ("dt_bias", dt_bias)):
        if t is not None:
            _require(t.device == dev and t.dtype == torch.float32 and t.shape == (H,)
                     and t.is_contiguous(), f"{name} must be contiguous f32 ({H},)")
    if seq_idx is not None:
        _require(seq_idx.device == dev and seq_idx.dtype == torch.int32
                 and seq_idx.shape == (Bsz, L) and seq_idx.is_contiguous(),
                 "seq_idx must be contiguous int32 (B, L)")
    if initial_state is not None:
        _require(initial_state.device == dev and initial_state.dtype == torch.float32
                 and initial_state.shape == (Bsz, H, P, N)
                 and initial_state.is_contiguous(), "initial_state must be f32 (B, H, P, N)")

    nc = -(-L // cs)
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    final = torch.empty(Bsz, H, P, N, **f32)
    dtp = torch.empty(Bsz, H, nc * cs, **f32)
    acs = torch.empty(Bsz, H, nc * cs, **f32)
    carry = torch.empty(Bsz, H, nc, **f32)
    states = torch.empty(Bsz, nc, H, P, N, **f32)
    cb = torch.empty(Bsz, nc, G, cs, cs, **f32)
    lo, hi = (float(v) for v in dt_limit)
    clamp = int(lo > 0.0 or hi != float("inf"))
    p = _cuda.ptr
    err = _cuda.lib().tv_ssd_fwd(
        p(x), p(dt), p(A), p(dt_bias), p(D), p(B_), p(C), p(seq_idx),
        p(initial_state), p(y), p(final), p(dtp), p(acs), p(carry), p(states), p(cb),
        Bsz, L, H, P, G, N, cs, clamp, lo, hi, _cuda.stream_of(x))
    _cuda.check(err, "tv_ssd_fwd")
    ssd_scan.launches += 1
    return y, final
