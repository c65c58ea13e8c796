"""K1, K4 and K5: the Mamba-2 SSD chunked scan, forward and backward, and
the forward with the causal conv fused in, as hand-written CUDA kernels.

Counterpart of timeviper_tpu/ops/ssd_pallas.py:_ssd_core, the custom_vjp
whose forward is the Pallas kernel _ssd_kernel (K1, csrc/ssd_fwd.cu here) and
whose backward is _ssd_bwd_kernel (K4, csrc/ssd_bwd.cu here). Under
autograd the forward keeps the per-chunk inbound states for the backward, as
the JAX forward does with `save_prev=True`. Both kernels take chunks of at
most 256 rows (`MAX_CHUNK`): a longer chunk runs as chunks of 256, which is
the same function (chunk_size only moves rounding points: the state is
rounded to bf16 every 256 rows instead of every chunk), and the states K1
keeps for K4 are then those of the 256-row chunks.

`ssd_scan` is the entry point: a CPU tensor takes the plain version
(ops/ssd.py:ssd_chunked, differentiated by autograd); a CUDA tensor launches
the kernels or raises. Under autograd the CUDA path is `SSDScanFn`, whose
backward is K4. `ssd_scan_bwd` is K4's own wrapper and
`ssd_scan_bwd_plain` its plain version (autograd through ssd_chunked).

`ssd_conv_scan_fused` is K5, the counterpart of
timeviper_tpu/ops/ssd_pallas.py:ssd_conv_scan_fused (:981, the `fuse_conv`
mode of _ssd_kernel): it takes the RAW in-projection streams x, B and C and
applies the depthwise causal conv (K = 4) + bias + SiLU in a conv stage
that convolves each raw element once into bf16 scratch, then runs K1's
passes on it (csrc/ssd_fwd.cu). Its plain version, `ssd_conv_scan_fused_plain`,
is ops/conv.py:causal_conv1d three times, then ssd_chunked. Inference only.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from timeviper_tpu_torch.ops import _cuda
from timeviper_tpu_torch.ops.ssd import ssd_chunked

Limit = Tuple[float, float]
NO_LIMIT: Limit = (0.0, float("inf"))
MAX_CHUNK = 256  # rows of a chunk the kernels take: four 64-row tiles staged a block


def kernel_chunk(chunk_size: int) -> int:
    """The chunk the kernels run for a caller's `chunk_size`."""
    return min(chunk_size, MAX_CHUNK)


def ssd_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B_: torch.Tensor,
    C: torch.Tensor,
    chunk_size: int = 256,
    D: Optional[torch.Tensor] = None,
    dt_bias: Optional[torch.Tensor] = None,
    dt_limit: Limit = NO_LIMIT,
    seq_idx: Optional[torch.Tensor] = None,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD forward -> (y (B, L, H, P) in x.dtype, final state (B, H, P, N) f32).

    Same arguments and result as ops/ssd.py:ssd_chunked, and differentiable
    in x, dt, A, B_, C, D, dt_bias and initial_state."""
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, B_, C, chunk_size=chunk_size, D=D,
                           dt_bias=dt_bias, dt_limit=dt_limit, seq_idx=seq_idx,
                           initial_state=initial_state)
    diff = (x, dt, A, B_, C, D, dt_bias, initial_state)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in diff):
        return SSDScanFn.apply(x, dt, A, B_, C, D, dt_bias, initial_state, seq_idx,
                               chunk_size, dt_limit)
    y, final, _ = ssd_scan_fwd(x, dt, A, B_, C, chunk_size, D, dt_bias, dt_limit, seq_idx,
                               initial_state, keep_states=False)
    return y, final


ssd_scan.launches = 0


class SSDScanFn(torch.autograd.Function):
    """K1 forward (keeping the inbound state of every chunk), K4 backward."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C, D, dt_bias, initial_state, seq_idx, chunk_size,
                dt_limit):
        y, final, states = ssd_scan_fwd(x, dt, A, B_, C, chunk_size, D, dt_bias, dt_limit,
                                        seq_idx, initial_state, keep_states=True)
        ctx.save_for_backward(x, dt, A, B_, C, D, dt_bias, seq_idx, states)
        ctx.chunk_size, ctx.dt_limit = chunk_size, dt_limit
        ctx.has_init = initial_state is not None
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, B_, C, D, dt_bias, seq_idx, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, ddt, dA, dB, dC, dD, ddtb, dinit = ssd_scan_bwd(
            x, dt, A, B_, C, D, dt_bias, seq_idx, states, dy, dfinal, ctx.chunk_size,
            ctx.dt_limit)
        return (dx, ddt, dA, dB, dC, dD, ddtb, dinit if ctx.has_init else None,
                None, None, None)


def ssd_scan_bwd(x, dt, A, B_, C, D, dt_bias, seq_idx, states, dy, dfinal,
                 chunk_size: int = 256, dt_limit: Limit = NO_LIMIT):
    """K4: gradients of ssd_scan's (y, final state) given their cotangents dy
    and dfinal (None = zero) -> (dx, ddt, dA, dB, dC, dD, ddt_bias, d initial
    state), None where the input was None. `states` (B, nc, H, P, N) f32 are
    the inbound states K1 kept, nc counting chunks of kernel_chunk(chunk_size)
    rows. A CPU tensor takes the plain version."""
    if x.device.type == "cpu":
        return ssd_scan_bwd_plain(x, dt, A, B_, C, D, dt_bias, seq_idx, dy, dfinal,
                                  chunk_size, dt_limit)
    return _launch_bwd(x, dt, A, B_, C, D, dt_bias, seq_idx, states, dy, dfinal,
                       chunk_size, dt_limit)


ssd_scan_bwd.launches = 0


def ssd_scan_bwd_plain(x, dt, A, B_, C, D, dt_bias, seq_idx, dy, dfinal,
                       chunk_size: int = 256, dt_limit: Limit = NO_LIMIT,
                       initial_state=None):
    """K4's plain version: autograd through ops/ssd.py:ssd_chunked."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_()
                  for t in (x, dt, A, B_, C, D, dt_bias, initial_state)]
        y, st = ssd_chunked(*leaves[:5], chunk_size=chunk_size, D=leaves[5],
                            dt_bias=leaves[6], dt_limit=dt_limit, seq_idx=seq_idx,
                            initial_state=leaves[7])
        outs, cots = [y], [dy]
        if dfinal is not None:
            outs.append(st)
            cots.append(dfinal)
        live = [t for t in leaves if t is not None]
        grads = iter(torch.autograd.grad(outs, live, cots, allow_unused=True))
    out = [None if t is None else next(grads) for t in leaves]
    return tuple(g if g is not None or t is None else torch.zeros_like(t)
                 for g, t in zip(out, leaves))


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssd_scan kernel: {msg}")


def ssd_conv_scan_fused_plain(x_raw, dt, A, B_raw, C_raw, conv_params: dict,
                              chunk_size: int = 256, D=None, dt_bias=None,
                              dt_limit: Limit = NO_LIMIT, seq_idx=None):
    """K5's plain version: conv + bias + SiLU on each raw stream (a missing
    bias is zero), then the chunked scan."""
    from timeviper_tpu_torch.ops.conv import causal_conv1d

    B, L, H, P = x_raw.shape
    G, N = B_raw.shape[-2:]
    cp = conv_params
    xs = causal_conv1d(x_raw.reshape(B, L, H * P), cp["wx"], cp.get("bx"), "silu", seq_idx)
    Bs = causal_conv1d(B_raw.reshape(B, L, G * N), cp["wB"], cp.get("bB"), "silu", seq_idx)
    Cs = causal_conv1d(C_raw.reshape(B, L, G * N), cp["wC"], cp.get("bC"), "silu", seq_idx)
    return ssd_chunked(xs.reshape(B, L, H, P), dt, A, Bs.reshape(B, L, G, N),
                       Cs.reshape(B, L, G, N), chunk_size=chunk_size, D=D, dt_bias=dt_bias,
                       dt_limit=dt_limit, seq_idx=seq_idx)


def ssd_conv_scan_fused(x_raw, dt, A, B_raw, C_raw, conv_params: dict,
                        chunk_size: int = 256, D=None, dt_bias=None,
                        dt_limit: Limit = NO_LIMIT, seq_idx=None):
    """Depthwise causal conv (K = 4) + bias + SiLU on the raw x (B, L, H, P),
    B and C (B, L, G, N), then the SSD scan -> (y, final state), as
    ops/ssd.py:ssd_chunked gives them for the convolved streams. conv_params:
    {"wx": (H*P, 4), "bx", "wB": (G*N, 4), "bB", "wC", "bC"}, a bias None
    for none; a tap that reaches across a segment of seq_idx reads zero.
    Inference only: raises under autograd. A CPU tensor takes the plain
    version, a CUDA tensor the kernel."""
    live = [t for t in (x_raw, dt, A, B_raw, C_raw, D, dt_bias, *conv_params.values())
            if isinstance(t, torch.Tensor)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in live):
        raise RuntimeError("ssd_conv_scan_fused is inference only: it has no backward")
    if x_raw.device.type == "cpu":
        return ssd_conv_scan_fused_plain(x_raw, dt, A, B_raw, C_raw, conv_params, chunk_size,
                                         D, dt_bias, dt_limit, seq_idx)
    y, final, _ = _launch_fwd(x_raw, dt, A, B_raw, C_raw, chunk_size, D, dt_bias, dt_limit,
                              seq_idx, None, conv_params, keep_states=False)
    ssd_conv_scan_fused.launches += 1
    return y, final


ssd_conv_scan_fused.launches = 0


def _row_stride(t, name: str, strided: bool) -> int:
    """The stride between positions of a (B, L, ...) stream whose inner
    dims are contiguous; with `strided` the positions may lie further apart
    (a column slice of a wider in-projection output)."""
    B, L = t.shape[:2]
    inner = t[0, 0].numel()
    ok = t[0, 0].is_contiguous() if t.dim() > 2 else True
    ok = ok and (t.stride(1) == inner if not strided else t.stride(1) >= inner)
    ok = ok and (B == 1 or t.stride(0) == L * t.stride(1))
    _require(ok, f"{name} must have contiguous rows evenly spaced"
             + ("" if strided else " and be contiguous"))
    return t.stride(1)


def _check_inputs(x, dt, A, B_, C, cs, D, dt_bias, seq_idx, strided=False):
    Bsz, L, H, P = x.shape
    G, N = B_.shape[-2:]
    dev = x.device
    _require(x.is_cuda, "x must be a CUDA tensor")
    strides = []
    for name, t in (("x", x), ("dt", dt), ("B", B_), ("C", C)):
        _require(t.device == dev and t.dtype == torch.bfloat16,
                 f"{name} must be a bf16 tensor on {dev}")
        strides.append(_row_stride(t, name, strided))
    _require(strides[2] == strides[3] and strides[2] % 8 == 0
             and B_.data_ptr() % 16 == 0 and C.data_ptr() % 16 == 0,
             "B and C must share a row stride with 16-byte aligned rows")
    _require(strides[0] % 8 == 0 and x.data_ptr() % 16 == 0, "x rows must be 16-byte aligned")
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
    return Bsz, L, H, P, G, N, strides[0], strides[1], strides[2]


def _f32_state(t, shape, name) -> None:
    if t is not None:
        _require(t.dtype == torch.float32 and tuple(t.shape) == shape and t.is_contiguous(),
                 f"{name} must be contiguous f32 {shape}")


def _clamp_args(dt_limit: Limit):
    lo, hi = (float(v) for v in dt_limit)
    return int(lo > 0.0 or hi != float("inf")), lo, hi


def ssd_scan_fwd(x, dt, A, B_, C, cs, D, dt_bias, dt_limit, seq_idx, initial_state, *,
                 keep_states: bool):
    """K1 on CUDA tensors -> (y, final state, the inbound state of every
    chunk of kernel_chunk(cs) rows (B, nc, H, P, N) f32, which K4 takes;
    None unless `keep_states`)."""
    out = _launch_fwd(x, dt, A, B_, C, cs, D, dt_bias, dt_limit, seq_idx, initial_state,
                      keep_states=keep_states)
    ssd_scan.launches += 1
    return out


def _conv_args(conv_params, H, P, G, N, dev):
    """The conv taps and biases for K5: f32, contiguous, (channels, 4) taps."""
    out = []
    for w, b, ch in (("wx", "bx", H * P), ("wB", "bB", G * N), ("wC", "bC", G * N)):
        wt, bt = conv_params[w], conv_params.get(b)
        _require(wt.device == dev and wt.dtype == torch.float32 and wt.shape == (ch, 4)
                 and wt.is_contiguous(), f"{w} must be contiguous f32 ({ch}, 4)")
        _require(bt is None or (bt.device == dev and bt.dtype == torch.float32
                                and bt.shape == (ch,) and bt.is_contiguous()),
                 f"{b} must be contiguous f32 ({ch},)")
        out += [wt, bt]
    return out


def head_slices(blocks: int, R: int, n_sm: int) -> int:
    """How many slices a kernel with one block an SM per (chunk or tile,
    group) splits a group's R heads into: 1 unless its `blocks` would fill
    fewer than 3 waves of `n_sm` SMs; then doubled while they would, keeping
    at least 2 heads a slice."""
    S = 1
    while blocks * S < 3 * n_sm and R % (4 * S) == 0:
        S *= 2
    return S


def fwd_plan(Bsz: int, L: int, G: int, R: int, cs: int, n_sm: int) -> Tuple[int, int]:
    """The head slices (chunk_state, chunk_scan) K1 runs at a kernel chunk of
    cs rows: chunk_state has a block per chunk and group, chunk_scan one per
    64-row tile that starts before L and group."""
    return (head_slices(-(-L // cs) * G * Bsz, R, n_sm),
            head_slices(-(-L // 64) * G * Bsz, R, n_sm))


def fwd_blocks():
    """((threads, dynamic shared memory bytes) of a chunk_scan block, the same
    of a chunk_state block) of K1 on the card."""
    import ctypes

    out = []
    for which in (0, 1):
        v = (ctypes.c_int * 2)()
        _cuda.lib().tv_ssd_fwd_block(which, ctypes.cast(v, ctypes.c_void_p))
        out.append(tuple(v))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _n_sm(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _launch_fwd(x, dt, A, B_, C, cs, D, dt_bias, dt_limit, seq_idx, initial_state,
                conv_params=None, *, keep_states: bool):
    """K1, or K5 with `conv_params`: one call of tv_ssd_fwd. Returns (y,
    final state, the f32 inbound states or None unless `keep_states`)."""
    Bsz, L, H, P, G, N, sx, sdt, sbc = _check_inputs(x, dt, A, B_, C, cs, D, dt_bias, seq_idx,
                                                      strided=True)
    _f32_state(initial_state, (Bsz, H, P, N), "initial_state")
    cs = kernel_chunk(cs)
    conv = ([None] * 6 if conv_params is None
            else _conv_args(conv_params, H, P, G, N, x.device))
    nc = -(-L // cs)
    f32 = dict(dtype=torch.float32, device=x.device)
    # K5's conv stage writes the convolved streams here, contiguous
    conv_out = ([None] * 3 if conv_params is None else
                [torch.empty(Bsz, L, ch, dtype=torch.bfloat16, device=x.device)
                 for ch in (H * P, G * N, G * N)])
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    final = torch.empty(Bsz, H, P, N, **f32)
    dtp = torch.empty(Bsz, H, nc * cs, **f32)
    acs = torch.empty(Bsz, H, nc * cs, **f32)
    carry = torch.empty(Bsz, H, nc, **f32)
    states = torch.empty(Bsz, nc, H, P, N, **f32)  # chunk states, then the inbound ones
    hin = torch.empty(Bsz, nc, H, P, N, dtype=torch.bfloat16, device=x.device)
    S_state, S_scan = fwd_plan(Bsz, L, G, H // G, cs, _n_sm(x.device))
    clamp, lo, hi = _clamp_args(dt_limit)
    p = _cuda.ptr
    err = _cuda.lib().tv_ssd_fwd(
        p(x), p(dt), p(A), p(dt_bias), p(D), p(B_), p(C), p(seq_idx),
        p(initial_state), *(p(c) for c in conv), *(p(c) for c in conv_out), p(y), p(final),
        p(dtp), p(acs), p(carry), p(states), p(hin), Bsz, L, H, P, G, N, cs, sx, sdt, sbc,
        S_state, S_scan, clamp, int(keep_states), lo, hi, _cuda.stream_of(x))
    _cuda.check(err, "tv_ssd_fwd")
    return y, final, states if keep_states else None


def bwd_head_slices(nc: int, cs: int, G: int, R: int, Bsz: int, n_sm: int) -> int:
    """How many slices K4's dc / db kernels, nc * (cs / 64) * G * Bsz blocks,
    split a group's R heads into (head_slices)."""
    return head_slices(nc * (cs // 64) * G * Bsz, R, n_sm)


def _launch_bwd(x, dt, A, B_, C, D, dt_bias, seq_idx, states, dy, dfinal, cs, dt_limit):
    Bsz, L, H, P, G, N = _check_inputs(x, dt, A, B_, C, cs, D, dt_bias, seq_idx)[:6]
    cs = kernel_chunk(cs)
    nc = -(-L // cs)
    _f32_state(states, (Bsz, nc, H, P, N), "states")
    _f32_state(dfinal, (Bsz, H, P, N), "dfinal")
    dy = dy.contiguous()
    _require(dy.dtype == torch.bfloat16 and dy.shape == x.shape, "dy must be bf16 like x")
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    Lp = nc * cs
    S = bwd_head_slices(nc, cs, G, H // G, Bsz, _n_sm(dev))
    dx = torch.empty_like(x)
    ddt = torch.empty(Bsz, L, H, **f32)
    dB = torch.empty(Bsz, L, G, N, **f32)
    dC = torch.empty(Bsz, L, G, N, **f32)
    dinit = torch.empty(Bsz, H, P, N, **f32)
    part = torch.empty(3, Bsz, nc, H, **f32)  # per chunk: dA, d dt_bias, dD
    dtp, acs, da, ubuf, ddt1, dyx = (torch.empty(Bsz, H, Lp, **f32) for _ in range(6))
    carry = torch.empty(Bsz, H, nc, **f32)
    cb = torch.empty(Bsz, nc, G, 2, cs, cs, **f32)  # C.B^T tiles in two register orders
    dstates = torch.empty(Bsz, nc, H, P, N, **f32)
    hin_bf, dh_bf = (torch.empty(Bsz, nc, H, P, N, dtype=torch.bfloat16, device=dev)
                     for _ in range(2))
    vpart = torch.empty(Bsz, nc, H, P * N // 128, **f32)
    slices = torch.empty(2, S, Bsz, L, G, N, **f32) if S > 1 else None
    clamp, lo, hi = _clamp_args(dt_limit)
    p = _cuda.ptr
    err = _cuda.lib().tv_ssd_bwd(
        p(x), p(dt), p(A), p(dt_bias), p(D), p(B_), p(C), p(seq_idx), p(states), p(dy),
        p(dfinal), p(dx), p(ddt), p(dB), p(dC), p(dinit), p(part), p(dtp), p(acs),
        p(carry), p(cb), p(dstates), p(hin_bf), p(dh_bf), p(vpart), p(slices), p(da), p(ubuf),
        p(ddt1), p(dyx), Bsz, L, H, P, G, N, cs, S, clamp, lo, hi, _cuda.stream_of(x))
    _cuda.check(err, "tv_ssd_bwd")
    ssd_scan_bwd.launches += 1
    sums = part.sum(dim=(1, 2))  # the tiny sum over batch and chunks
    return (dx, ddt.to(dt.dtype), sums[0], dB.to(B_.dtype), dC.to(C.dtype),
            None if D is None else sums[2], None if dt_bias is None else sums[1], dinit)
