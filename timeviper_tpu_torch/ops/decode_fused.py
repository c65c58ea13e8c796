"""K7: one Mamba decode step's x conv, state update and gated RMSNorm in one
hand-written CUDA kernel.

Counterpart of timeviper_tpu/ops/decode_fused.py:fused_mamba_decode (:77),
whose Pallas kernel is _kernel (:39). Per batch row b and channel c = h*P + p
of group g (channels of a group: CpG = d_inner / G):

    conv_x' = roll(conv_x, -1) with xr in the last tap     (conv state, rolled)
    xs      = silu(sum_k conv_x'[k] w[c, k] + bias[c])      f32, not rounded
    s'      = s dA[h] + (dt[h] xs) B[g]                     f32 state (P, N) rows
    y       = s' . C[g] + D[h] xs                           f32, not rounded
    v       = y * silu(gate[c])
    out     = v rsqrt(mean over the group's CpG channels of v^2 + eps) norm_w[c]

with dA = exp(dt A), A = -exp(A_log), dt already processed (softplus of dt +
dt_bias, clamped). B and C are the post-conv streams: their convs and the dt
processing stay outside, as in the JAX package. Unlike the unfused path, xs
and y are not rounded to the input dtype before the norm.

`fused_mamba_decode` takes the plain version (`fused_mamba_decode_plain`)
for a CPU tensor and the kernel (csrc/decode_fused.cu) for a CUDA tensor,
which launches or raises. The kernel writes a new conv state and a new ssm
state; the caller's old ones are left as they were.
"""

from __future__ import annotations

import torch

from timeviper_tpu_torch.ops import _cuda

__all__ = ["fused_mamba_decode", "fused_mamba_decode_plain", "fused_mamba_decode_supported"]


def fused_mamba_decode_supported(cfg) -> bool:
    """Shape gates of the fused step (timeviper_tpu/ops/decode_fused.py:165),
    without the JAX package's clause that the backend be the TPU."""
    d_inner = cfg.mamba_intermediate_size
    G, H, N = cfg.mamba_n_groups, cfg.mamba_num_heads, cfg.ssm_state_size
    return (cfg.mamba_hidden_act == "silu" and H % G == 0
            and (d_inner // G) % 128 == 0 and N % 128 == 0)


def fused_mamba_decode_plain(xr, Bv, Cv, dtf, gate, conv_state_x, ssm_state, conv_w, conv_b,
                             A_log, D, norm_w, *, n_groups: int, head_dim: int, eps: float):
    """K7's plain version. xr, gate (B, d_inner); Bv, Cv (B, G*N) post-conv;
    dtf (B, H) processed; conv_state_x (B, d_inner, K); ssm_state (B, H, P, N)
    f32; conv_w (d_inner, K), conv_b, norm_w (d_inner,); A_log, D (H,).
    Returns (y (B, d_inner) in xr's dtype, new conv state, new ssm state)."""
    Bsz, H = dtf.shape
    G, P = n_groups, head_dim
    N = Bv.shape[1] // G
    d_inner = xr.shape[1]
    CpG = d_inner // G
    new_cs = torch.cat([conv_state_x[..., 1:].float(), xr.float()[..., None]], dim=-1)
    xs = (new_cs * conv_w.float()).sum(-1) + conv_b.float()
    xs = xs * torch.sigmoid(xs)
    dtf = dtf.float()
    dA = torch.exp(dtf * -torch.exp(A_log.float()))
    xh = xs.reshape(Bsz, H, P)
    Bh = Bv.float().reshape(Bsz, G, 1, N).expand(Bsz, G, H // G, N).reshape(Bsz, H, 1, N)
    Ch = Cv.float().reshape(Bsz, G, 1, N).expand(Bsz, G, H // G, N).reshape(Bsz, H, 1, N)
    new_s = ssm_state.float() * dA[..., None, None] + (dtf[..., None] * xh)[..., None] * Bh
    y = (new_s * Ch).sum(-1) + D.float()[None, :, None] * xh
    z = gate.float()
    v = (y.reshape(Bsz, d_inner) * (z * torch.sigmoid(z))).reshape(Bsz, G, CpG)
    ms = (v * v).sum(-1, keepdim=True) / CpG
    out = v * torch.rsqrt(ms + eps) * norm_w.float().reshape(G, CpG)
    return (out.reshape(Bsz, d_inner).to(xr.dtype), new_cs.to(conv_state_x.dtype),
            new_s.to(ssm_state.dtype))


def fused_mamba_decode(xr, Bv, Cv, dtf, gate, conv_state_x, ssm_state, conv_w, conv_b,
                       A_log, D, norm_w, *, n_groups: int, head_dim: int, eps: float):
    """One decode token through the fused step; arguments and result as
    `fused_mamba_decode_plain`."""
    if xr.device.type == "cpu":
        return fused_mamba_decode_plain(xr, Bv, Cv, dtf, gate, conv_state_x, ssm_state,
                                        conv_w, conv_b, A_log, D, norm_w, n_groups=n_groups,
                                        head_dim=head_dim, eps=eps)
    Bsz, H = dtf.shape
    G, P = n_groups, head_dim
    d_inner = xr.shape[1]
    N = Bv.shape[1] // G
    K = conv_state_x.shape[-1]
    CpG = d_inner // G

    def need(cond, msg):
        if not cond:
            raise ValueError(f"fused_mamba_decode kernel: {msg}")

    dev = xr.device
    need(H % G == 0 and H * P == d_inner and CpG % 128 == 0 and CpG // 128 <= 8,
         f"takes channel blocks of 128 to 1024 per group, got {CpG}")
    need(N % 128 == 0 and N <= 512 and 1 <= K <= 8, f"takes N % 128 == 0 up to 512, K <= 8")
    for name, t, shape in (("xr", xr, (Bsz, d_inner)), ("gate", gate, (Bsz, d_inner))):
        need(t.device == dev and t.dtype == torch.bfloat16 and t.shape == shape
             and t.stride(1) == 1, f"{name} must be bf16 {shape} with unit column stride")
    for name, t, shape in (("Bv", Bv, (Bsz, G * N)), ("Cv", Cv, (Bsz, G * N)),
                           ("conv_state_x", conv_state_x, (Bsz, d_inner, K))):
        need(t.device == dev and t.dtype == torch.bfloat16 and t.shape == shape
             and t.is_contiguous(), f"{name} must be contiguous bf16 {shape}")
    for name, t, shape in (("dtf", dtf, (Bsz, H)), ("ssm_state", ssm_state, (Bsz, H, P, N)),
                           ("conv_w", conv_w, (d_inner, K)), ("conv_b", conv_b, (d_inner,)),
                           ("A_log", A_log, (H,)), ("D", D, (H,)), ("norm_w", norm_w, (d_inner,))):
        need(t is not None and t.device == dev and t.dtype == torch.float32
             and t.shape == shape and t.is_contiguous(), f"{name} must be contiguous f32 {shape}")
    y = torch.empty(Bsz, d_inner, dtype=xr.dtype, device=dev)
    new_cs = torch.empty_like(conv_state_x)
    new_s = torch.empty_like(ssm_state)
    p = _cuda.ptr
    err = _cuda.lib().tv_decode_fused(
        p(xr), p(Bv), p(Cv), p(dtf), p(gate), p(conv_state_x), p(ssm_state), p(conv_w),
        p(conv_b), p(A_log), p(D), p(norm_w), p(y), p(new_cs), p(new_s),
        Bsz, H, P, G, N, K, xr.stride(0), gate.stride(0), eps, _cuda.stream_of(xr))
    _cuda.check(err, "tv_decode_fused")
    fused_mamba_decode.launches += 1
    return y, new_cs, new_s


fused_mamba_decode.launches = 0
