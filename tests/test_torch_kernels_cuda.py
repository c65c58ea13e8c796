"""The hand-written CUDA kernels against their plain PyTorch versions, on a
CUDA card. Every test is marked `cuda` and skips without a card. The file
imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(`--noconftest`: tests/conftest.py configures JAX.) Inputs are bf16. The
kernels feed bf16 operands to the tensor cores and sum in f32, as the TPU
kernels feed their MXU; the plain versions sum f32 products, round their
output to bf16 (2^-8 relative), and the plain attention rounds its
probabilities to bf16 before the PV product. Hence a tolerance of 1e-2 of
the output's largest magnitude, for the SSD's f32 final state too.

The backward kernels (K4 in csrc/ssd_bwd.cu, K2-bwd in csrc/flash_bwd.cu)
are held against autograd through the plain versions, each gradient within
BWD_TOL of its largest magnitude: the kernels feed bf16 operands (among them
the rounded decay and probability tiles) to the tensor cores where the plain
versions multiply in f32, and a gradient sums many such products. Both must
give bitwise-equal gradients on a repeat (no atomics).
"""

import numpy as np
import pytest
import torch
from torch_parity import packed_seq, require_cuda, rng, t

from timeviper_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from timeviper_tpu_torch.ops.ssd import ssd_chunked
from timeviper_tpu_torch.ops.ssd_kernel import ssd_scan, ssd_scan_bwd, ssd_scan_bwd_plain
from timeviper_tpu_torch.ops.vit_attention import vit_attention_qkv, vit_attention_qkv_plain

pytestmark = pytest.mark.cuda


BWD_TOL = 3e-2


def _close(got, want, rel, floor=1.0):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= rel * max(want.abs().max().item(), floor), err


@pytest.mark.parametrize("packed", [None, (37, 170), (64, 128)])
def test_ssd_kernel_matches_plain(packed):
    """Ragged tail (L = 300, chunks of 64), a -1 pad plus one boundary, both
    inside chunks or both on chunk edges, and a carried initial state."""
    dev = require_cuda()
    r = rng(3)
    B, L, H, P, G, N, cs = 2, 300, 16, 64, 4, 128, 64
    bf = lambda *s, k=1.0: t(r.standard_normal(s, np.float32) * k).to(dev, torch.bfloat16)  # noqa: E731
    x, dt, Bm, Cm = bf(B, L, H, P), bf(B, L, H, k=0.5), bf(B, L, G, N), bf(B, L, G, N)
    A = t(-np.exp(r.standard_normal(H).astype(np.float32))).to(dev)
    D, dtb = (t(r.standard_normal(H).astype(np.float32)).to(dev) for _ in range(2))
    h0 = t(r.standard_normal((B, H, P, N), np.float32)).to(dev)
    seq = t(packed_seq(B, L, *packed)).to(dev) if packed else None
    kw = dict(chunk_size=cs, D=D, dt_bias=dtb, seq_idx=seq, initial_state=h0)
    y, st = ssd_scan(x, dt, A, Bm, Cm, **kw)
    yp, sp = ssd_chunked(x, dt, A, Bm, Cm, **kw)
    _close(y, yp, 1e-2)
    _close(st, sp, 1e-2)


@pytest.mark.parametrize("L,packed", [(200, (13, 100)), (256, (64, 128)), (64, None)])
def test_flash_kernel_matches_plain(L, packed):
    """Ragged tail or not; a -1 pad plus one boundary inside tiles or on the
    64-row tile edges."""
    dev = require_cuda()
    r = rng(1)
    B, Hq, Hkv, D = 2, 8, 2, 128
    q, k, v = (t(r.standard_normal((B, L, h, D), np.float32)).to(dev, torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
    seg = t(packed_seq(B, L, *packed)).to(dev) if packed else None
    _close(flash_attention(q, k, v, segment_ids=seg),
           flash_attention_plain(q, k, v, segment_ids=seg), 1e-2)


@pytest.mark.parametrize("T,hd", [(729, 72), (100, 64)])
def test_vit_kernel_matches_plain(T, hd):
    dev = require_cuda()
    F, H = 3, 16
    qkv = t(rng(2).standard_normal((F, T, 3 * H * hd), np.float32)).to(dev, torch.bfloat16)
    _close(vit_attention_qkv(qkv, H, hd), vit_attention_qkv_plain(qkv, H, hd), 1e-2)


def test_kernels_raise_on_what_they_do_not_take():
    dev = require_cuda()
    q = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16, device=dev)  # head dim 64
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    with pytest.raises(ValueError):
        vit_attention_qkv(torch.zeros(1, 8, 3 * 4 * 40, device=dev), 4, 40)  # f32


def _ssd_case(seed, B, L, H, G, packed, cs, dev, init=False):
    r = rng(seed)
    bf = lambda *s, k=1.0: t(r.standard_normal(s, np.float32) * k).to(dev, torch.bfloat16)  # noqa: E731
    P, N = 64, 128
    args = dict(x=bf(B, L, H, P), dt=bf(B, L, H, k=0.5), A=t(-np.exp(r.standard_normal(H).astype(np.float32))).to(dev),
                B_=bf(B, L, G, N), C=bf(B, L, G, N))
    D, dtb = (t(r.standard_normal(H).astype(np.float32)).to(dev) for _ in range(2))
    h0 = t(r.standard_normal((B, H, P, N), np.float32)).to(dev) if init else None
    seq = t(packed_seq(B, L, *packed)).to(dev) if packed else None
    dy, dfin = bf(B, L, H, P), t(r.standard_normal((B, H, P, N), np.float32)).to(dev)
    return args, D, dtb, h0, seq, dy, dfin


@pytest.mark.parametrize("L,packed,init", [(300, None, True), (300, (37, 170), False),
                                           (256, (64, 128), False)])
def test_ssd_backward_kernel_matches_plain(L, packed, init):
    """K4 through SSDScanFn: a ragged tail (L = 300, chunks of 64), a -1 pad
    with a boundary inside chunks or both on chunk edges, a final-state
    cotangent, and an initial state; bitwise repeatable."""
    dev = require_cuda()
    B, H, G, cs = 2, 16, 4, 64
    args, D, dtb, h0, seq, dy, dfin = _ssd_case(4, B, L, H, G, packed, cs, dev, init)

    def kernel_grads():
        leaves = [v.detach().clone().requires_grad_() for v in (*args.values(), D, dtb)]
        if h0 is not None:
            leaves.append(h0.detach().clone().requires_grad_())
        y, st = ssd_scan(*leaves[:5], chunk_size=cs, D=leaves[5], dt_bias=leaves[6],
                         seq_idx=seq, initial_state=leaves[7] if h0 is not None else None)
        return torch.autograd.grad((y, st), leaves, (dy, dfin))

    got = kernel_grads()
    want = ssd_scan_bwd_plain(*args.values(), D, dtb, seq, dy, dfin, cs, initial_state=h0)
    for g, w in zip(got, [w for w in want if w is not None]):
        _close(g, w, BWD_TOL, floor=0.0)
    assert all(torch.equal(a, b) for a, b in zip(got, kernel_grads()))


def test_ssd_backward_wrapper_counts_its_launches():
    dev = require_cuda()
    args, D, dtb, _, seq, dy, _ = _ssd_case(5, 1, 128, 8, 2, None, 64, dev)
    from timeviper_tpu_torch.ops.ssd_kernel import ssd_scan_fwd

    _, _, states = ssd_scan_fwd(*args.values(), 64, D, dtb, (0.0, float("inf")), seq, None)
    before = ssd_scan_bwd.launches
    ssd_scan_bwd(*args.values(), D, dtb, seq, states, dy, None, 64)
    assert ssd_scan_bwd.launches == before + 1


@pytest.mark.parametrize("L,packed,Hq,Hkv", [(200, (13, 100), 8, 2), (256, (64, 128), 8, 2),
                                             (64, None, 4, 4)])
def test_flash_backward_kernel_matches_plain(L, packed, Hq, Hkv):
    """K2-bwd through FlashAttnFn: ragged tiles or tile-edge boundaries, a -1
    pad, GQA; bitwise repeatable."""
    dev = require_cuda()
    r = rng(6)
    B, D = 2, 128
    q, k, v = (t(r.standard_normal((B, L, h, D), np.float32)).to(dev, torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
    g = t(r.standard_normal((B, L, Hq, D), np.float32)).to(dev, torch.bfloat16)
    seg = t(packed_seq(B, L, *packed)).to(dev) if packed else None

    def kernel_grads():
        leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
        out = flash_attention(*leaves, segment_ids=seg)
        return torch.autograd.grad(out, leaves, g)

    before = flash_attention_bwd.launches
    got = kernel_grads()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(q, k, v, g, seg)
    for a, b in zip(got, want):
        _close(a, b, BWD_TOL, floor=0.0)
    assert all(torch.equal(a, b) for a, b in zip(got, kernel_grads()))
