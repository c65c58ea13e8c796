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
"""

import numpy as np
import pytest
import torch
from torch_parity import packed_seq, require_cuda, rng, t

from timeviper_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from timeviper_tpu_torch.ops.ssd import ssd_chunked
from timeviper_tpu_torch.ops.ssd_kernel import ssd_scan
from timeviper_tpu_torch.ops.vit_attention import vit_attention_qkv, vit_attention_qkv_plain

pytestmark = pytest.mark.cuda


def _close(got, want, rel):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= rel * max(want.abs().max().item(), 1.0), err


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
