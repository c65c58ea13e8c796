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

K6 (csrc/vit_attn.cu) is held to the same 1e-2 as K3, with v read as a
strided column slice of a fused qkv buffer.

K9 (csrc/block_attn.cu) is held to 1e-2 of each output's largest magnitude
(TransV's cross_attention runs it at the 9B's pdrop shapes, with an all-zero
slot that must give exactly 0)
(o, and the row sums l and maxima m of the scaled logits), in both modes, on
k and v read as row ranges of a cache buffer, with an empty key block and
with rows that see no key (l = 0, m = -inf, o = 0 on both sides); also where
ops/block_attention.py:block_attn_plan splits the keys across blocks (a
ragged Lk of 5,000, segments across a split boundary, Lq 1 and 12, GQA
groups of 1 and 4), where a repeat must give the same bits (the splits merge
in a fixed order, with no atomics). K6 must repeat its bits too.

K2 (csrc/flash_fwd.cu) and K3 (csrc/vit_attn_qkv.cu) run on
csrc/attn_sm90.cuh like K9 and K6 and must repeat their bits too; K2's row
log-sum-exp, which K2-bwd takes, is held to 1e-4 of its largest magnitude
(f32 sums of the same bf16 logits in another order). K2 also runs at every
tile of FLASH_TILES (the K2 microbenchmark's sweep), and K10a (csrc/headgrid_attn.cu, the ViT attention microbenchmark's
head-grid kernel) at 1, 2 and 4 heads a block, with the exp and without it,
both to 1e-2 of the largest magnitude like the other forward kernels (K10a
with no floor of 1: its outputs are averages of v, far below 1).

The qwen2 backbones' GQA groups (28 / 4, 16 / 2, 12 / 2: query-head packs of
1, 8 and 2) run K2, K9 and, for qwen2 training, K2-bwd; the speculative
verify runs K9 at 8 queries over an 8,448-row prefix and an 8 x 8 causal
block, and K1 on 8 rows from a carried state.

K2-bwd's non-causal mode (TransV's cross-attention backward, separate
query and key lengths) runs through ops/attention.py:cross_attention under
autograd (BlockAttnFn: K9 forward, one launch of each) at TransV's shapes
and others, four query-head packs, B 1 and 2, held against its plain
version (cross_attention_bwd_plain: the same formulas in f32 from K9's
output) to BWD_TOL and bitwise repeatable; an empty side gives
zeros with no launch, and it runs as a fresh thread's first CUDA work.

K3's and K6's LSE variants give the row log-sum-exp to 1e-4 of its largest
magnitude (as K2's). The ViT attention backward (csrc/vit_attn_bwd.cu, the
tower's training) runs through encoder_attention_qkv and encoder_attention
under autograd (VitAttnQKVFn, VitAttnFn: K3 or K6 with its LSE, one launch
of each) at SigLIP's (729, 72), DINOv2-L's (734, 64) and InternVideo2's
(1,025, 88) frames and at ragged lengths, q, k and v read in place from the
fused rows (InternVideo2's v a column slice), held to BWD_TOL against
autograd through the plain f32 forward and against its plain version
(the same formulas in f32 from the kernel's own output and LSE), and
bitwise repeatable.

K5, K7 and K8 (csrc/ssd_fwd.cu with the conv fused in, csrc/decode_fused.cu,
csrc/layernorm.cu) are held to 1e-2 of the plain result's largest magnitude
like the other forward kernels; K8's int8 codes may differ by 1 at no more
than 0.1% of elements (ties of y * act_inv, whose sums differ in order).

The layer-streamed offload trainer (train/offload.py) takes three steps
through its pinned, double-buffered transfers and through blocking copies,
on eight layers whose block types repeat: the losses and the host masters
agree to 1e-6, so no buffer is reused before the copy that reads it is done.
"""

import threading

import numpy as np
import pytest
import torch
from torch_parity import packed_seq, require_cuda, rng, row_pads, t

from timeviper_tpu_torch.ops import block_attention as block_attention_mod
from timeviper_tpu_torch.ops.attention import attention, cross_attention
from timeviper_tpu_torch.ops import flash_attention as flash_attention_mod
from timeviper_tpu_torch.ops import headgrid_attention as headgrid_attention_mod
from timeviper_tpu_torch.ops import vit_attention as vit_attention_mod
from timeviper_tpu_torch.ops.block_attention import (
    ATTN_BKV,
    block_attn_lse,
    block_attn_lse_plain,
    block_attn_plan,
    row_lse,
)
from timeviper_tpu_torch.ops.decode_fused import (
    fused_mamba_decode,
    fused_mamba_decode_plain,
)
from timeviper_tpu_torch.ops.flash_attention import (
    FLASH_TILES,
    cross_attention_bwd,
    cross_attention_bwd_plain,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_plain,
    flash_lse_plain,
)
from timeviper_tpu_torch.ops.headgrid_attention import (
    HPP,
    headgrid_attention,
    headgrid_attention_plain,
    pad_heads,
)
from timeviper_tpu_torch.ops.ssd import ssd_chunked
from timeviper_tpu_torch.ops.int8_linear import Int8Linear, apply_linear_w8a8
from timeviper_tpu_torch.ops.layernorm import fused_ln, fused_ln_plain
from timeviper_tpu_torch.ops.ssd_kernel import (
    kernel_chunk,
    ssd_conv_scan_fused,
    ssd_conv_scan_fused_plain,
    ssd_scan,
    ssd_scan_bwd,
    ssd_scan_bwd_plain,
    ssd_scan_fwd,
)
from timeviper_tpu_torch.ops.vit_attention import (
    encoder_attention,
    encoder_attention_qkv,
    vit_attention,
    vit_attention_bwd,
    vit_attention_bwd_plain,
    vit_attention_lse_plain,
    vit_attention_plain,
    vit_attention_qkv,
    vit_attention_qkv_bwd_plain,
    vit_attention_qkv_lse_plain,
    vit_attention_qkv_plain,
)

pytestmark = pytest.mark.cuda


BWD_TOL = 3e-2


def _close(got, want, rel, floor=1.0):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= rel * max(want.abs().max().item(), floor), err


@pytest.mark.parametrize("B,L,H,G,cs,packed,init", [
    (2, 300, 16, 4, 64, None, True),         # ragged tail, chunks of 64, a carried state
    (2, 300, 16, 4, 64, (37, 170), True),    # a -1 pad and a boundary inside chunks
    (2, 300, 16, 4, 64, (64, 128), True),    # both on chunk edges
    (1, 12, 128, 8, 256, None, True),        # a question's 12 rows at the 9B's widths
    (1, 600, 32, 2, 256, (37, 450), False),  # the 9B's 16 heads a group, chunks of 256
    (2, 300, 4, 4, 64, (13, 140), False),    # H == G: one head a group
    (2, 512, 16, 4, 256, (64, 128), False),  # tile pairs masked whole by the segments
    (1, 700, 16, 4, 512, (37, 450), True),   # chunks of 512
    (1, 1100, 16, 4, 1024, None, False),     # chunks of 1,024
    (2, 200, 16, 4, 128, (5, 70), True),     # chunks of two tiles, B 2
    # the 256-frame pdrop prefill after its stages: the 4,056-row left pad,
    # then one segment of 7,372 or 6,553 rows in all (no multiple of 256 or
    # 128; 6,553 odd)
    (1, 7372, 128, 8, 256, (4056, 7372), False),
    (1, 6553, 128, 8, 256, (4056, 6553), False),
])
def test_ssd_kernel_matches_plain(B, L, H, G, cs, packed, init):
    """K1 against ssd_chunked: y and the final state, a bitwise repeat, and
    the f32 inbound states the training forward keeps for K4 against the
    plain final state of each chunk's prefix (chunks of kernel_chunk(cs)
    rows). The 9B's A (down to -128) at its widths, -exp(N(0, 1)) else."""
    dev = require_cuda()
    r = rng(3)
    P, N = 64, 128
    bf = lambda *s, k=1.0: t(r.standard_normal(s, np.float32) * k).to(dev, torch.bfloat16)  # noqa: E731
    x, dt, Bm, Cm = bf(B, L, H, P), bf(B, L, H, k=0.5), bf(B, L, G, N), bf(B, L, G, N)
    if H == 128:
        A = -torch.arange(1, H + 1, dtype=torch.float32, device=dev)
    else:
        A = t(-np.exp(r.standard_normal(H).astype(np.float32))).to(dev)
    D, dtb = (t(r.standard_normal(H).astype(np.float32)).to(dev) for _ in range(2))
    h0 = t(r.standard_normal((B, H, P, N), np.float32)).to(dev) if init else None
    seq = t(packed_seq(B, L, *packed)).to(dev) if packed else None
    kw = dict(chunk_size=cs, D=D, dt_bias=dtb, seq_idx=seq, initial_state=h0)
    y, st = ssd_scan(x, dt, A, Bm, Cm, **kw)
    yp, sp = ssd_chunked(x, dt, A, Bm, Cm, **kw)
    _close(y, yp, 1e-2)
    _close(st, sp, 1e-2)
    y2, st2 = ssd_scan(x, dt, A, Bm, Cm, **kw)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    y3, st3, states = ssd_scan_fwd(x, dt, A, Bm, Cm, cs, D, dtb, (0.0, float("inf")), seq, h0,
                                      keep_states=True)
    assert torch.equal(y, y3) and torch.equal(st, st3)
    kc = kernel_chunk(cs)
    assert states.shape == (B, -(-L // kc), H, P, N)
    for c in range(states.shape[1]):
        if c == 0:
            want = h0 if init else torch.zeros_like(states[:, 0])
        else:
            n = c * kc
            _, want = ssd_chunked(x[:, :n], dt[:, :n], A, Bm[:, :n], Cm[:, :n], chunk_size=kc,
                                  D=D, dt_bias=dtb, seq_idx=None if seq is None else seq[:, :n],
                                  initial_state=h0)
        _close(states[:, c], want, 1e-2)


@pytest.mark.parametrize("case", ["causal", "prefix rows", "ragged masked", "empty", "valid"])
def test_block_attention_kernel_matches_plain(case):
    """Causal Lq = Lk = 200 with segments; the non-causal prefix part of a
    continuation (q 70 rows against rows [5, 230) of a 2-batch cache
    buffer); a ragged Lk of 301 whose first 37 rows are masked by seg_kv and
    a query segment with no key; an empty block; valid_kv / valid_q."""
    dev = require_cuda()
    r = rng(5)
    B, Hq, Hkv, D = 2, 8, 2, 128
    bf = lambda *s: t(r.standard_normal(s, np.float32)).to(dev, torch.bfloat16)  # noqa: E731
    Lq = 200 if case == "causal" else 70
    q = bf(B, Lq, Hq, D)
    kw, dead = {}, None
    if case == "causal":
        k, v = bf(B, Lq, Hkv, D), bf(B, Lq, Hkv, D)
        seg = t(packed_seq(B, Lq, 13, 100)).to(dev)
        kw = dict(causal=True, seg_q=seg, seg_kv=seg)
    elif case == "prefix rows":
        buf_k, buf_v = bf(B, 256, Hkv, D), bf(B, 256, Hkv, D)
        k, v = buf_k[:, 5:230], buf_v[:, 5:230]
    elif case == "ragged masked":
        k, v = bf(B, 301, Hkv, D), bf(B, 301, Hkv, D)
        seg_kv = torch.zeros(B, 301, dtype=torch.int32, device=dev)
        seg_kv[:, :37] = 1
        seg_q = torch.zeros(B, Lq, dtype=torch.int32, device=dev)
        seg_q[:, 3] = 2  # sees no key
        kw, dead = dict(seg_q=seg_q, seg_kv=seg_kv), 3
    elif case == "empty":
        k, v = bf(B, 0, Hkv, D), bf(B, 0, Hkv, D)
    else:
        k, v = bf(B, 150, Hkv, D), bf(B, 150, Hkv, D)
        kw = dict(valid_kv=torch.arange(150, device=dev) % 7 != 3,
                  valid_q=torch.arange(Lq, device=dev) % 5 != 1)
    before = block_attn_lse.launches
    o, l, m = block_attn_lse(q, k, v, **kw)
    assert block_attn_lse.launches == before + 1
    po, pl, pm = block_attn_lse_plain(q, k, v, **kw)
    _close(o, po, 1e-2)
    _close(l, pl, 1e-2)
    assert torch.equal(torch.isneginf(m), torch.isneginf(pm))
    _close(torch.where(torch.isneginf(pm), 0.0, m), torch.where(torch.isneginf(pm), 0.0, pm),
           1e-2)
    if case == "empty":
        dead = slice(None)
    if dead is not None:
        assert (l[:, :, dead] == 0).all() and torch.isneginf(m[:, :, dead]).all()
        assert (o[:, dead] == 0).all()


@pytest.mark.parametrize("case", ["ragged", "segments", "question 1", "question 12",
                                  "group 1"])
def test_block_attention_split_kernel_matches_plain(case):
    """Shapes where the plan splits the keys: 40 rows (or 1, or 12) of 32
    heads against a ragged Lk of 5,000 (39 tiles and 8 keys) on 8 KV heads
    (GQA groups of 4) or 32 (groups of 1). `segments`: row 0 sees only
    keys of the first split, row 1 none at all, row 2 a segment that
    crosses the first split boundary."""
    dev = require_cuda()
    r = rng(11)
    B, Hq, D, Lk = 1, 32, 128, 5000
    Hkv = 32 if case == "group 1" else 8
    Lq = {"question 1": 1, "question 12": 12}.get(case, 40)
    bf = lambda *s: t(r.standard_normal(s, np.float32)).to(dev, torch.bfloat16)  # noqa: E731
    q, k, v = bf(B, Lq, Hq, D), bf(B, Lk, Hkv, D), bf(B, Lk, Hkv, D)
    _, n_split, split_tiles = block_attn_plan(B, Lq, Lk, Hq, Hkv)
    assert n_split > 1
    kw = {}
    if case == "segments":
        edge = split_tiles * ATTN_BKV
        seg_kv = torch.zeros(B, Lk, dtype=torch.int32, device=dev)
        seg_kv[:, :100] = 1
        seg_kv[:, edge - 50:edge + 50] = 2
        seg_q = torch.zeros(B, Lq, dtype=torch.int32, device=dev)
        seg_q[:, 0], seg_q[:, 1], seg_q[:, 2] = 1, 9, 2
        kw = dict(seg_q=seg_q, seg_kv=seg_kv)
    before = block_attn_lse.launches
    got = block_attn_lse(q, k, v, **kw)
    assert block_attn_lse.launches == before + 1
    o, l, m = got
    po, pl, pm = block_attn_lse_plain(q, k, v, **kw)
    _close(o, po, 1e-2)
    _close(l, pl, 1e-2)
    assert torch.equal(torch.isneginf(m), torch.isneginf(pm))
    _close(torch.where(torch.isneginf(pm), 0.0, m), torch.where(torch.isneginf(pm), 0.0, pm),
           1e-2)
    if case == "segments":
        assert (l[:, :, 1] == 0).all() and torch.isneginf(m[:, :, 1]).all()
        assert (o[:, 1] == 0).all()
    again = block_attn_lse(q, k, v, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("L,packed", [(200, (13, 100)), (256, (64, 128)), (64, None),
                                      (1, None), (63, (5, 40)), (300, (13, 140)),
                                      (300, (32, 128)), (203, "rows"), (7372, (4056, 7372)),
                                      (6553, (4056, 6553))])
def test_flash_kernel_matches_plain(L, packed):
    """Ragged tail or not (L 1, 63, 203, 300: L % 4 != 0 too, so the key ids
    are padded); a -1 pad plus one boundary inside tiles, or on the 32-token
    block and 128-key tile edges; B 3 with a pad of its own per row; the
    256-frame pdrop prefill's lengths after its stages (7,372 and 6,553
    behind the 4,056-row pad). A repeat gives the same bits."""
    dev = require_cuda()
    r = rng(1)
    B, Hq, Hkv, D = (3 if packed == "rows" else 2), 8, 2, 128
    q, k, v = (t(r.standard_normal((B, L, h, D), np.float32)).to(dev, torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
    seg = None
    if packed == "rows":
        seg = t(row_pads(B, L, (0, 17, 130))).to(dev)
    elif packed:
        seg = t(packed_seq(B, L, *packed)).to(dev)
    got = flash_attention(q, k, v, segment_ids=seg)
    _close(got, flash_attention_plain(q, k, v, segment_ids=seg), 1e-2)
    assert torch.equal(got, flash_attention(q, k, v, segment_ids=seg))


# the qwen2 backbones' GQA groups: 28 / 4 (qwen2.5-7b, 7 query heads a KV
# head: blocks of 1 head), 16 / 2 (qwen2.5-3b: 8) and 12 / 2 (qwen2-1.5b: 2)
QWEN2_GQA = [(28, 4), (16, 2), (12, 2)]


@pytest.mark.parametrize("Hq,Hkv", QWEN2_GQA)
@pytest.mark.parametrize("L,packed", [(300, (13, 140)), (256, None), (4096, (1000, 2500))])
def test_flash_kernel_at_the_qwen2_gqa_groups(Hq, Hkv, L, packed):
    """K2 at query-head packs of 1, 8 and 2 (ops/block_attention.py:gqa_pack),
    segmented (a -1 pad and a boundary) and not, against its plain version to
    1e-2; one launch; a repeat gives the same bits."""
    dev = require_cuda()
    r = rng(21)
    B = 1 if L == 4096 else 2
    q, k, v = (t(r.standard_normal((B, L, h, 128), np.float32)).to(dev, torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
    seg = t(packed_seq(B, L, *packed)).to(dev) if packed else None
    before = flash_attention.launches
    got = flash_attention(q, k, v, segment_ids=seg)
    assert flash_attention.launches == before + 1
    _close(got, flash_attention_plain(q, k, v, segment_ids=seg), 1e-2)
    assert torch.equal(got, flash_attention(q, k, v, segment_ids=seg))


@pytest.mark.parametrize("Hq,Hkv", QWEN2_GQA)
@pytest.mark.parametrize("case", ["decode 1", "question 40", "causal 4096", "no key"])
def test_block_attention_kernel_at_the_qwen2_gqa_groups(Hq, Hkv, case):
    """K9 at query-head packs of 1, 8 and 2: a decode step's 1 row and a
    question's 40 against 8,448 rows [3, 8451) of a cache buffer (split
    keys, as the qwen2 decode and continuation read them); the causal
    suffix part at 4,096; 40 rows whose row 5 sees no key (l 0, m -inf, o
    0). Against the plain version to 1e-2; one launch; a repeat gives the
    same bits."""
    dev = require_cuda()
    r = rng(22)
    bf = lambda *s: t(r.standard_normal(s, np.float32)).to(dev, torch.bfloat16)  # noqa: E731
    kw, dead = {}, None
    if case == "causal 4096":
        q, k, v = bf(1, 4096, Hq, 128), bf(1, 4096, Hkv, 128), bf(1, 4096, Hkv, 128)
        kw = dict(causal=True)
    else:
        Lq = 1 if case == "decode 1" else 40
        buf_k, buf_v = bf(1, 8460, Hkv, 128), bf(1, 8460, Hkv, 128)
        q, k, v = bf(1, Lq, Hq, 128), buf_k[:, 3:8451], buf_v[:, 3:8451]
        assert block_attn_plan(1, Lq, k.shape[1], Hq, Hkv)[1] > 1
        if case == "no key":
            seg_q = torch.zeros(1, Lq, dtype=torch.int32, device=dev)
            seg_q[:, 5] = 7
            kw, dead = dict(seg_q=seg_q, seg_kv=torch.zeros(1, k.shape[1], dtype=torch.int32,
                                                            device=dev)), 5
    before = block_attn_lse.launches
    got = block_attn_lse(q, k, v, **kw)
    assert block_attn_lse.launches == before + 1
    o, l, m = got
    po, pl, pm = block_attn_lse_plain(q, k, v, **kw)
    _close(o, po, 1e-2)
    _close(l, pl, 1e-2)
    assert torch.equal(torch.isneginf(m), torch.isneginf(pm))
    _close(torch.where(torch.isneginf(pm), 0.0, m), torch.where(torch.isneginf(pm), 0.0, pm),
           1e-2)
    if dead is not None:
        assert (l[:, :, dead] == 0).all() and torch.isneginf(m[:, :, dead]).all()
        assert (o[:, dead] == 0).all()
    again = block_attn_lse(q, k, v, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("Lq,Lk,B", [(32, 820, 1), (32, 819, 8), (1, 819, 1), (1, 820, 8)])
def test_transv_cross_attention_runs_the_block_kernel(Lq, Lk, B):
    """TransV's cross_attention on the card is K9's non-causal mode: the 9B's
    32 query and 8 KV heads, a prefill's 32 suffix rows or a decode step's 1
    against the 820 / 819 tokens a stage drops (no multiple of 4: the key
    ids are padded), B 1 or 8 slots with the last slot's K/V all zero, which
    gives exactly 0. Against the plain `attention`, to 1e-2 of its largest
    value (no floor: the outputs are averages of v). A repeat gives the same
    bits."""
    dev = require_cuda()
    r = rng(17)
    Hq, Hkv, D = 32, 8, 128
    bf = lambda *s: t(r.standard_normal(s, np.float32)).to(dev, torch.bfloat16)  # noqa: E731
    q, k, v = bf(B, Lq, Hq, D), bf(B, Lk, Hkv, D), bf(B, Lk, Hkv, D)
    k[-1], v[-1] = 0, 0
    before = block_attn_lse.launches
    got = cross_attention(q, k, v)
    assert block_attn_lse.launches == before + 1
    _close(got, attention(q, k, v), 1e-2, floor=0.0)
    assert (got[-1] == 0).all()
    assert torch.equal(got, cross_attention(q, k, v))


@pytest.mark.parametrize("Lq,Lk,B", [(40, 1024, 1), (33, 819, 2)])
def test_transv_cross_attention_with_kv_valid_runs_the_block_kernel(Lq, Lk, B):
    """cross_attention(kv_valid=) on the card (sequence-sharded TransV: the
    local rows against every row's K/V, only the dropped tokens valid) is
    K9's non-causal mode with the mask folded into its segment ids, one
    launch: against the plain `attention` with the (B, 1, Lk) mask, to 1e-2
    of its largest value (no floor). Under autograd (BlockAttnFn) the
    gradients run K2-bwd's non-causal mode once a row on its kept keys:
    against autograd through the plain `attention` to BWD_TOL; a masked
    key's gradients are exactly 0."""
    dev = require_cuda()
    r = rng(18)
    Hq, Hkv, D = 32, 8, 128
    q, k, v = _bf16(r, dev, B, Lq, Hq, D), _bf16(r, dev, B, Lk, Hkv, D), \
        _bf16(r, dev, B, Lk, Hkv, D)
    valid = t(r.random((B, Lk)) < 0.3).to(dev)
    before = block_attn_lse.launches
    got = cross_attention(q, k, v, kv_valid=valid)
    assert block_attn_lse.launches == before + 1
    _close(got, attention(q, k, v, valid[:, None, :]), 1e-2, floor=0.0)
    g = _bf16(r, dev, B, Lq, Hq, D)
    leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
    bwd = cross_attention_bwd.launches
    grads = torch.autograd.grad(cross_attention(*leaves, kv_valid=valid), leaves, g)
    assert cross_attention_bwd.launches == bwd + B
    leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
    want = torch.autograd.grad(attention(*leaves, valid[:, None, :]), leaves, g)
    for a, b in zip(grads, want):
        _close(a, b, BWD_TOL, floor=0.0)
    assert (grads[1][~valid] == 0).all() and (grads[2][~valid] == 0).all()


@pytest.mark.parametrize("L,packed", [(1, None), (203, "rows"), (300, (13, 140))])
def test_flash_kernel_lse_matches_plain(L, packed):
    """The row log-sum-exp that K2 writes for K2-bwd, m + log(l) of the
    scaled logits, against the plain one."""
    dev = require_cuda()
    r = rng(13)
    B, Hq, Hkv, D = 3, 8, 2, 128
    q, k, v = (t(r.standard_normal((B, L, h, D), np.float32)).to(dev, torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
    seg = None
    if packed == "rows":
        seg = t(row_pads(B, L, (0, 17, 130))).to(dev)
    elif packed:
        seg = t(packed_seq(B, L, *packed)).to(dev)
    out, lse = flash_attention_fwd(q, k, v, seg, with_lse=True)
    _close(out, flash_attention_plain(q, k, v, segment_ids=seg), 1e-2)
    _close(lse, flash_lse_plain(q, k, seg), 1e-4)


@pytest.mark.parametrize("tile", FLASH_TILES)
@pytest.mark.parametrize("L,packed", [(300, (13, 140)), (256, None)])
def test_flash_kernel_tiles_match_plain(L, packed, tile):
    """K2 at each tile shape of the microbenchmark's sweep: ragged tails
    under 64 and 128 rows, a -1 pad and a boundary inside the tiles."""
    dev = require_cuda()
    r = rng(11)
    B, Hq, Hkv, D = 2, 8, 2, 128
    q, k, v = (t(r.standard_normal((B, L, h, D), np.float32)).to(dev, torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
    seg = t(packed_seq(B, L, *packed)).to(dev) if packed else None
    before = flash_attention.launches
    _close(flash_attention_fwd(q, k, v, seg, False, tile)[0],
           flash_attention_plain(q, k, v, segment_ids=seg), 1e-2)
    assert flash_attention.launches == before + 1


@pytest.mark.parametrize("do_exp", [True, False])
@pytest.mark.parametrize("hpp", HPP)
@pytest.mark.parametrize("T", [729, 1, 193, 734])
def test_headgrid_kernel_matches_plain(T, hpp, do_exp):
    """K10a on SigLIP's heads padded from 72 to 128 columns: 3 frames of 729
    tokens (a ragged last tile of 25 rows and keys, whose padding must not
    enter the row sums), 1, 193 (a last key tile of 1) and 734 (of 30). A
    repeat gives the same bits."""
    dev = require_cuda()
    H, hd = 16, 72
    qkv = t(rng(12).standard_normal((3, T, 3 * H * hd), np.float32))
    qkv = pad_heads(qkv.to(dev, torch.bfloat16), H, hd).contiguous()
    before = headgrid_attention.launches
    got = headgrid_attention(qkv, H, hpp, hd ** -0.5, do_exp)
    assert headgrid_attention.launches == before + 1
    # against the output's own largest value (averages of v stay below 1)
    _close(got, headgrid_attention_plain(qkv, H, hd ** -0.5, do_exp), 1e-2, floor=0.0)
    assert not got.reshape(3, T, H, 128)[..., hd:].any()
    assert torch.equal(got, headgrid_attention(qkv, H, hpp, hd ** -0.5, do_exp))


@pytest.mark.parametrize("T,hd", [(729, 72), (734, 64), (100, 64), (1, 72)])
def test_vit_kernel_matches_plain(T, hd):
    """K3 at SigLIP's (729, 72) and DINOv2-L's (734, 64) frames, whose last
    key tiles hold 25 and 30 keys, at 100 rows and at 1; q, k and v read in
    place from the fused qkv rows. A repeat gives the same bits."""
    dev = require_cuda()
    F, H = 3, 16
    qkv = t(rng(2).standard_normal((F, T, 3 * H * hd), np.float32)).to(dev, torch.bfloat16)
    before = vit_attention_qkv.launches
    got = vit_attention_qkv(qkv, H, hd)
    assert vit_attention_qkv.launches == before + 1
    _close(got, vit_attention_qkv_plain(qkv, H, hd), 1e-2)
    assert torch.equal(got, vit_attention_qkv(qkv, H, hd))


@pytest.mark.parametrize("T", [1025, 300, 65, 1])
def test_whole_clip_kernel_matches_plain(T):
    """K6 on InternVideo2's heads (16 x 88): q and k contiguous, v a column
    slice of a fused qkv buffer (row stride 3 * 1408), as the tower gives
    them; T 1025 (a ragged last key of 1 and a last query row of 1), 300,
    65 and 1. A repeat gives the same bits."""
    dev = require_cuda()
    B, H, hd = 3, 16, 88
    r = rng(9)
    qkv = t(r.standard_normal((B, T, 3 * H * hd), np.float32)).to(dev, torch.bfloat16)
    q, k = (t(r.standard_normal((B, T, H, hd), np.float32)).to(dev, torch.bfloat16)
            for _ in range(2))
    v = qkv[..., 2 * H * hd:].view(B, T, H, hd)
    assert not v.is_contiguous()
    before = vit_attention.launches
    got = vit_attention(q, k, v)
    _close(got, vit_attention_plain(q, k, v), 1e-2)
    assert vit_attention.launches == before + 1
    assert torch.equal(got, vit_attention(q, k, v))


@pytest.mark.parametrize("T,hd", [(729, 72), (734, 64), (1025, 88), (65, 88), (1, 72)])
def test_vit_kernels_lse_variant_matches_plain(T, hd):
    """K3's (hd 72, 64) and K6's (hd 88) LSE variants: the output as without
    it, the row log-sum-exp to 1e-4 of its largest magnitude."""
    dev = require_cuda()
    B, H = 2, 16
    r = rng(31)
    qkv = t(r.standard_normal((B, T, 3 * H * hd), np.float32)).to(dev, torch.bfloat16)
    if hd == 88:
        q, k = (t(r.standard_normal((B, T, H, hd), np.float32)).to(dev, torch.bfloat16)
                for _ in range(2))
        v = qkv[..., 2 * H * hd:].view(B, T, H, hd)
        out, lse = vit_attention(q, k, v, lse=True)
        want_out, want_lse = vit_attention_lse_plain(q, k, v)
        assert torch.equal(out, vit_attention(q, k, v))
    else:
        out, lse = vit_attention_qkv(qkv, H, hd, lse=True)
        want_out, want_lse = vit_attention_qkv_lse_plain(qkv, H, hd)
        assert torch.equal(out, vit_attention_qkv(qkv, H, hd))
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32
    _close(out, want_out, 1e-2)
    _close(lse, want_lse, 1e-4)


VIT_BWD_SHAPES = [(729, 72), (734, 64), (1025, 88), (100, 64), (193, 72), (65, 88), (1, 72)]


@pytest.mark.parametrize("T,hd", VIT_BWD_SHAPES)
def test_vit_attention_backward_kernel_matches_plain(T, hd):
    """The backward kernel under autograd: hd 72 and 64 through
    encoder_attention_qkv on the fused qkv rows (the gradient one fused
    tensor), hd 88 through encoder_attention with v a column slice of the
    fused qkv; one forward (K3 or K6) and one backward launch; held to
    BWD_TOL against autograd through the plain f32 forward and against the
    plain backward from the kernel's own output and LSE; bitwise
    repeatable."""
    dev = require_cuda()
    B, H = 2, 16
    r = rng(37)
    qkv = t(r.standard_normal((B, T, 3 * H * hd), np.float32)).to(dev, torch.bfloat16)
    g = t(r.standard_normal((B, T, H * hd), np.float32)).to(dev, torch.bfloat16)
    fused = hd != 88
    if not fused:
        qk = [t(r.standard_normal((B, T, H, hd), np.float32)).to(dev, torch.bfloat16)
              for _ in range(2)]
    fwd = vit_attention_qkv if fused else vit_attention

    def grads(plain=False):
        leaf = qkv.detach().clone().float().requires_grad_() if plain else \
            qkv.detach().clone().requires_grad_()
        if fused:
            if plain:
                out = vit_attention_qkv_plain(leaf, H, hd)
            else:
                out = encoder_attention_qkv(leaf, H, hd)
            return torch.autograd.grad(out, [leaf], g.to(out.dtype))
        q, k = (x.detach().clone().float() if plain else x.detach().clone()
                for x in qk)
        q.requires_grad_()
        k.requires_grad_()
        v = leaf[..., 2 * H * hd:].view(B, T, H, hd)
        out = (vit_attention_plain if plain else encoder_attention)(q, k, v)
        return torch.autograd.grad(out, [q, k, leaf], g.view(B, T, H, hd).to(out.dtype))

    before = (fwd.launches, vit_attention_bwd.launches)
    got = grads()
    assert (fwd.launches, vit_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    want = grads(plain=True)
    if not fused:  # the qkv buffer's gradient is v's band alone
        assert not got[2].reshape(B, T, 3, H * hd)[:, :, :2].any()
        got_v, want_v = (x.reshape(B, T, 3, H * hd)[:, :, 2] for x in (got[2], want[2]))
        for a, b in ((got[0], want[0]), (got[1], want[1])):
            if T == 1:
                # exactly 0 with one key (dP = D); the kernel's two f32 sums
                # of dO . v, in other orders, cancel to ~1e-6
                assert (a.float() - b.float()).abs().max().item() <= 1e-4
            else:
                _close(a, b, BWD_TOL, floor=0.0)
        _close(got_v, want_v, BWD_TOL, floor=0.0)
    else:
        _close(got[0], want[0], BWD_TOL, floor=0.0)
    # the plain formulas from the kernel's own output and LSE
    if fused:
        out, lse = vit_attention_qkv(qkv, H, hd, lse=True)
        plain = vit_attention_qkv_bwd_plain(qkv, out, g, H, hd, lse)
        _close(got[0], plain, BWD_TOL, floor=0.0)
    else:
        v = qkv[..., 2 * H * hd:].view(B, T, H, hd)
        out, lse = vit_attention(qk[0], qk[1], v, lse=True)
        plain = vit_attention_bwd_plain(qk[0], qk[1], v, out, g.view(B, T, H, hd), lse)
        direct = vit_attention_bwd(qk[0], qk[1], v, out, g.view(B, T, H, hd), lse)
        for a, b in zip(direct, plain):
            _close(a, b, BWD_TOL, floor=0.0)
    assert all(torch.equal(a, b) for a, b in zip(got, grads()))


@pytest.mark.parametrize("name,value", [("ATTN_BKV", 64), ("BLOCK_ROWS", 192),
                                        ("VIT_ATTN_BLOCK_ROWS", 128),
                                        ("VIT_QKV_BLOCK_ROWS", 128),
                                        ("FLASH_TILES", (64, 64)),
                                        ("HEADGRID_TILE", (64, 64)),
                                        ("FLASH_BWD_TILE", (64, 64, 128, 64)),
                                        ("VIT_BWD_TILE", (64, 64))])
def test_attention_kernels_refuse_a_plan_for_another_tile(monkeypatch, name, value):
    """The Python side's tile (the split plan's keys a tile and rows a block,
    K6's and K3's rows a block, K2's, K10a's and K2-bwd's tiles) is checked
    by the C entry point: a plan made for another tile is refused, not
    launched."""
    dev = require_cuda()

    def zeros(heads, hd):
        return torch.zeros(1, 40, heads, hd, dtype=torch.bfloat16, device=dev)

    with pytest.raises(RuntimeError, match="CUDA error"):
        if name == "FLASH_TILES":
            monkeypatch.setattr(flash_attention_mod, name, (value,))
            flash_attention_fwd(zeros(8, 128), zeros(2, 128), zeros(2, 128), None, False,
                                value)
        elif name == "HEADGRID_TILE":
            monkeypatch.setattr(headgrid_attention_mod, name, value)
            headgrid_attention(torch.zeros(1, 40, 3 * 8 * 128, dtype=torch.bfloat16,
                                           device=dev), 8, 1, 0.1)
        elif name == "FLASH_BWD_TILE":
            monkeypatch.setattr(flash_attention_mod, name, value)
            q = zeros(8, 128)
            flash_attention_bwd(q, zeros(2, 128), zeros(2, 128), q, q,
                                torch.zeros(1, 8, 40, device=dev))
        elif name == "VIT_BWD_TILE":
            monkeypatch.setattr(vit_attention_mod, name, value)
            q = zeros(8, 88)
            vit_attention_bwd(q, q, q, q, q, torch.zeros(1, 8, 40, device=dev))
        elif name == "VIT_QKV_BLOCK_ROWS":
            monkeypatch.setattr(vit_attention_mod, name, value)
            vit_attention_qkv(torch.zeros(1, 40, 3 * 8 * 72, dtype=torch.bfloat16,
                                          device=dev), 8, 72)
        elif name.startswith("VIT"):
            monkeypatch.setattr(vit_attention_mod, name, value)
            vit_attention(zeros(8, 88), zeros(8, 88), zeros(8, 88))
        else:
            monkeypatch.setattr(block_attention_mod, name, value)
            block_attn_lse(zeros(8, 128), zeros(2, 128), zeros(2, 128))


def test_kernels_raise_on_what_they_do_not_take():
    dev = require_cuda()
    q = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16, device=dev)  # head dim 64
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    with pytest.raises(ValueError):
        vit_attention_qkv(torch.zeros(1, 8, 3 * 4 * 40, device=dev), 4, 40)  # f32
    x = torch.zeros(1, 8, 2, 88, dtype=torch.bfloat16, device=dev)
    for bad in (x.float(), x.cpu(), torch.zeros(1, 8, 2, 96, dtype=torch.bfloat16,
                                                device=dev)[..., 8:],  # head offset 96
                torch.zeros(1, 8, 2 * 88 + 4, dtype=torch.bfloat16,
                            device=dev)[..., 4:].view(1, 8, 2, 88)):  # misaligned base
        with pytest.raises(ValueError):
            vit_attention(x, x, bad)
    with pytest.raises(ValueError):
        vit_attention(q, q, q)  # head dim 64
    with pytest.raises(ValueError):
        block_attn_lse(q, q, q)  # head dim 64
    q = torch.zeros(1, 8, 4, 128, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        block_attn_lse(q, q[:, :4], q[:, :4], causal=True)  # causal takes Lq == Lk
    with pytest.raises(ValueError):
        block_attn_lse(q, q[:, :, :2], q[:, :, :2].contiguous())  # k and v strides differ
    # K1 and K4 take chunks of 64 to 1,024 rows, multiples of 64
    args, D, dtb, _, seq, dy, _ = _ssd_case(5, 1, 512, 8, 2, None, 512, dev)
    _, _, states = ssd_scan_fwd(*args.values(), 512, D, dtb, (0.0, float("inf")), seq, None,
                                keep_states=True)
    for cs in (96, 1088):
        with pytest.raises(ValueError, match="chunk size"):
            ssd_scan_bwd(*args.values(), D, dtb, seq, states, dy, None, cs)
        with pytest.raises(ValueError, match="chunk size"):
            ssd_scan(*args.values(), chunk_size=cs)


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


@pytest.mark.parametrize("L,packed,init,H,G,cs", [
    (300, None, True, 16, 4, 64), (300, (37, 170), False, 16, 4, 64),
    (256, (64, 128), False, 16, 4, 64),
    (600, (37, 450), False, 32, 2, 256),  # the 9B's 16 heads a group and chunks of 256
    (300, (13, 140), False, 4, 4, 64),    # H == G: one head a group
    (512, (64, 128), False, 16, 4, 256),  # whole tile pairs masked by the segments
    (300, (37, 170), True, 16, 4, 128),   # chunks of two tiles
    (700, (37, 450), False, 16, 4, 512),  # chunks of 512, run as chunks of 256
    (1100, None, True, 16, 4, 1024),      # chunks of 1,024
])
def test_ssd_backward_kernel_matches_plain(L, packed, init, H, G, cs):
    """K4 through SSDScanFn: a ragged tail (L = 300, chunks of 64 or 128; L
    600, chunks of 256), a -1 pad with a boundary inside chunks or both on chunk
    and tile edges (leaving tile pairs with no pair of one segment), a
    final-state cotangent, an initial state, one head a group and the 9B's
    16 (their heads split over slices), chunks of 512 and 1,024 (which both
    kernels run as chunks of 256); bitwise repeatable."""
    dev = require_cuda()
    B = 2
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
    _, _, states = ssd_scan_fwd(*args.values(), 64, D, dtb, (0.0, float("inf")), seq, None,
                                keep_states=True)
    before = ssd_scan_bwd.launches
    ssd_scan_bwd(*args.values(), D, dtb, seq, states, dy, None, 64)
    assert ssd_scan_bwd.launches == before + 1


@pytest.mark.parametrize("L,packed,Hq,Hkv", [(200, (13, 100), 8, 2), (256, (64, 128), 8, 2),
                                             (64, None, 4, 4), (1, None, 8, 2),
                                             (63, (5, 40), 8, 2), (300, (13, 140), 8, 2),
                                             (203, "rows", 8, 2), (1000, None, 32, 8),
                                             (300, (13, 140), 4, 4)])
def test_flash_backward_kernel_matches_plain(L, packed, Hq, Hkv):
    """K2-bwd through FlashAttnFn: ragged tiles (L 1, 63, 203, 300, 1,000:
    no multiple of the 64- and 128-row tiles, nor of 4) or tile-edge
    boundaries, a -1 pad and a boundary, B 3 with a pad of its own per row,
    GQA 4:1 (32:8) and Hq == Hkv; bitwise repeatable."""
    dev = require_cuda()
    r = rng(6)
    B, D = (3 if packed == "rows" else 2), 128
    q, k, v = (t(r.standard_normal((B, L, h, D), np.float32)).to(dev, torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
    g = t(r.standard_normal((B, L, Hq, D), np.float32)).to(dev, torch.bfloat16)
    seg = None
    if packed == "rows":
        seg = t(row_pads(B, L, (0, 17, 130))).to(dev)
    elif packed:
        seg = t(packed_seq(B, L, *packed)).to(dev)

    def kernel_grads():
        leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
        out = flash_attention(*leaves, segment_ids=seg)
        return torch.autograd.grad(out, leaves, g)

    before = flash_attention_bwd.launches
    got = kernel_grads()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(q, k, v, g, seg)
    for name, a, b in zip("qkv", got, want):
        if L == 1 and name != "v":
            # the plain dq and dk are exactly 0 here (one key: dP = D); the
            # kernel's two f32 sums of dO . v, in other orders, cancel to ~1e-6
            assert torch.isfinite(a).all()
            assert (a.float() - b.float()).abs().max().item() <= 1e-4
        else:
            _close(a, b, BWD_TOL, floor=0.0)
    assert all(torch.equal(a, b) for a, b in zip(got, kernel_grads()))


@pytest.mark.parametrize("Hq,Hkv", QWEN2_GQA)
@pytest.mark.parametrize("L,packed", [(300, None), (300, (13, 140)), (4096, None),
                                      (4096, (1000, 2500))])
def test_flash_backward_kernel_at_the_qwen2_gqa_groups(Hq, Hkv, L, packed):
    """K2-bwd at query-head packs of 1, 8 and 2 (the dQ kernel's (64, pack,
    64 / pack) boxes; the dK/dV kernel's walk over the group's 7, 8 or 6
    query heads), segmented and not, at L 300 (B 2) and 4,096 (B 1), against
    autograd through the plain version to BWD_TOL; one launch; bitwise
    repeatable."""
    dev = require_cuda()
    r = rng(23)
    B, D = (1 if L == 4096 else 2), 128
    q, k, v = (t(r.standard_normal((B, L, h, D), np.float32)).to(dev, torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
    g = t(r.standard_normal((B, L, Hq, D), np.float32)).to(dev, torch.bfloat16)
    seg = t(packed_seq(B, L, *packed)).to(dev) if packed else None

    def kernel_grads():
        leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
        return torch.autograd.grad(flash_attention(*leaves, segment_ids=seg), leaves, g)

    before = flash_attention_bwd.launches
    got = kernel_grads()
    assert flash_attention_bwd.launches == before + 1
    for a, b in zip(got, flash_attention_bwd_plain(q, k, v, g, seg)):
        _close(a, b, BWD_TOL, floor=0.0)
    assert all(torch.equal(a, b) for a, b in zip(got, kernel_grads()))


def test_flash_backward_kernel_as_a_fresh_threads_first_cuda_work():
    """PyTorch runs a backward in a thread of its own. K2-bwd as that
    thread's first CUDA work (no segment ids, so no PyTorch kernel runs
    before it there) once had no current context, and
    cuTensorMapEncodeTiled refused its tensor maps (CUDA error 1); the entry
    point now makes the tensors' device current. Run in a new thread, and
    through autograd."""
    dev = require_cuda()
    r = rng(26)
    q, k, v = (t(r.standard_normal((1, 300, h, 128), np.float32)).to(dev, torch.bfloat16)
               for h in (28, 4, 4))
    g = t(r.standard_normal((1, 300, 28, 128), np.float32)).to(dev, torch.bfloat16)
    out, lse = flash_attention_fwd(q, k, v, None, with_lse=True)
    torch.cuda.synchronize()
    res = {}

    def run():
        try:
            res["grads"] = flash_attention_bwd(q, k, v, out, g, lse)
        except Exception as e:  # noqa: BLE001 (re-raised below)
            res["error"] = e

    th = threading.Thread(target=run)
    th.start()
    th.join()
    if "error" in res:
        raise res["error"]
    want = flash_attention_bwd_plain(q, k, v, g)
    for a, b in zip(res["grads"], want):
        _close(a, b, BWD_TOL, floor=0.0)
    leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
    for a, b in zip(torch.autograd.grad(flash_attention(*leaves), leaves, g), want):
        _close(a, b, BWD_TOL, floor=0.0)


# K2-bwd's non-causal mode: (Lq, Lk, B) at the 9B's and qwen2's query-head
# packs. TransV's calls: 32 text rows over the 205 tokens a 64-frame stage
# drops and the 820 / 819 of a 256-frame one; one row over one key; ragged
# tiles on both sides (65 x 129); several tiles on both sides (1,000 x 820);
# and a whole 4,096 x 4,096 layer
CROSS_BWD_SHAPES = [(1, 1, 2), (32, 205, 2), (32, 820, 1), (32, 820, 2), (32, 819, 2),
                    (65, 129, 2), (1000, 820, 2), (4096, 4096, 1)]


def _bf16(r, dev, *shape):
    return t(r.standard_normal(shape, np.float32)).to(dev, torch.bfloat16)


@pytest.mark.parametrize("Hq,Hkv", [(32, 8), (28, 4), (16, 2), (12, 2)])
@pytest.mark.parametrize("Lq,Lk,B", CROSS_BWD_SHAPES)
def test_cross_attention_gradients_run_the_noncausal_backward_kernel(Lq, Lk, B, Hq, Hkv):
    """The gradients of q, k and v through ops/attention.py:cross_attention
    under autograd on the card (BlockAttnFn: K9 forward, K2-bwd's non-causal
    mode backward, one launch each) against autograd through the plain
    `attention` and against the backward's plain version given the same
    forward output, each to BWD_TOL of its largest magnitude; the output is K9's
    own, and a repeat gives the same bits. K9's row log-sum-exp m + log(l)
    (row_lse), which the backward takes, against the plain one of the same
    scaled logits to 1e-4."""
    dev = require_cuda()
    r = rng(31)
    q, k, v = _bf16(r, dev, B, Lq, Hq, 128), _bf16(r, dev, B, Lk, Hkv, 128), \
        _bf16(r, dev, B, Lk, Hkv, 128)
    g = _bf16(r, dev, B, Lq, Hq, 128)

    def kernel_run():
        leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
        out = cross_attention(*leaves)
        assert out.grad_fn is not None
        return (out.detach(),) + torch.autograd.grad(out, leaves, g)

    fwd, bwd = block_attn_lse.launches, cross_attention_bwd.launches
    got = kernel_run()
    assert (block_attn_lse.launches, cross_attention_bwd.launches) == (fwd + 1, bwd + 1)
    assert torch.equal(got[0], block_attn_lse(q, k, v)[0])
    leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
    autograd_plain = torch.autograd.grad(attention(*leaves), leaves, g)
    for want in (autograd_plain, cross_attention_bwd_plain(q, k, v, got[0], g)):
        for name, a, b in zip("qkv", got[1:], want):
            if Lk == 1 and name != "v":
                # one key: dq and dk are 0 in exact arithmetic (dP = delta);
                # the f32 sums of dO . v on each side, in other orders,
                # cancel to ~1e-6
                assert torch.isfinite(a).all()
                assert (a.float() - b.float()).abs().max().item() <= 1e-4
            else:
                _close(a, b, BWD_TOL, floor=0.0)
    assert all(torch.equal(a, b) for a, b in zip(got, kernel_run()))
    _, l, m = block_attn_lse(q, k, v)
    lse = flash_lse_plain(q, k, causal=False)
    _close(row_lse(l, m), lse, 1e-4, floor=0.0)


@pytest.mark.parametrize("Lq,Lk", [(0, 205), (32, 0), (0, 0)])
def test_cross_attention_backward_of_an_empty_side_is_zero(Lq, Lk):
    """An empty side launches no backward kernel and gives zeros: no keys
    (Lk 0: K9 gives o = 0, l = 0, so the row log-sum-exp is +inf) or no
    queries."""
    dev = require_cuda()
    r = rng(32)
    q, k, v = _bf16(r, dev, 1, Lq, 32, 128), _bf16(r, dev, 1, Lk, 8, 128), \
        _bf16(r, dev, 1, Lk, 8, 128)
    g = _bf16(r, dev, 1, Lq, 32, 128)
    leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
    before = cross_attention_bwd.launches
    out = cross_attention(*leaves)
    got = torch.autograd.grad(out, leaves, g)
    assert cross_attention_bwd.launches == before
    assert (out == 0).all() and all((a == 0).all() for a in got)
    assert all(a.shape == b.shape for a, b in zip(got, (q, k, v)))


def test_cross_attention_backward_as_a_fresh_threads_first_cuda_work():
    """The non-causal mode through the entry point that
    test_flash_backward_kernel_as_a_fresh_threads_first_cuda_work repaired:
    as a new thread's first CUDA work, then through autograd (whose backward
    runs in a thread of its own)."""
    dev = require_cuda()
    r = rng(33)
    q, k, v = _bf16(r, dev, 1, 32, 32, 128), _bf16(r, dev, 1, 820, 8, 128), \
        _bf16(r, dev, 1, 820, 8, 128)
    g = _bf16(r, dev, 1, 32, 32, 128)
    o, l, m = block_attn_lse(q, k, v)
    lse = row_lse(l, m)
    torch.cuda.synchronize()
    res = {}

    def run():
        try:
            res["grads"] = cross_attention_bwd(q, k, v, o, g, lse)
        except Exception as e:  # noqa: BLE001 (re-raised below)
            res["error"] = e

    th = threading.Thread(target=run)
    th.start()
    th.join()
    if "error" in res:
        raise res["error"]
    want = cross_attention_bwd_plain(q, k, v, o, g)
    for a, b in zip(res["grads"], want):
        _close(a, b, BWD_TOL, floor=0.0)
    leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
    for a, b in zip(torch.autograd.grad(cross_attention(*leaves), leaves, g), want):
        _close(a, b, BWD_TOL, floor=0.0)


@pytest.mark.parametrize("Hq,Hkv", [(32, 8), (28, 4)])
@pytest.mark.parametrize("part", ["prefix", "own"])
def test_block_attention_kernel_at_the_verify_shapes(Hq, Hkv, part):
    """The speculative verify's two K9 blocks per attention layer (n_draft 7:
    8 rows): the 8 queries against an 8,448-row prefix [2, 8450) of a cache
    buffer, non-causal (split keys), and the 8 x 8 causal own block, at the
    9B's 32 / 8 and qwen2.5-7b's 28 / 4. Against the plain version to 1e-2;
    one launch; a repeat gives the same bits."""
    dev = require_cuda()
    r = rng(24)
    bf = lambda *s: t(r.standard_normal(s, np.float32)).to(dev, torch.bfloat16)  # noqa: E731
    q = bf(1, 8, Hq, 128)
    if part == "prefix":
        buf_k, buf_v = bf(1, 8466, Hkv, 128), bf(1, 8466, Hkv, 128)
        k, v, kw = buf_k[:, 2:8450], buf_v[:, 2:8450], {}
        assert block_attn_plan(1, 8, k.shape[1], Hq, Hkv)[1] > 1
    else:
        buf_k, buf_v = bf(1, 8466, Hkv, 128), bf(1, 8466, Hkv, 128)
        k, v, kw = buf_k[:, 8450:8458], buf_v[:, 8450:8458], dict(causal=True)
    before = block_attn_lse.launches
    got = block_attn_lse(q, k, v, **kw)
    assert block_attn_lse.launches == before + 1
    for a, b in zip(got, block_attn_lse_plain(q, k, v, **kw)):
        _close(a, b, 1e-2)
    assert all(torch.equal(a, b) for a, b in zip(got, block_attn_lse(q, k, v, **kw)))


@pytest.mark.parametrize("S", [8, 5])
def test_ssd_kernel_on_verify_rows_from_a_carried_state(S):
    """K1 on a verify's S rows (n_draft + 1, or a partial commit's a + 1)
    from a carried state at the 9B's widths, as the continuation runs it with
    chunk_size=S (models/prefix_cache.py:scan_chunk: one chunk at either size,
    run at the config's 256): against ssd_chunked at chunk S, JAX's override,
    and at 256, y and the final state to 1e-2."""
    dev = require_cuda()
    r = rng(25)
    H, G, P, N = 128, 8, 64, 128
    bf = lambda *s, k=1.0: t(r.standard_normal(s, np.float32) * k).to(dev, torch.bfloat16)  # noqa: E731
    x, dt, Bm, Cm = bf(1, S, H, P), bf(1, S, H, k=0.5), bf(1, S, G, N), bf(1, S, G, N)
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=dev)
    D, dtb = (t(r.standard_normal(H).astype(np.float32)).to(dev) for _ in range(2))
    h0 = t(r.standard_normal((1, H, P, N), np.float32)).to(dev)
    kw = dict(D=D, dt_bias=dtb, initial_state=h0)
    before = ssd_scan.launches
    y, st = ssd_scan(x, dt, A, Bm, Cm, chunk_size=256, **kw)
    assert ssd_scan.launches == before + 1
    for cs in (S, 256):
        yp, sp = ssd_chunked(x, dt, A, Bm, Cm, chunk_size=cs, **kw)
        _close(y, yp, 1e-2)
        _close(st, sp, 1e-2)


def _int8_close(got, want):
    diff = (got.int() - want.int()).abs()
    assert diff.max().item() <= 1
    assert (diff != 0).float().mean().item() <= 1e-3


@pytest.mark.parametrize("D", [1152, 128])
@pytest.mark.parametrize("residual,quant", [(False, False), (True, False), (False, True),
                                            (True, True)])
def test_layernorm_kernel_matches_plain(D, residual, quant):
    dev = require_cuda()
    r = rng(7)
    bf = lambda *s: t(r.standard_normal(s, np.float32)).to(dev, torch.bfloat16)  # noqa: E731
    x, res = bf(3, 61, D), bf(3, 61, D) if residual else None
    w = t(1 + 0.2 * r.standard_normal(D).astype(np.float32)).to(dev)
    b = t(0.1 * r.standard_normal(D).astype(np.float32)).to(dev)
    inv = torch.tensor(127.0 / 4.0, device=dev) if quant else None
    before = fused_ln.launches
    got = fused_ln(x, w, b, residual=res, act_inv=inv)
    assert fused_ln.launches == before + 1
    want = fused_ln_plain(x, w, b, residual=res, act_inv=inv)
    if residual:
        assert torch.equal(got[0], want[0])
        got, want = got[1], want[1]
    if quant:
        _int8_close(got, want)
    else:
        _close(got, want, 1e-2)


@pytest.mark.parametrize("B,G,H,P,N", [(2, 2, 16, 16, 128), (1, 8, 128, 64, 128),
                                       (3, 8, 128, 64, 128), (8, 8, 128, 64, 128),
                                       (1, 2, 16, 16, 256), (3, 1, 16, 64, 256)])
def test_decode_fused_kernel_matches_plain(B, G, H, P, N):
    """Groups of 128 channels (a cluster of 1 block) and 1,024 (the 9B's: a
    cluster of 8), batch 1, 3 and 8, N 128 and 256 (two column passes);
    bitwise repeatable."""
    dev = require_cuda()
    r = rng(8)
    K, di = 4, H * P
    bf = lambda *s, k=1.0: t(r.standard_normal(s, np.float32) * k).to(dev, torch.bfloat16)  # noqa: E731
    f32 = lambda *s, k=1.0: t(r.standard_normal(s, np.float32) * k).to(dev)  # noqa: E731
    wide = bf(B, 2 * di + 64)  # xr and gate as column slices, as the fused in_proj gives them
    args = (wide[:, di:2 * di], bf(B, G * N), bf(B, G * N), f32(B, H, k=0.1).abs(),
            wide[:, :di], bf(B, di, K), f32(B, H, P, N, k=0.3), f32(di, K, k=0.3),
            f32(di, k=0.1), f32(H, k=0.5), f32(H), 1 + f32(di, k=0.1))
    kw = dict(n_groups=G, head_dim=P, eps=1e-5)
    before = fused_mamba_decode.launches
    got = fused_mamba_decode(*args, **kw)
    assert fused_mamba_decode.launches == before + 1
    want = fused_mamba_decode_plain(*args, **kw)
    _close(got[0], want[0], 1e-2)
    assert torch.equal(got[1], want[1])
    _close(got[2], want[2], 1e-5)
    again = fused_mamba_decode(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("packed", [None, (37, 170), (66, 128), (129, 195), "rows"])
def test_conv_scan_kernel_matches_plain(packed):
    """K5 on raw streams that are column slices of one in-projection output
    (strided rows), a ragged tail, a -1 pad and a boundary inside a chunk;
    boundaries 1-3 rows after a 64-row tile edge and on a chunk edge (the
    conv stage's halo across a tile, a chunk and a segment); B 2 with a
    different pad per row; bitwise repeatable."""
    dev = require_cuda()
    r = rng(9)
    B, L, H, P, G, N, cs = 1, 300, 16, 64, 4, 128, 128
    if packed == "rows":
        B = 2
    di, gn = H * P, G * N
    proj = t(r.standard_normal((B, L, 2 * di + 2 * gn + H), np.float32)).to(dev, torch.bfloat16)
    x = proj[..., di:2 * di].reshape(B, L, H, P)
    Bm = proj[..., 2 * di:2 * di + gn].reshape(B, L, G, N)
    Cm = proj[..., 2 * di + gn:2 * di + 2 * gn].reshape(B, L, G, N)
    dt = proj[..., 2 * di + 2 * gn:]
    f32 = lambda *s, k=1.0: t(r.standard_normal(s, np.float32) * k).to(dev)  # noqa: E731
    conv = {"wx": f32(di, 4, k=0.3), "bx": f32(di, k=0.1), "wB": f32(gn, 4, k=0.3),
            "bB": f32(gn, k=0.1), "wC": f32(gn, 4, k=0.3), "bC": None}
    A = -torch.exp(f32(H))
    if packed == "rows":
        seq = t(row_pads(B, L, [5, 70])).to(dev)
    else:
        seq = t(packed_seq(B, L, *packed)).to(dev) if packed else None
    kw = dict(chunk_size=cs, D=f32(H), dt_bias=f32(H, k=0.1), seq_idx=seq)
    before = ssd_conv_scan_fused.launches
    y, st = ssd_conv_scan_fused(x, dt, A, Bm, Cm, conv, **kw)
    assert ssd_conv_scan_fused.launches == before + 1
    yp, sp = ssd_conv_scan_fused_plain(x, dt, A, Bm, Cm, conv, **kw)
    _close(y, yp, 1e-2)
    _close(st, sp, 1e-2)
    y2, st2 = ssd_conv_scan_fused(x, dt, A, Bm, Cm, conv, **kw)
    assert torch.equal(y, y2) and torch.equal(st, st2)


@pytest.mark.parametrize("M", [1, 16, 33])
@pytest.mark.parametrize("K", [128, 588])
def test_int8_product_on_the_card_is_the_cpu_one(M, K):
    """torch._int_mm takes more than 16 rows and an inner dim that is a
    multiple of 8 on the card; fewer rows, and InternVideo2's 588-wide
    tubelet, are padded. The W8A8 apply gives the CPU's result bit for bit."""
    dev = require_cuda()
    r = rng(10)
    mod = Int8Linear(t(r.integers(-127, 128, (256, K)).astype(np.int8)),
                     t((r.random(256) * 0.01).astype(np.float32)), None,
                     torch.tensor(127.0 / 3.0))
    x = t(r.standard_normal((M, K), np.float32)).to(torch.bfloat16)
    want = apply_linear_w8a8(mod, x)
    got = apply_linear_w8a8(mod.to(dev), x.to(dev))
    assert torch.equal(got.cpu(), want)


def _hetero_seq(B, L, reals):
    """Segment ids of a heterogeneous batch (data/loader.py:collate_hetero):
    row b real for its first reals[b] rows (segment 0), then its pads in a
    fresh trailing segment 1."""
    seq = np.zeros((B, L), np.int32)
    for b, n_real in enumerate(reals):
        seq[b, n_real:] = 1
    return seq


@pytest.mark.parametrize("L,reals", [(1064, (1064, 555)), (300, (173, 300)), (4136, (2100, 4136))])
def test_backward_kernels_on_heterogeneous_rows(L, reals):
    """K4 and K2-bwd on two rows of a heterogeneous training batch, one of
    them padded to the other's length in a trailing segment (the SSD resets
    there, attention masks across it and K2-bwd skips its cross-segment
    tiles), against autograd through the plain versions; the pad rows'
    cotangents are zero, as the loss gives them."""
    dev = require_cuda()
    B, H, G, cs = 2, 16, 4, 256
    args, D, dtb, _, _, dy, _ = _ssd_case(11, B, L, H, G, None, cs, dev)
    seq = t(_hetero_seq(B, L, reals)).to(dev)
    pad = (seq == 1)[..., None, None]
    dy = dy.masked_fill(pad, 0)
    leaves = [v.detach().clone().requires_grad_() for v in (*args.values(), D, dtb)]
    before = ssd_scan_bwd.launches
    y, _ = ssd_scan(*leaves[:5], chunk_size=cs, D=leaves[5], dt_bias=leaves[6], seq_idx=seq)
    got = torch.autograd.grad(y, leaves, dy)
    assert ssd_scan_bwd.launches == before + 1
    want = ssd_scan_bwd_plain(*args.values(), D, dtb, seq, dy, None, cs)
    for g, w in zip(got, [w for w in want if w is not None]):
        _close(g, w, BWD_TOL, floor=0.0)

    r = rng(12)
    q, k, v = (t(r.standard_normal((B, L, h, 128), np.float32)).to(dev, torch.bfloat16)
               for h in (32, 8, 8))
    g = t(r.standard_normal((B, L, 32, 128), np.float32)).to(dev, torch.bfloat16)
    g = g.masked_fill(pad, 0)
    leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
    before = flash_attention_bwd.launches
    out = flash_attention(*leaves, segment_ids=seq)
    got = torch.autograd.grad(out, leaves, g)
    assert flash_attention_bwd.launches == before + 1
    for a, b in zip(got, flash_attention_bwd_plain(q, k, v, g, seq)):
        _close(a, b, BWD_TOL, floor=0.0)


def _kernel_backbone(dev):
    """A three-layer nano backbone (one Mamba, one attention, one MLP layer)
    at shapes the kernels take: P 64, N 128, head_dim 128."""
    from timeviper_tpu_torch.config import tiny_nano_config
    from timeviper_tpu_torch.models.nano import NanoModel

    cfg = tiny_nano_config(hidden_size=256, intermediate_size=512, num_hidden_layers=3,
                           hybrid_override_pattern="M*-", num_attention_heads=4, head_dim=128,
                           num_key_value_heads=2, ssm_state_size=128, mamba_num_heads=8,
                           mamba_n_groups=2, mamba_head_dim=64, chunk_size=64)
    model = NanoModel(cfg, torch.bfloat16, dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(0))
    return cfg, model


def test_scan_policy_keeps_the_mixers_launches():
    """Under remat "scan" (models/remat.py) the backward does not run K1 or K2
    again: one forward launch a Mamba or attention layer and step, where
    "full" and "dots" launch two; the gradients are "full"'s."""
    from timeviper_tpu_torch.models.nano import nano_forward

    dev = require_cuda()
    cfg, model = _kernel_backbone(dev)
    ids = t(rng(13).integers(0, cfg.vocab_size, (2, 300))).to(dev)
    seq = t(_hetero_seq(2, 300, (300, 211))).to(dev)
    grads, launches = {}, {}
    for policy in ("full", "scan", "dots", "dots_scan"):
        counts = (ssd_scan, flash_attention, ssd_scan_bwd, flash_attention_bwd)
        before = [c.launches for c in counts]
        out = nano_forward(model, cfg, input_ids=ids, seq_idx=seq, remat=policy)
        loss = out["logits"][:, :-1].float().logsumexp(-1).mean()
        grads[policy] = torch.autograd.grad(loss, list(model.parameters()))
        launches[policy] = [c.launches - b for c, b in zip(counts, before)]
    assert launches["full"] == launches["dots"] == [2, 2, 1, 1], launches
    assert launches["scan"] == launches["dots_scan"] == [1, 1, 1, 1], launches
    for policy in ("scan", "dots", "dots_scan"):
        for a, b in zip(grads[policy], grads["full"]):
            _close(a, b, 1e-2, floor=0.0)


def test_pinned_offload_steps_match_the_blocking_copies():
    """train/offload.py:StreamedTrainer's pinned, double-buffered transfers
    (weights staged through two buffer sets a block type, gradients pulled
    without blocking while the host's AdamW runs on the last layer's) give
    the steps of the same trainer with blocking copies from the masters. Eight
    layers, four of them Mamba and three MLP, so that each buffer set is
    reused within a step; three steps at lr 1e-3, where one layer updated from
    a stale or overwritten buffer moves its masters by about the learning
    rate. The kernels repeat their bits, so the losses and masters agree to
    1e-6."""
    from timeviper_tpu_torch.config import tiny_nano_config
    from timeviper_tpu_torch.models.nano import NanoModel
    from timeviper_tpu_torch.train.offload import StreamedTrainer, host_params

    dev = require_cuda()
    cfg = tiny_nano_config(hidden_size=512, intermediate_size=2048, num_hidden_layers=8,
                           hybrid_override_pattern="M-M-M*M-", num_attention_heads=4,
                           head_dim=128, num_key_value_heads=2, ssm_state_size=128,
                           mamba_num_heads=16, mamba_n_groups=2, mamba_head_dim=64,
                           chunk_size=64, vocab_size=2048)
    model = NanoModel(cfg, torch.float32, "cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    ids = rng(14).integers(3, cfg.vocab_size, (2, 513))
    runs = {}
    for pinned in (True, False):
        tr = StreamedTrainer(cfg, host_params(model), lr=1e-3, device=dev, pinned=pinned,
                             logits_chunk=256)
        before = ssd_scan_bwd.launches
        losses = [tr.train_step(ids, ids) for _ in range(3)]
        assert ssd_scan_bwd.launches - before == 3 * 4
        runs[pinned] = losses, tr.host
    (lp, hp), (lb, hb) = runs[True], runs[False]
    np.testing.assert_allclose(lp, lb, rtol=1e-6)
    moved = host_params(model)
    for k in hp:
        np.testing.assert_allclose(hp[k], hb[k], rtol=0, atol=1e-6, err_msg=k)
        assert not np.array_equal(hp[k], moved[k]), k


@pytest.mark.parametrize("lo,segs,valid", [(256, True, True), (256, False, False),
                                            (0, True, False), (512, False, True)])
def test_span_attention_runs_k9_forward_and_k2_bwd_backward(lo, segs, valid):
    """parallel/seq_parallel.py:SpanAttnFn, the sequence-parallel training
    path's attention: a span's queries (rows lo on) against the gathered
    keys, K9 forward, K2-bwd's causal mode over the span's own block and its
    non-causal mode over the keys left of it (a launch for each segment the
    span shares with them); its output and gradients against f32 autograd
    through dense attention."""
    from timeviper_tpu_torch.ops.block_attention import fold_segments
    from timeviper_tpu_torch.parallel.seq_parallel import SpanAttnFn

    dev = require_cuda()
    B, L, Lloc, Hq, Hkv, D = 2, 768, 256, 8, 2, 128
    r = rng(31)
    q, kg, vg = (t(r.standard_normal((B, n, h, D))).to(dev, torch.bfloat16)
                 for n, h in ((Lloc, Hq), (L, Hkv), (L, Hkv)))
    seq = (torch.tensor([[0] * 100 + [1] * 300 + [2] * 368, [0] * 300 + [1] * 468],
                        dtype=torch.int32, device=dev) if segs else None)
    kv_valid = None
    if valid:
        kv_valid = torch.arange(L, device=dev) >= 37
        kv_valid[lo + 5] = False
    seg = fold_segments(B, L, L, valid_kv=kv_valid, valid_q=kv_valid, seg_q=seq, seg_kv=seq,
                        device=dev)[0]
    dout = t(r.standard_normal((B, Lloc, Hq, D))).to(dev, torch.bfloat16)
    counts = (block_attn_lse, flash_attention_bwd, cross_attention_bwd)
    before = [f.launches for f in counts]
    leaves = [x.clone().requires_grad_() for x in (q, kg, vg)]
    out = SpanAttnFn.apply(*leaves, lo, seg)
    got = torch.autograd.grad(out, leaves, dout)
    launched = [f.launches - b for f, b in zip(counts, before)]
    assert launched[0] == (2 if lo else 1) and launched[1] == 1
    assert (launched[2] > 0) == bool(lo)
    ref_leaves = [x.float().clone().requires_grad_() for x in (q, kg, vg)]
    mask = (torch.arange(lo, lo + Lloc, device=dev)[:, None]
            >= torch.arange(L, device=dev)[None])[None]
    if seg is not None:
        mask = mask & (seg[:, lo:lo + Lloc, None] == seg[:, None, :])
    ref = attention(*ref_leaves, mask)
    want = torch.autograd.grad(ref, ref_leaves, dout.float())
    _close(out, ref, 2e-2)
    for g, w in zip(got, want):
        _close(g, w, BWD_TOL, floor=0.0)
