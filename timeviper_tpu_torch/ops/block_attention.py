"""K9: one KV block of attention that returns its row statistics, as a
hand-written CUDA kernel.

Counterpart of timeviper_tpu/parallel/seq_parallel.py:_block_attn_lse, which
on the TPU calls JAX's bundled Pallas flash kernel with its residuals saved
and elsewhere runs a dense form. It returns the normalised output o together
with the row sum l and row max m of the scaled logits, so that the results
of disjoint key blocks merge exactly (flash attention's invariant). The
continuation on a cached prefix (models/prefix_cache.py) calls it twice per
attention layer; ring attention (attention_seq_ring) will call it once per
rotating block.

Two modes: non-causal, any Lq and Lk (a rectangular block, Lk = 0 too), and
causal with Lq == Lk. GQA heads are read in place. `valid_kv` (Lk,) and
`valid_q` (Lq,) are folded into the segment ids as the TPU branch folds them
(seq_parallel.py:229-240): an invalid key row gets segment -1, and so does
an invalid query row when `valid_kv` is given, so that it pairs with the
invalid keys instead of being left with no key. `seg_q` (B, Lq) and `seg_kv`
(B, Lk) int32 restrict attention to equal segments. A row that sees no key
gives l = 0, m = -inf and o = 0, as the dense JAX branch does (the TPU
kernel gave NaN there).

`block_attn_lse` is the entry point: a CPU tensor takes the plain version,
`block_attn_lse_plain`; a CUDA tensor launches the kernel (csrc/block_attn.cu)
or raises.

`BlockAttnFn` makes the non-causal mode differentiable (TransV's
cross-attention, ops/attention.py:cross_attention, under autograd on the
card): its forward is K9, keeping o and the row log-sum-exp m + log(l); its
backward is K2-bwd's non-causal mode (ops/flash_attention.py:
cross_attention_bwd). Its plain version is autograd through
ops/attention.py:attention, which the CPU takes.

The kernel's launch plan is `block_attn_plan`, a function of the shapes
alone: how many query heads of one KV head a block packs, and whether the
keys are split across blocks in whole tiles when the blocks of a call would
not fill the card (a short question against a long prefix). Split partials
are merged in a fixed order; `merge_parts` is that merge's plain
counterpart, and the continuation (models/prefix_cache.py) merges its prefix
and suffix parts with it.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from timeviper_tpu_torch.ops import _cuda

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# The kernel's tile, which the plan counts in; tv_block_attn refuses a launch
# whose tile is not its own (csrc/block_attn.cu: kBKV, two consumer
# warpgroups of 64 rows)
ATTN_BKV = 128  # keys a tile
BLOCK_ROWS = 128  # (row, head) pairs a block
SPLIT_TARGET_BLOCKS = 256  # a fixed target, about two blocks per SM of an H100
MIN_SPLIT_TILES = 4  # a split walks at least this many key tiles


def gqa_pack(Hq: int, Hkv: int) -> int:
    """Query heads of one KV head that a block of csrc/attn_sm90.cuh serves:
    the largest power of two that divides Hq / Hkv and 64."""
    rep = Hq // Hkv
    pack = 1
    while pack < 64 and rep % (2 * pack) == 0:
        pack *= 2
    return pack


def pad_key_ids(seg_kv: torch.Tensor) -> torch.Tensor:
    """Key segment ids (B, Lk) int32 as the kernels' TMA reads them: each row
    padded with zeros to a multiple of 4 ids, from a 16-byte aligned base (a
    box starts its row on a 16-byte boundary; the pad lies past Lk and is
    masked by position)."""
    pad = -seg_kv.shape[1] % 4
    if pad or seg_kv.data_ptr() % 16:
        seg_kv = torch.cat([seg_kv, seg_kv.new_zeros(seg_kv.shape[0], pad)], dim=1)
    return seg_kv


def block_attn_plan(B: int, Lq: int, Lk: int, Hq: int, Hkv: int,
                    causal: bool = False) -> Tuple[int, int, int]:
    """(pack, n_split, split_tiles) of a K9 launch, from the shapes alone.

    pack: `gqa_pack` (a warpgroup's 64 rows hold 64 / pack rows of pack
    heads). n_split: how many blocks share the keys of
    one set of query rows, each walking split_tiles tiles of ATTN_BKV keys
    (the last split may walk fewer, none walks none): more than 1 only when a
    non-causal call would launch fewer than SPLIT_TARGET_BLOCKS blocks and has
    at least 2 * MIN_SPLIT_TILES key tiles."""
    pack = gqa_pack(Hq, Hkv)
    tiles = -(-Lk // ATTN_BKV)
    blocks = -(-Lq * pack // BLOCK_ROWS) * (Hq // pack) * B
    n_split = 1
    if not causal and blocks:
        n_split = min(-(-SPLIT_TARGET_BLOCKS // blocks), tiles // MIN_SPLIT_TILES)
    if n_split <= 1:
        return pack, 1, max(tiles, 1)
    split_tiles = -(-tiles // n_split)
    return pack, -(-tiles // split_tiles), split_tiles


def merge_parts(parts) -> Result:
    """Merge (o (B, Lq, Hq, D), l, m (B, Hq, Lq)) results over disjoint key
    sets, in list order: a part whose row saw no key (l = 0) gets weight 0,
    so an empty or fully masked part leaves the others alone. Returns (o in
    the first part's dtype, l, m) relative to the merged row max; the plain
    counterpart of csrc/block_attn.cu:attn_merge_kernel."""
    m = torch.stack([p[2] for p in parts]).amax(dim=0)
    weights = [torch.where(l_s > 0, l_s * torch.exp(m_s - m), 0.0) for _, l_s, m_s in parts]
    total = torch.stack(weights).sum(dim=0)
    denom = torch.clamp(total, min=1e-30)
    o = 0.0
    for (o_s, _, _), a in zip(parts, weights):
        w = (a / denom).transpose(1, 2)[..., None]
        o = o + torch.where(w > 0, o_s.float() * w, 0.0)
    return o.to(parts[0][0].dtype), total, m


def fold_segments(B: int, Lq: int, Lk: int, valid_kv=None, valid_q=None, seg_q=None,
                  seg_kv=None, device=None):
    """(seg_q (B, Lq), seg_kv (B, Lk)) int32 with the valid masks folded in,
    or (None, None) when nothing restricts attention."""
    if valid_kv is None and seg_q is None:
        return None, None
    if (seg_q is None) != (seg_kv is None):
        raise ValueError("block attention: seg_q and seg_kv come together")
    zeros = lambda n: torch.zeros(B, n, dtype=torch.int32, device=device)  # noqa: E731
    sq = zeros(Lq) if seg_q is None else seg_q.to(torch.int32).expand(B, Lq)
    sk = zeros(Lk) if seg_kv is None else seg_kv.to(torch.int32).expand(B, Lk)
    if valid_kv is not None:  # (Lk,) shared by the rows, or (B, Lk)
        sk = torch.where(valid_kv if valid_kv.dim() == 2 else valid_kv[None], sk, -1)
        if valid_q is not None:
            sq = torch.where(valid_q[None], sq, -1)
    return sq.contiguous(), sk.contiguous()


def block_attn_lse_plain(q, k, v, *, causal: bool = False, valid_kv=None, valid_q=None,
                         seg_q=None, seg_kv=None) -> Result:
    """The dense form: f32 logits, probabilities rounded to v's dtype for the
    P V product (as the JAX dense branch feeds them), f32 sums."""
    B, Lq, Hq, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    sq, sk = fold_segments(B, Lq, Lk, valid_kv, valid_q, seg_q, seg_kv, q.device)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", q.reshape(B, Lq, Hkv, rep, D).float(),
                          k.float()) * (1.0 / math.sqrt(D))
    mask = None
    if causal:
        mask = torch.ones(Lq, Lk, dtype=torch.bool, device=q.device).tril()[None]
    if sq is not None:
        same = sq[:, :, None] == sk[:, None, :]
        mask = same if mask is None else mask & same
    if mask is not None:
        logits.masked_fill_(~mask[:, None, None], -math.inf)
    m = logits.amax(dim=-1) if Lk else logits.new_full(logits.shape[:-1], -math.inf)
    dead = torch.isneginf(m)
    p = logits.sub_(torch.where(dead, 0.0, m)[..., None]).exp_()
    l = p.sum(dim=-1)
    o = torch.einsum("bhrqk,bkhd->bqhrd", p.to(v.dtype).float(), v.float())
    del p, logits
    o = o / torch.where(l == 0, 1.0, l).permute(0, 3, 1, 2)[..., None]
    return (o.reshape(B, Lq, Hq, D).to(q.dtype), l.reshape(B, Hq, Lq),
            m.reshape(B, Hq, Lq))


def block_attn_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False,
                   valid_kv=None, valid_q=None, seg_q=None, seg_kv=None) -> Result:
    """q (B, Lq, Hq, D); k, v (B, Lk, Hkv, D) -> (o (B, Lq, Hq, D) in q.dtype,
    l (B, Hq, Lq) f32, m (B, Hq, Lq) f32) of the logits scaled by
    1/sqrt(D). The plain version for a CPU tensor, the kernel for a CUDA one."""
    if q.device.type == "cpu":
        return block_attn_lse_plain(q, k, v, causal=causal, valid_kv=valid_kv, valid_q=valid_q,
                                    seg_q=seg_q, seg_kv=seg_kv)
    B, Lq, Hq, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    _check(q, k, v, causal)
    sq, sk = fold_segments(B, Lq, Lk, valid_kv, valid_q, seg_q, seg_kv, q.device)
    if sk is not None:
        sk = pad_key_ids(sk)
    o = torch.empty_like(q)
    l = torch.empty(B, Hq, Lq, dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    if Lq == 0:
        return o, l, m
    pack, n_split, split_tiles = block_attn_plan(B, Lq, Lk, Hq, Hkv, causal)
    o_part = l_part = m_part = None
    if n_split > 1:  # scratch for the splits' partial results
        o_part = torch.empty(n_split, B, Lq, Hq, D, dtype=torch.float32, device=q.device)
        l_part = torch.empty(n_split, B, Hq, Lq, dtype=torch.float32, device=q.device)
        m_part = torch.empty_like(l_part)
    p = _cuda.ptr
    err = _cuda.lib().tv_block_attn(
        p(q), p(k), p(v), p(sq), p(sk), p(o), p(l), p(m), p(o_part), p(l_part), p(m_part),
        B, Lq, Lk, Hq, Hkv, D, k.stride(0), int(causal), ATTN_BKV, BLOCK_ROWS, pack, n_split,
        split_tiles, 1.0 / math.sqrt(D), _cuda.stream_of(q))
    _cuda.check(err, "tv_block_attn")
    block_attn_lse.launches += 1
    return o, l, m


block_attn_lse.launches = 0


def row_lse(l: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The row log-sum-exp m + log(l) (B, Hq, Lq) f32 of K9's row statistics,
    as K2-bwd takes it: +inf for a row that saw no key (l = 0), so that its
    probabilities, and with them its gradients, are 0."""
    return torch.where(l > 0, m + torch.log(l), math.inf)


class BlockAttnFn(torch.autograd.Function):
    """Non-causal GQA attention of q (B, Lq, Hq, D) over k, v (B, Lk, Hkv, D)
    on CUDA tensors: K9 forward, K2-bwd's non-causal mode backward. With a
    key mask `kv_valid` (B, Lk) the backward runs each row on its kept keys
    (K2-bwd's non-causal mode takes no mask; a masked key's probability is 0,
    so its gradients are 0 and the kept keys' are those of the compacted
    row)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid=None):
        o, l, m = block_attn_lse(q, k, v, causal=False, valid_kv=kv_valid)
        ctx.save_for_backward(q, k, v, o, row_lse(l, m), kv_valid)
        return o

    @staticmethod
    def backward(ctx, dout):
        from timeviper_tpu_torch.ops.flash_attention import cross_attention_bwd

        q, k, v, o, lse, kv_valid = ctx.saved_tensors
        if kv_valid is None:
            return (*cross_attention_bwd(q, k, v, o, dout, lse), None)
        dq, dk, dv = torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
        for b in range(q.shape[0]):
            keep = kv_valid[b].nonzero()[:, 0]
            r = slice(b, b + 1)
            dq[r], dk[r, keep], dv[r, keep] = cross_attention_bwd(
                q[r], k[r, keep], v[r, keep], o[r], dout[r], lse[r])
        return dq, dk, dv, None


def _check(q, k, v, causal):
    """bf16 on one card, head dim 128, q contiguous; k and v row ranges of
    same-shaped buffers: contiguous rows of Hkv heads, one batch stride of
    whole 16-byte vectors, 16-byte aligned bases."""
    B, Lq, Hq, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not (x.device == dev and x.dtype == torch.bfloat16 and x.data_ptr() % 16 == 0):
            raise ValueError(f"block_attn_lse kernel: {name} must be 16-byte aligned bf16 on {dev}")
    if not q.is_contiguous():
        raise ValueError("block_attn_lse kernel: q must be contiguous")
    if k.shape != (B, Lk, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"block_attn_lse kernel: k/v shapes {tuple(k.shape)}, {tuple(v.shape)}")
    rows = (Hkv * D, D, 1)  # an empty block (Lk = 0) is never read
    if Lk and (k.stride()[1:] != rows or v.stride() != k.stride() or k.stride(0) % 8):
        raise ValueError(f"block_attn_lse kernel: k and v need contiguous rows and one batch "
                         f"stride of whole 8-element vectors (strides {k.stride()}, "
                         f"{v.stride()})")
    if D != 128 or Hq % Hkv:
        raise ValueError(f"block_attn_lse kernel: takes head dim 128 and Hq % Hkv == 0, "
                         f"got D={D}, Hq={Hq}, Hkv={Hkv}")
    if causal and Lq != Lk:
        raise ValueError(f"block_attn_lse kernel: the causal mode takes Lq == Lk, got {Lq}, {Lk}")
