"""pdrop and TransV: visual tokens dropped between layers, and what was
dropped moved into the text by a gated cross-attention (counterpart of
timeviper_tpu/models/pdrop.py).

A stage (config.py:PdropStage) runs before its layer and keeps
`min(int(original visual tokens * ratio), current)` of a sample's visual
tokens: "uni" keeps evenly spaced ones, "attn" the ones the sample's last
prompt token attends to most (mean over heads, with that attention layer's
q/k projections on the raw hidden state). With a TransV merge module for the
stage, the text after the visual block then cross-attends the dropped tokens
(ops/attention.py:cross_attention, K9 on the card) and adds the result gated
by tanh(alpha). The prefill keeps the dropped tokens' cross-attention K/V
(`ca_kv`) so that each later token is merged the same way
(`merge_dropped_cached`).

The JAX package has two branches of a stage: a static one over packed
samples and a traced one for the bucketed prefill, whose layout arrives as
device scalars. Here layouts are host integers and one path serves both:
the same keep counts, the same keep indices, one gather of the kept rows.
Where the port leaves the JAX code behind, and why:

* The merge cross-attends the text suffix rows only; the traced branch
  computes every row and keeps the suffix. The merge is per row, so the
  result is the same.
* "uni" indices: `jnp.linspace` in float32 cast to int32 as XLA compiles
  it, written out in numpy on the host (`uni_keep_indices`). torch.linspace,
  IEEE float32 division and float64 give other indices.
* "attn" ties (identical frames): jax.lax.top_k keeps the lower index; a
  stable descending sort does the same (torch.topk promises no order).
* Copied as they are: the ranking projects the hidden state without its
  RMSNorm, its softmax runs over every row up to the query (left pads
  included), and alpha is cast to the hidden dtype before tanh.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from timeviper_tpu_torch.config import NanoConfig, PdropStage
from timeviper_tpu_torch.ops.attention import cross_attention


@dataclass(frozen=True)
class PdropSampleSpec:
    """Layout of one (possibly packed) sample at the current stage."""

    vision_start: int  # rows before the visual block (a left pad included)
    num_vision: int  # visual tokens at the current stage
    text_suffix: int  # rows after the visual block
    # the "attn" ranking query: the sample's last prompt row (inference);
    # None takes it from the labels (training)
    query_pos: Optional[int] = None

    @property
    def length(self) -> int:
        return self.vision_start + self.num_vision + self.text_suffix


@dataclass(frozen=True)
class PdropSpec:
    samples: Tuple[PdropSampleSpec, ...]
    orig_num_vision: Tuple[int, ...]  # keep counts derive from these
    ratios: Tuple[float, ...]  # (1.0, r1, r2, ...)


def make_pdrop_spec(samples: List[Tuple[int, int, int]], stages: Tuple[PdropStage, ...],
                    query_positions: Optional[List[Optional[int]]] = None) -> PdropSpec:
    """samples: (vision_start, num_vision, text_suffix) each; the
    Generator's one sample spans its bucketed row, the left pad in
    vision_start, with its last prompt row as the query position."""
    qp = query_positions or [None] * len(samples)
    return PdropSpec(
        samples=tuple(PdropSampleSpec(vs, nv, ts, q) for (vs, nv, ts), q in zip(samples, qp)),
        orig_num_vision=tuple(nv for _, nv, _ in samples),
        ratios=(1.0,) + tuple(s.ratio for s in stages))


def pdrop_drop_counts(cfg: NanoConfig, num_visual: int) -> List[int]:
    """Tokens each stage drops from `num_visual` original visual tokens (the
    serving engine sizes its ca_kv buffers with these)."""
    cur, drops = num_visual, []
    for st in cfg.pdrop_stages:
        keep = min(int(num_visual * st.ratio), cur)
        drops.append(cur - keep)
        cur = keep
    return drops


# ---------------------------------------------------------------------------
# TransV merge modules
# ---------------------------------------------------------------------------


class CrossAttn(nn.Module):
    def __init__(self, cfg: NanoConfig, dtype, device):
        super().__init__()
        d, hd = cfg.hidden_size, cfg.head_dim
        kw = dict(bias=cfg.attention_bias, dtype=dtype, device=device)
        self.q_proj = nn.Linear(d, cfg.num_attention_heads * hd, **kw)
        self.k_proj = nn.Linear(d, cfg.num_key_value_heads * hd, **kw)
        self.v_proj = nn.Linear(d, cfg.num_key_value_heads * hd, **kw)
        self.o_proj = nn.Linear(cfg.num_attention_heads * hd, d, **kw)


class MergeModule(nn.Module):
    """One stage's TransV: a cross-attention and its f32 gate `alpha`."""

    def __init__(self, cfg: NanoConfig, dtype, device):
        super().__init__()
        self.cross_attn = CrossAttn(cfg, dtype, device)
        self.alpha = nn.Parameter(torch.zeros((), dtype=torch.float32, device=device))


class MergeModules(nn.ModuleDict):
    """The merge modules keyed by stage index, as the JAX list
    `params["merge_modules"]` is indexed; a stage without one has no key."""

    def __init__(self, cfg: NanoConfig, dtype, device):
        super().__init__({str(i): MergeModule(cfg, dtype, device)
                          for i, st in enumerate(cfg.pdrop_stages)
                          if "drop" not in st.compress_type})

    def stage(self, i: int) -> Optional[MergeModule]:
        return self[str(i)] if str(i) in self else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Kernels N(0, 0.02), biases 0, alpha 0 (pdrop.py:392): TransV starts
        as a no-op."""
        for mm in self.values():
            for lin in mm.cross_attn.children():
                lin.weight.normal_(0.0, 0.02, generator=generator)
                if lin.bias is not None:
                    lin.bias.zero_()
            mm.alpha.zero_()


def init_merge_modules(cfg: NanoConfig, dtype=torch.bfloat16, device=None
                       ) -> Optional[MergeModules]:
    """The TransV modules of a "CrossAttention" config, else None."""
    if cfg.merge_module != "CrossAttention" or not cfg.pdrop_stages:
        return None
    return MergeModules(cfg, dtype, device)


def _gated_merge(hidden: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mm: MergeModule,
                 cfg: NanoConfig) -> torch.Tensor:
    """hidden (B, S, D) cross-attends k, v (B, Nd, Hkv, hd); + tanh(alpha) x
    out, alpha cast to the hidden dtype first."""
    B, S, _ = hidden.shape
    Hq, hd = cfg.num_attention_heads, cfg.head_dim
    ca = mm.cross_attn
    q = ca.q_proj(hidden).reshape(B, S, Hq, hd)
    out = ca.o_proj(cross_attention(q, k, v).reshape(B, S, Hq * hd))
    return hidden + torch.tanh(mm.alpha.to(hidden.dtype)) * out


def _ca_kv(dropped: torch.Tensor, mm: MergeModule, cfg: NanoConfig) -> Dict[str, torch.Tensor]:
    """The dropped tokens' cross-attention K/V (Nd, Hkv, hd), projected once."""
    Nd, Hkv, hd = dropped.shape[0], cfg.num_key_value_heads, cfg.head_dim
    ca = mm.cross_attn
    return {"k": ca.k_proj(dropped).reshape(Nd, Hkv, hd),
            "v": ca.v_proj(dropped).reshape(Nd, Hkv, hd)}


def merge_dropped_cached(hidden: torch.Tensor, ca_kv: Dict[str, torch.Tensor],
                         mm: MergeModule, cfg: NanoConfig) -> torch.Tensor:
    """TransV after the prefill: new rows (B, S, D) cross-attend the cached
    dropped-token K/V, (Nd, Hkv, hd) shared by every row or (B, Nd, Hkv, hd)
    one per row (the serving engine's slots). A shared K/V is copied per row
    for B > 1: K9 reads whole batch strides."""
    k = ca_kv["k"].to(hidden.dtype)
    v = ca_kv["v"].to(hidden.dtype)
    if k.dim() == 3:
        B = hidden.shape[0]
        k, v = k[None], v[None]
        if B > 1:
            k, v = k.expand(B, -1, -1, -1).contiguous(), v.expand(B, -1, -1, -1).contiguous()
    return _gated_merge(hidden, k, v, mm, cfg)


# ---------------------------------------------------------------------------
# Ranking and the stage
# ---------------------------------------------------------------------------


def uni_keep_indices(cur: int, keep: int) -> np.ndarray:
    """jnp.linspace(0, cur - 1, keep) cast to int32, as XLA computes it for
    the JAX package: linspace's 0 x (1 - s) + (cur - 1) x s with s = i /
    (keep - 1) (jax/_src/numpy/array_creation.py:_linspace) reaches the
    compiler with constant ends, which turns the division into a product
    with the rounded reciprocal and folds the two constants, so each value
    is i x f32(f32(cur - 1) x f32(1 / (keep - 1))) in float32; the last is
    cur - 1; truncated. IEEE division (numpy, torch.linspace) gives other
    indices from about 4k visual tokens on."""
    if keep <= 1:
        return np.zeros((keep,), np.int32)
    div = keep - 1
    scale = np.float32(cur - 1) * (np.float32(1) / np.float32(div))
    out = np.concatenate([np.arange(div, dtype=np.float32) * scale, np.float32([cur - 1])])
    return out.astype(np.int32)


def _rank_scores_attn(h: torch.Tensor, attn_mixer, cfg: NanoConfig, query_pos: int,
                      vision_start: int, num_vision: int) -> torch.Tensor:
    """Mean over heads of the query row's attention to each visual token, f32
    (num_vision,). h (Ls, D) is the sample's raw hidden state (no norm); the
    softmax runs over rows [0, query_pos]."""
    h = h.detach()
    Hq, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    rows = query_pos + 1
    q = attn_mixer.q_proj(h[query_pos:rows]).reshape(Hkv, Hq // Hkv, hd).float()
    k = attn_mixer.k_proj(h[:rows]).reshape(rows, Hkv, hd).float()
    logits = torch.einsum("grd,lgd->grl", q, k).reshape(Hq, rows) / math.sqrt(hd)
    scores = torch.softmax(logits, dim=-1).mean(dim=0)
    return scores[vision_start:vision_start + num_vision]


def _training_query_pos(labels: torch.Tensor) -> int:
    """The row before the last answer span's start (pdrop.py:121)."""
    is_ans = labels != -100
    prev_ign = torch.cat([is_ans.new_ones(1), ~is_ans[:-1]])
    starts = (is_ans & prev_ign).nonzero()
    return max(int(starts[-1]) - 1 if len(starts) else -2, 0)


def _keep_indices(stage: PdropStage, samp: PdropSampleSpec, sh: torch.Tensor,
                  sample_labels, keep: int, *, cfg: NanoConfig, attn_mixer) -> torch.Tensor:
    """The kept visual tokens, sorted, (keep,) int64 on the hidden's device."""
    cur = samp.num_vision
    if stage.compress_type == "uni":
        return torch.from_numpy(uni_keep_indices(cur, keep)).to(sh.device, torch.long)
    if stage.compress_type == "attn":
        if keep == 0:
            return torch.zeros(0, dtype=torch.long, device=sh.device)
        qpos = samp.query_pos
        if qpos is None:
            if sample_labels is None:
                raise ValueError("a training attn stage needs labels")
            qpos = _training_query_pos(sample_labels)
        scores = _rank_scores_attn(sh, attn_mixer, cfg, qpos, samp.vision_start, cur)
        # the top `keep` scores, ties to the lower index (jax.lax.top_k)
        order = torch.sort(scores, descending=True, stable=True).indices[:keep]
        return torch.sort(order).values
    raise NotImplementedError(f"pdrop compress type {stage.compress_type!r}")


def apply_pdrop_stage(
    hidden: torch.Tensor,
    labels: Optional[torch.Tensor],
    seq_idx: Optional[torch.Tensor],
    spec: PdropSpec,
    stage: PdropStage,
    stage_idx: int,
    *,
    cfg: NanoConfig,
    attn_mixer=None,
    merge: Optional[MergeModules] = None,
):
    """One stage over every sample of one packed row. hidden (1, L, D),
    labels and seq_idx (1, L) or None. Returns (hidden, labels, seq_idx,
    the new spec, ca_kv) with the new length; ca_kv is the stage's TransV
    K/V {k, v} (Nd, Hkv, hd) when one sample merged, else None.
    `attn_mixer` is the stage layer's AttentionMixer (an "attn" stage);
    `merge` the merge modules, or None for no TransV."""
    if hidden.shape[0] != 1:
        raise ValueError("pdrop runs on packed batch-1 rows")
    mm = merge.stage(stage_idx) if merge is not None else None
    h = hidden[0]
    h_parts, l_parts, s_parts, new_samples = [], [], [], []
    ca_kv, offset = None, 0
    for si, samp in enumerate(spec.samples):
        Ls, cur, vs = samp.length, samp.num_vision, samp.vision_start
        keep = min(int(spec.orig_num_vision[si] * spec.ratios[stage_idx + 1]), cur)
        sh = h[offset:offset + Ls]
        sl = labels[0, offset:offset + Ls] if labels is not None else None
        keep_idx = _keep_indices(stage, samp, sh, sl, keep, cfg=cfg, attn_mixer=attn_mixer)
        src = [torch.arange(vs, device=h.device), vs + keep_idx,
               torch.arange(vs + cur, Ls, device=h.device)]
        suffix = sh[vs + cur:]
        if mm is not None and keep < cur:
            kept = torch.zeros(cur, dtype=torch.int32, device=h.device)
            kept[keep_idx] = 1
            dropped_idx = torch.sort(torch.argsort(kept, stable=True)[:cur - keep]).values
            kv = _ca_kv(sh[vs + dropped_idx], mm, cfg)
            suffix = _gated_merge(suffix[None], kv["k"][None], kv["v"][None], mm, cfg)[0]
            if len(spec.samples) == 1:
                ca_kv = kv
        h_parts += [sh[:vs], sh[vs + keep_idx], suffix]
        src = torch.cat(src) + offset
        if labels is not None:
            l_parts.append(labels[0, src])
        if seq_idx is not None:
            s_parts.append(seq_idx[0, src])
        qp = samp.query_pos - (cur - keep) if samp.query_pos is not None else None
        new_samples.append(replace(samp, num_vision=keep, query_pos=qp))
        offset += Ls
    return (torch.cat(h_parts)[None],
            torch.cat(l_parts)[None] if labels is not None else None,
            torch.cat(s_parts)[None] if seq_idx is not None else None,
            replace(spec, samples=tuple(new_samples)), ca_kv)

