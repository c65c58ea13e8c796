"""ToMe token merging, bipartite soft matching (counterpart of
timeviper_tpu/ops/tome.py).

Even tokens are sources, odd tokens destinations. Each source scores its best
cosine match among the destinations; the r best-scoring sources are merged,
size-weighted, into their matches. Output order is [unmerged sources by
descending score, destinations], as in the reference. The merged sources
are summed into their destinations as a product with a one-hot matrix, as
the JAX package does: a scatter-add takes atomics on the card, whose order
changes from run to run, and so did the visual tokens' last bits and, at
near-ties, the greedy tokens after them. The product's sums are the same on
every run.
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def merge_schedule(num_tokens: int, target: int) -> List[int]:
    """Per-round merge counts; empty when already at or below target."""
    if num_tokens <= target:
        return []
    r_list = []
    p = num_tokens
    while p != target:
        if p - target <= p // 2:
            r_list.append(p - target)
            break
        r_list.append(p // 2)
        p = p - p // 2
    return r_list


def _bipartite_merge_round(
    x: torch.Tensor, size: torch.Tensor, metric: torch.Tensor, r: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, C) size-weighted values; size (B, T, 1); metric (B, T, Cm).
    Returns merged values (B, T - r, C) and sizes (B, T - r, 1), float32."""
    B, T, C = x.shape
    r = min(r, T // 2)
    m = metric / (metric.norm(dim=-1, keepdim=True) + 1e-6)
    scores = m[:, ::2] @ m[:, 1::2].transpose(1, 2)  # (B, t_a, t_b)
    node_idx = scores.argmax(dim=-1)  # first maximum on ties, as jnp.argmax
    node_max = scores.gather(2, node_idx[..., None])[..., 0]
    order = torch.argsort(-node_max, dim=-1, stable=True)
    unm_idx, src_idx = order[:, r:], order[:, :r]
    dst_idx = node_idx.gather(1, src_idx)  # (B, r)

    src_x, dst_x = x[:, ::2], x[:, 1::2]
    src_s, dst_s = size[:, ::2], size[:, 1::2]
    merged_x = src_x.gather(1, src_idx[..., None].expand(-1, -1, C))
    merged_s = src_s.gather(1, src_idx[..., None])
    onehot = torch.zeros(B, r, dst_x.shape[1], dtype=x.dtype, device=x.device)
    onehot.scatter_(2, dst_idx[..., None], 1.0)  # [b, i, j] = 1: merged source i -> dst j
    dx = dst_x + onehot.transpose(1, 2) @ merged_x
    ds = dst_s + onehot.transpose(1, 2) @ merged_s
    unm_x = src_x.gather(1, unm_idx[..., None].expand(-1, -1, C))
    unm_s = src_s.gather(1, unm_idx[..., None])
    return torch.cat([unm_x, dx], dim=1), torch.cat([unm_s, ds], dim=1)


def tome_merge(
    x: torch.Tensor,
    target_num_tokens: int,
    num_attention_heads: int = 16,
    token_order: str = "raw",
) -> torch.Tensor:
    """Merge (B, T, C) tokens down to (B, target, C). The metric of each round
    is the current tokens averaged over `num_attention_heads` head groups."""
    B, T, C = x.shape
    xf = x.float()
    size = torch.ones(B, T, 1, dtype=torch.float32, device=x.device)
    head = num_attention_heads
    for r in merge_schedule(T, target_num_tokens):
        p = xf.shape[1]
        metric = xf.reshape(B, p, head, C // head).mean(dim=2)
        xw, size = _bipartite_merge_round(xf * size, size, metric, r)
        xf = xw / size
    if token_order in ("ascending", "descending"):
        key = size[..., 0]
        order = torch.argsort(-key if token_order == "descending" else key, dim=-1, stable=True)
        xf = xf.gather(1, order[..., None].expand(-1, -1, C))
    return xf.to(x.dtype)
