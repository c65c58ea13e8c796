"""N-gram (prompt-lookup) speculative decoding for both backbones
(counterpart of timeviper_tpu/models/speculative.py).

A decode step at batch 1 pays for a whole pass over the weights and, on the
card, for a thousand kernel launches from the host; one verify pass of
`n_draft + 1` rows pays about the same. Drafts come from the prompt itself:
the most recent earlier occurrence of the last k-gram of the token history
proposes the tokens that followed it. Without a match the round is one plain
decode step, so speculation is opportunistic.

Each round, greedy only:
  1. propose (`ngram_propose`, on the host: the loop reads the accepted
     count there every round anyway);
  2. with a match, VERIFY: one continuation of [pending, d_1..d_n] with
     `logits_all` (models/prefix_cache.py); accept the longest prefix of
     drafts equal to the argmax, a, plus the model's own next token;
  3. COMMIT: with a == n the verify's cache is already the committed one;
     otherwise run the same continuation on the first a + 1 rows from the
     cache before the verify.
The output is token-identical to the plain greedy loop; any other sampling
runs the plain loop (models/generate.py), as in the JAX package.

The cache is not rolled back, as in JAX, but kept: the Mamba states are
not rollback-able (the verify's have absorbed every draft). Each
continuation leaves its input cache untouched (its K/V buffers are copied,
its Mamba states new), as JAX's immutable pytree is, so the pre-verify cache
is there for the commit. The copies move every attention layer's K/V
buffers, twice on a partial commit; `chip_smoke.py` times them against the
round they sit in.

Where the port leaves the JAX code behind: a draft's -1 slots (history not
yet filled, which JAX embeds as the last vocabulary row) can never be
accepted, and the rows after them cannot reach an accepted row's logits, so
the verify runs only the drafts before the first -1; when all of those are
accepted, its cache is the committed one.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from timeviper_tpu_torch.models.prefix_cache import forward_continue
from timeviper_tpu_torch.models.vlm import decode_step


def ngram_propose(buf: np.ndarray, buf_len: int, n_draft: int, k: int = 2
                  ) -> Tuple[np.ndarray, bool]:
    """(draft (n_draft,) int32, has_match): the n_draft tokens after the most
    recent match of the last k-gram of buf[:buf_len] (slots from buf_len on
    are -1 and never match; the trivial self-match at the end is excluded).
    The slice starts at the match clamped to M - n_draft, as JAX's
    dynamic_slice clamps it, so a match near the buffer's end drafts its
    last n_draft slots; a negative history index wraps, as JAX's does."""
    buf = np.asarray(buf)
    M = buf.shape[0]
    pos = np.arange(M)
    ok = (pos >= k) & (pos <= buf_len - 1)
    for j in range(k):
        idx = buf_len - 1 - j
        idx = min(max(idx + M if idx < 0 else idx, 0), M - 1)
        tj = buf[idx]
        prev = np.concatenate([np.full((1 + j,), -2, buf.dtype), buf[:M - 1 - j]])
        ok &= (prev == tj) & (tj >= 0)
    p_star = int(np.max(np.where(ok, pos, -1)))
    start = min(max(p_star, 0), M - n_draft)
    return buf[start:start + n_draft].astype(np.int32), bool(ok.any())


def text_history(ids: Sequence[int], image_token_id, pad_token_id: int,
                 max_new_tokens: int, n_draft: int) -> Tuple[np.ndarray, int]:
    """The host n-gram buffer: the prompt's text tokens (visual placeholders
    carry no draftable continuation) padded with -1 to a power of two of at
    least 128 slots, room for everything the loop may append."""
    toks = [t for t in ids if t != image_token_id and t != pad_token_id]
    n = len(toks) + max_new_tokens + n_draft + 2
    size = max(128, 1 << (n - 1).bit_length())
    buf = np.full((size,), -1, np.int32)
    buf[: len(toks)] = toks
    return buf, len(toks)


@torch.inference_mode()
def spec_decode(model, arch, first_logits: torch.Tensor, cache: Dict, buf: np.ndarray,
                buf_len: int, *, max_new_tokens: int, terminators: Sequence[int],
                n_draft: int = 7, ngram_k: int = 2) -> Tuple[np.ndarray, Dict[str, int]]:
    """The greedy speculative loop from the prefill's last-row logits
    first_logits (1, V) and the decode cache, which the loop owns (its plain
    steps write rows in place). `buf` / `buf_len` come from `text_history`
    (the buffer is written).
    Returns (the tokens, terminator included, at most max_new_tokens; the
    rounds' counts: drafts proposed and accepted, verify passes, partial
    commits, plain steps)."""
    llm, cfg = model.llm_backbone, arch.llm
    cont = forward_continue(arch)
    terms = set(int(t) for t in terminators)
    counts = dict.fromkeys(("proposed", "accepted", "verify", "partial", "plain"), 0)
    dev = llm.embeddings.weight.device
    S = n_draft + 1

    def run(c, seq: List[int]):
        embeds = llm.embeddings(torch.as_tensor([seq], dtype=torch.long, device=dev))
        return cont(llm, cfg, embeds, c, pdrop_params=model.merge_modules, logits_all=True,
                    chunk_size=S)

    tok = int(first_logits[0].argmax())
    out = [tok]
    buf[buf_len] = tok
    buf_len += 1
    done = tok in terms or max_new_tokens <= 1
    while not done:
        draft, has = ngram_propose(buf, buf_len, n_draft, ngram_k)
        if has:
            n = int(np.argmax(draft < 0)) if (draft < 0).any() else n_draft
            seq = [tok] + draft[:n].tolist()
            logits, verified = run(cache, seq)
            preds = logits[0].argmax(-1).tolist()
            a = 0
            while a < n and preds[a] == seq[a + 1]:
                a += 1
            emit = seq[1:a + 1] + [preds[a]]
            counts["verify"] += 1
            counts["proposed"] += n
            counts["accepted"] += a
            if a == n:
                cache = verified
            else:
                counts["partial"] += 1
                _, cache = run(cache, seq[:a + 1])
        else:
            logits, cache = decode_step(model, arch, torch.as_tensor(
                [[tok]], dtype=torch.long, device=dev), cache)
            emit = [int(logits[0].argmax())]
            counts["plain"] += 1
        hit = next((j for j, t in enumerate(emit) if t in terms), None)
        c = len(emit) if hit is None else hit + 1
        done = hit is not None or len(out) + c >= max_new_tokens
        c = min(c, max_new_tokens - len(out))
        # the next round's pending token: the model's own last one; every
        # token before it is in the committed cache
        tok = emit[-1]
        out += emit[:c]
        buf[buf_len:buf_len + c] = emit[:c]
        buf_len += c
    return np.asarray(out, np.int32), counts
