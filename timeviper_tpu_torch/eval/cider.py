"""CIDEr-D metric — standalone numpy implementation.

Replaces the forked pycocoevalcap CIDEr (reference eval/metrics/cider*.py):
TF-IDF weighted n-gram (n=1..4) cosine similarity with the CIDEr-D length
penalty exp(-(lc-ls)^2 / (2*sigma^2)) and clipped counts. IDF statistics come
from the reference-corpus documents, matching pycocoevalcap semantics.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

from timeviper_tpu_torch.eval.ptb import ptb_tokenize


def tokenize(s: str) -> List[str]:
    """PTB tokenization with punctuation removal — the reference pipes
    captions through Stanford PTBTokenizer before scoring
    (eval/metrics/ptbtokenizer.py); see eval/ptb.py."""
    return ptb_tokenize(s)


def _ngrams(tokens: Sequence[str], n_max: int = 4) -> Dict[int, Counter]:
    out = {}
    for n in range(1, n_max + 1):
        out[n] = Counter(
            tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)
        )
    return out


class CiderScorer:
    """compute_score(gts, res) over {id: [sentence...]} dicts, mirroring the
    pycocoevalcap scorer interface so it can slot into SODA."""

    def __init__(self, n: int = 4, sigma: float = 6.0) -> None:
        self.n = n
        self.sigma = sigma

    def compute_score(
        self, res: Dict, gts: Dict
    ) -> Tuple[float, "np.ndarray"]:
        import numpy as np

        ids = list(res.keys())
        cand = {i: _ngrams(tokenize(res[i][0]), self.n) for i in ids}
        refs = {
            i: [_ngrams(tokenize(r), self.n) for r in gts[i]] for i in ids
        }

        # document frequency over the reference corpus
        df: Dict[int, Counter] = {n: Counter() for n in range(1, self.n + 1)}
        for i in ids:
            for n in range(1, self.n + 1):
                seen = set()
                for ref in refs[i]:
                    seen |= set(ref[n].keys())
                for g in seen:
                    df[n][g] += 1
        log_ndocs = math.log(max(len(ids), 1))

        def vec(counts: Dict[int, Counter], length: int):
            vecs, norms = {}, {}
            for n in range(1, self.n + 1):
                v = {}
                for g, c in counts[n].items():
                    idf = log_ndocs - math.log(max(df[n][g], 1))
                    v[g] = c * idf
                vecs[n] = v
                norms[n] = math.sqrt(sum(x * x for x in v.values()))
            return vecs, norms

        scores = np.zeros((len(ids),))
        for k, i in enumerate(ids):
            c_tok_len = sum(cand[i][1].values())
            cv, cn = vec(cand[i], c_tok_len)
            sims = []
            for ref in refs[i]:
                r_tok_len = sum(ref[1].values())
                rv, rn = vec(ref, r_tok_len)
                per_n = []
                for n in range(1, self.n + 1):
                    num = 0.0
                    for g, w in cv[n].items():
                        if g in rv[n]:
                            # CIDEr-D clips candidate counts to ref counts
                            num += min(w, rv[n][g]) * rv[n][g]
                    denom = cn[n] * rn[n]
                    s = num / denom if denom > 0 else 0.0
                    delta = c_tok_len - r_tok_len
                    s *= math.exp(-(delta ** 2) / (2 * self.sigma ** 2))
                    per_n.append(s)
                sims.append(10.0 * sum(per_n) / self.n)
            scores[k] = sum(sims) / max(len(sims), 1)
        return float(scores.mean()) if len(ids) else 0.0, scores


def cider_score(
    candidates: Sequence[str], references: Sequence[Sequence[str]]
) -> float:
    res = {i: [c] for i, c in enumerate(candidates)}
    gts = {i: list(r) for i, r in enumerate(references)}
    mean, _ = CiderScorer().compute_score(res, gts)
    return mean
