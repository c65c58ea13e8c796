"""Pure-Python METEOR — replaces the reference's meteor-1.5.jar subprocess.

The reference scores YouCook2 SODA caption similarity with the METEOR 1.5
Java jar (the reference's `eval/metrics/meteor.py:21-35`, flags
``-l en -norm``). No JRE ships in this image, so this module implements the
METEOR algorithm itself (Denkowski & Lavie 2014, "Meteor Universal"):

* one-to-one word alignment over matcher stages — **exact** (weight 1.0),
  **stem** (weight 0.6, Snowball English via nltk's pure-Python
  implementation), and **synonym** (weight 0.8 per METEOR 1.5's English
  defaults). The jar backs synonymy with WordNet, which isn't in this
  image; the synonym table here is pluggable, first hit wins:
    1. ``TIMEVIPER_METEOR_SYNONYMS`` — path to a file of
       whitespace-separated synonym groups, one group per line (e.g. a
       WordNet synset export from a machine that has it);
    2. nltk's WordNet corpus, when installed;
    3. a bundled core table of common caption-domain synonym groups
       (verbs of manipulation/motion, common adjectives/nouns — the
       vocabulary video captions actually exercise).
  Measured effect (tests/test_meteor_py.py): on synonym-dense paraphrase
  pairs the bundled stage recovers ~+0.28 mean sentence score vs no
  synonymy at all; on text sharing surface vocabulary it is exactly
  neutral. The residual jar-vs-python bias is therefore confined to
  paraphrases whose synonym pairs full WordNet covers and the bundled
  table misses — supply a WordNet export via TIMEVIPER_METEOR_SYNONYMS
  to close it. The jar's fourth stage (paraphrase tables) is
  intentionally out of scope.
* alignment chosen by beam search maximizing matched words, then fewest
  chunks, then smallest total |i-j| distance — the jar's resolution order.
* scoring with the English defaults: alpha=0.85, beta=0.2, gamma=0.6,
  delta=0.75; content words weighted delta, function words 1-delta.

      P      = sum(w_mod * w_word) over hyp-side matches / sum w_word(hyp)
      R      = same over the reference side
      Fmean  = P*R / (alpha*P + (1-alpha)*R)
      frag   = chunks / matches
      score  = (1 - gamma * frag**beta) * Fmean

Note METEOR deliberately does not score identical sentences 1.0: a single
chunk still carries the fragmentation penalty gamma*(1/m)**beta.

API mirrors eval/meteor.py's jar wrapper: ``compute_score(res, gts)`` with
``{id: [hypothesis]}`` / ``{id: [ref, ...]}`` returning ``(mean, scores)``;
multi-reference items take the best-scoring reference, as the jar does.
"""

from __future__ import annotations

import functools
import re
from typing import Dict, List, Sequence, Tuple

ALPHA, BETA, GAMMA, DELTA = 0.85, 0.2, 0.6, 0.75
W_EXACT, W_STEM, W_SYN = 1.0, 0.6, 0.8
BEAM = 64

# Bundled caption-domain synonym groups (stage-3 fallback; see module
# docstring). Groups, not pairs: two tokens are synonyms when they share
# a group, mirroring WordNet synset membership. Curated for the video
# caption/DVC vocabulary (YouCook2 cooking actions, generic motion and
# appearance words) — NOT a WordNet copy.
_CORE_SYNONYM_GROUPS = """
put place set lay
cut slice chop dice mince
cook prepare make fix
fry saute sear
grill broil
bake roast
boil simmer
stir mix blend combine whisk
add pour
take remove grab pick
begin start commence
end finish complete conclude
show display present demonstrate
talk speak chat converse
say tell state mention
walk stroll
run sprint jog
jump leap hop
look watch view observe see
hold grasp grip clutch
throw toss hurl
push shove
pull drag tug
turn rotate spin twist flip
open unwrap
close shut
clean wash rinse wipe
dry drain
heat warm
cool chill refrigerate
big large huge enormous giant
small little tiny
fast quick rapid speedy
slow sluggish
happy glad joyful cheerful
sad unhappy
man guy gentleman male
woman lady female
child kid youngster
car automobile vehicle
road street
house home
photo photograph picture image
movie film video clip
food dish meal
piece slice portion chunk
bowl container
pan skillet
pot saucepan
plate dish
knife blade
oil grease
meat beef
shrimp prawn
corn maize
eggplant aubergine
zucchini courgette
cilantro coriander
scallion shallot
garbanzo chickpea
couch sofa
trash garbage rubbish
store shop
buy purchase
get obtain acquire receive
give provide hand
use utilize employ
need require
want desire wish
like enjoy love
help assist aid
try attempt
ask request inquire
answer reply respond
leave depart exit
arrive come reach
climb ascend
fall drop descend
carry transport haul
build construct assemble
break smash shatter
fix repair mend
wear don
sit seated
stand upright
sleep nap doze
eat consume devour
drink sip
smile grin
laugh chuckle giggle
cry weep sob
shout yell scream
whisper murmur
street road avenue
ocean sea
forest woods
mountain peak
rock stone boulder
rain shower drizzle
wind breeze
quickly rapidly swiftly fast
slowly gradually
almost nearly
maybe perhaps possibly
"""


@functools.lru_cache(maxsize=1)
def _synonym_groups() -> Dict[str, frozenset]:
    """token -> frozenset of group ids. Sources in priority order:
    env-pointed file, nltk WordNet, bundled core table. The chosen
    source is announced once (scores depend on it — a silent
    machine-dependent table would make METEOR/SODA numbers
    incomparable across machines); a set-but-missing env path is an
    ERROR, not a silent fallthrough to a different table."""
    import os
    import warnings

    path = os.environ.get("TIMEVIPER_METEOR_SYNONYMS")
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"TIMEVIPER_METEOR_SYNONYMS={path!r} does not exist — "
                "refusing to silently score with a different synonym "
                "table")
        with open(path) as f:
            lines = [ln.split() for ln in f if ln.strip()]
        warnings.warn(f"METEOR synonym table: file {path}", stacklevel=2)
        return _groups_from_lines(lines)
    try:  # WordNet corpus, if some environment provides it
        from nltk.corpus import wordnet as wn

        wn.synsets("test")  # raises LookupError when the corpus is absent

        @functools.lru_cache(maxsize=65536)
        def _synsets(tok):
            return frozenset(s.name() for s in wn.synsets(tok))

        class _WN:
            def __contains__(self, _):
                return True

            def __getitem__(self, tok):
                return _synsets(tok)

        warnings.warn("METEOR synonym table: nltk WordNet", stacklevel=2)
        return _WN()  # type: ignore[return-value]
    except (LookupError, ImportError):
        pass
    return _groups_from_lines(
        [ln.split() for ln in _CORE_SYNONYM_GROUPS.splitlines()
         if ln.strip()])


def _groups_from_lines(lines) -> Dict[str, frozenset]:
    tok2groups: Dict[str, set] = {}
    for gid, group in enumerate(lines):
        for tok in group:
            tok2groups.setdefault(tok.lower(), set()).add(gid)
    return {t: frozenset(g) for t, g in tok2groups.items()}


def _are_synonyms(a: str, b: str) -> bool:
    groups = _synonym_groups()
    ga = groups[a] if a in groups else None
    if not ga:
        return False
    gb = groups[b] if b in groups else None
    return bool(gb) and not ga.isdisjoint(gb)

# English function words (METEOR 1.5 ships data/function/en.words, built
# from corpus frequency; this embedded list covers the closed-class core —
# determiners, pronouns, prepositions, conjunctions, auxiliaries,
# punctuation). Content/function only reweights by delta, so residual list
# differences perturb scores far less than the matcher stages do.
_FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every no neither either
i you he she it we they me him her us them my your his its our their
mine yours hers ours theirs myself yourself himself herself itself
ourselves yourselves themselves who whom whose which what
and or but nor so yet for if while although though because since unless
until when whenever where wherever whether as than
in on at by with from to of about against between into through during
before after above below up down out off over under again further then
once here there all both few more most other such only own same too very
just also not
am is are was were be been being have has had having do does did doing
will would shall should may might must can could
's 't 'll 've 're 'd 'm n't
. , ; : ! ? ' " ` ( ) [ ] { } - -- ...
""".split())

_PUNCT_RE = re.compile(r"([\.,;:!\?\"\(\)\[\]\{\}])")


def normalize(text: str) -> List[str]:
    """METEOR ``-norm``: lowercase, split off punctuation, whitespace-split."""
    text = text.replace("<", " ").replace(">", " ")
    text = _PUNCT_RE.sub(r" \1 ", text)
    return text.lower().split()


@functools.lru_cache(maxsize=65536)
def _stem(tok: str) -> str:
    return _stemmer()(tok)


@functools.lru_cache(maxsize=1)
def _stemmer():
    try:
        from nltk.stem.snowball import SnowballStemmer

        return SnowballStemmer("english").stem
    except Exception:  # pragma: no cover - nltk is baked into the image
        return lambda t: t


def _align(hyp: List[str], ref: List[str]):
    """One-to-one alignment; returns (matches, chunks) where matches is a
    list of (hyp_idx, ref_idx, module_weight)."""
    n, m = len(hyp), len(ref)
    # candidate ref positions per hyp word, each with its best module
    cand: List[List[Tuple[int, float]]] = []
    hyp_stems = [_stem(t) for t in hyp]
    ref_stems = [_stem(t) for t in ref]
    for i in range(n):
        row = []
        for j in range(m):
            if hyp[i] == ref[j]:
                row.append((j, W_EXACT))
            elif hyp_stems[i] == ref_stems[j]:
                row.append((j, W_STEM))
            elif _are_synonyms(hyp[i], ref[j]):
                row.append((j, W_SYN))
        cand.append(row)

    # beam over hyp positions: state = (used ref bitmask, last matched
    # (hi, rj) for chunk continuation, matches list, chunks, total dist)
    # ranked by (-#matches, chunks, dist) — METEOR's resolution order.
    Start = (0, None, (), 0, 0.0)
    beam = [Start]
    for i in range(n):
        nxt = []
        for used, last, ms, ch, dist in beam:
            nxt.append((used, last, ms, ch, dist))  # leave hyp[i] unmatched
            for j, w in cand[i]:
                if used >> j & 1:
                    continue
                contiguous = last is not None and last == (i - 1, j - 1)
                nxt.append((used | (1 << j), (i, j), ms + ((i, j, w),),
                            ch + (0 if contiguous else 1),
                            dist + abs(i - j)))
        nxt.sort(key=lambda s: (-len(s[2]), s[3], s[4]))
        # dedupe identical (used, last) keeping the best-ranked
        seen, beam = set(), []
        for s in nxt:
            k = (s[0], s[1])
            if k in seen:
                continue
            seen.add(k)
            beam.append(s)
            if len(beam) >= BEAM:
                break
    _, _, ms, ch, _ = beam[0]
    return list(ms), ch


def _word_weight(tok: str) -> float:
    return 1.0 - DELTA if tok in _FUNCTION_WORDS else DELTA


def sentence_score(hypothesis: str, references: Sequence[str]) -> float:
    hyp = normalize(hypothesis)
    best = 0.0
    for reference in references:
        ref = normalize(reference)
        if not hyp or not ref:
            continue
        matches, chunks = _align(hyp, ref)
        if not matches:
            continue
        hyp_total = sum(_word_weight(t) for t in hyp)
        ref_total = sum(_word_weight(t) for t in ref)
        p_num = sum(w * _word_weight(hyp[i]) for i, _, w in matches)
        r_num = sum(w * _word_weight(ref[j]) for _, j, w in matches)
        p = p_num / hyp_total if hyp_total else 0.0
        r = r_num / ref_total if ref_total else 0.0
        if p + r == 0:
            continue
        fmean = p * r / (ALPHA * p + (1.0 - ALPHA) * r)
        frag = chunks / len(matches)
        score = (1.0 - GAMMA * frag ** BETA) * fmean
        best = max(best, score)
    return best


class MeteorPyScorer:
    """Drop-in for eval/meteor.py's jar wrapper (same compute_score API)."""

    def compute_score(self, res: Dict, gts: Dict) -> Tuple[float, list]:
        ids = list(res.keys())
        scores = [sentence_score(res[i][0], gts[i]) for i in ids]
        mean = sum(scores) / len(scores) if scores else 0.0
        return mean, scores
