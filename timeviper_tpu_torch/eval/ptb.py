"""PTB tokenization for caption metrics — pure-Python, no Java.

The reference pipes captions through Stanford CoreNLP's PTBTokenizer
(`-preserveLines -lowerCase`) and drops punctuation tokens
(eval/metrics/ptbtokenizer.py:18-36, 60-117). pycocoevalcap-comparable
CIDEr/SODA numbers need the same token stream: contractions split
("don't" -> "do n't", kept), intra-word hyphens preserved
("well-known" stays one token), and standalone punctuation removed.
A bare regex strip (round 1) merged "don't" -> "dont" and
"well-known" -> "wellknown", shifting every n-gram.

This implements the Penn Treebank tokenization rules (Robert McIntyre's
public tokenizer.sed, the algorithm PTBTokenizer descends from): quote
normalization, punctuation splitting, bracket transduction, and the
MacIntyre contraction set. No Java/CoreNLP dependency (the image has
neither the JRE nor the jar).
"""

from __future__ import annotations

import re
from typing import List

# punctuation tokens the reference wrapper removes after tokenization
# (eval/metrics/ptbtokenizer.py:18-36)
PUNCTUATIONS = frozenset([
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
])

# --- treebank rules (order matters) ---------------------------------------

_STARTING_QUOTES = [
    (re.compile(r"^\""), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ \(\[{<])(\"|\'{2})"), r"\1 `` "),
]

_PUNCTUATION = [
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    # final period (possibly followed by closing quotes/brackets)
    (re.compile(r'([^\.])(\.)([\]\)}>"\']*)\s*$'), r"\1 \2\3 "),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
]

_BRACKETS = [
    (re.compile(r"\("), " -LRB- "),
    (re.compile(r"\)"), " -RRB- "),
    (re.compile(r"\["), " -LSB- "),
    (re.compile(r"\]"), " -RSB- "),
    (re.compile(r"\{"), " -LCB- "),
    (re.compile(r"\}"), " -RCB- "),
    (re.compile(r"--"), " -- "),
]

_ENDING_QUOTES = [
    (re.compile(r'"'), " '' "),
    (re.compile(r"(\S)(\'\')"), r"\1 \2 "),
    # possessives / contractions: split trailing 's, n't, etc.
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]

_CONTRACTIONS = [
    re.compile(r"\b(can)(?#X)(not)\b", re.IGNORECASE),
    re.compile(r"\b(d)(?#X)('ye)\b", re.IGNORECASE),
    re.compile(r"\b(gim)(?#X)(me)\b", re.IGNORECASE),
    re.compile(r"\b(gon)(?#X)(na)\b", re.IGNORECASE),
    re.compile(r"\b(got)(?#X)(ta)\b", re.IGNORECASE),
    re.compile(r"\b(lem)(?#X)(me)\b", re.IGNORECASE),
    re.compile(r"\b(mor)(?#X)('n)\b", re.IGNORECASE),
    re.compile(r"\b(wan)(?#X)(na)(?=\s)", re.IGNORECASE),
]


def ptb_tokenize(text: str, lower: bool = True,
                 remove_punctuation: bool = True) -> List[str]:
    """Tokenize one caption the way the reference's PTBTokenizer wrapper
    does: PTB rules, lowercase, punctuation tokens dropped."""
    if lower:
        text = text.lower()
    text = text.replace("\n", " ")

    for pat, sub in _STARTING_QUOTES:
        text = pat.sub(sub, text)
    for pat, sub in _PUNCTUATION:
        text = pat.sub(sub, text)
    for pat, sub in _BRACKETS:
        text = pat.sub(sub, text)
    text = " " + text + " "
    for pat, sub in _ENDING_QUOTES:
        text = pat.sub(sub, text)
    for pat in _CONTRACTIONS:
        text = pat.sub(r" \1 \2 ", text)

    toks = text.split()
    if remove_punctuation:
        toks = [t for t in toks if t not in PUNCTUATIONS]
    return toks
