"""Sentence segmentation for long-input synthesis (beyond the
reference, which synthesizes each input line as one utterance,
gen_forward.py:84-96).

Rule-based and dependency-free: split after sentence-final
punctuation ([.!?] runs, optionally followed by closing quotes or
brackets) when the next token looks like a sentence start — but never
inside common abbreviations, single-initial names ("J. Smith"),
decimal numbers, or ellipses used as a pause. Splitting long articles
into sentences keeps serving latency per dispatch bounded and lets the
dynamic batcher pack one request's sentences into shared device
programs.
"""
from __future__ import annotations

import re
from typing import List

# common English abbreviations that end with a period mid-sentence
_ABBREVIATIONS = {
    'mr', 'mrs', 'ms', 'dr', 'prof', 'sr', 'jr', 'st', 'ave', 'blvd',
    'rd', 'mt', 'ft', 'no', 'vs', 'etc', 'inc', 'ltd', 'co', 'corp',
    'dept', 'est', 'fig', 'gen', 'gov', 'capt', 'col', 'sgt', 'lt',
    'rev', 'hon', 'pres', 'supt', 'approx', 'appt', 'dept', 'min',
    'max', 'misc', 'tel', 'temp', 'vol', 'e.g', 'i.e', 'a.m', 'p.m',
    'u.s', 'u.k', 'ph.d', 'm.d', 'b.a', 'm.a', 'd.c',
}

_BOUNDARY = re.compile(
    r'''([.!?]+['")\]]*)      # sentence-final punctuation (+closers)
        (\s+)                 # whitespace gap
        (?=[^\s])             # something follows
    ''', re.VERBOSE)


def _is_abbreviation(prefix: str) -> bool:
    """True when the text right before the period is an abbreviation
    or a single initial ("J.")."""
    m = re.search(r"([\w.']+)$", prefix)
    if not m:
        return False
    word = m.group(1).rstrip('.').lower()
    if word in _ABBREVIATIONS:
        return True
    # single-letter initial: "J. Smith", "George W. Bush"
    if len(word) == 1 and word.isalpha():
        return True
    return False


def split_sentences(text: str, max_len: int = 0) -> List[str]:
    """Split `text` into sentences. With `max_len` > 0, sentences
    longer than that many characters are further split at
    comma/semicolon clause boundaries (best-effort) so no single
    utterance exceeds the cap by much."""
    text = text.strip()
    if not text:
        return []
    pieces: List[str] = []
    start = 0
    for m in _BOUNDARY.finditer(text):
        end_punct = m.group(1)
        prefix = text[start:m.start()]
        if end_punct == '.' and _is_abbreviation(prefix):
            continue
        nxt = text[m.end()]
        # decimals ("3. 14" never occurs; "p. 5" handled above) — only
        # split when the next char plausibly starts a sentence
        if nxt.islower():
            continue
        pieces.append(text[start:m.start() + len(end_punct)].strip())
        start = m.end()
    tail = text[start:].strip()
    if tail:
        pieces.append(tail)
    if max_len and max_len > 0:
        pieces = [c for p in pieces for c in _split_clauses(p, max_len)]
    return pieces


def _split_clauses(sentence: str, max_len: int) -> List[str]:
    if len(sentence) <= max_len:
        return [sentence]
    out: List[str] = []
    current = sentence
    while len(current) > max_len:
        # last clause boundary within the cap; else hard-split on space
        window = current[:max_len]
        cut = max(window.rfind(', '), window.rfind('; '))
        if cut <= 0:
            cut = window.rfind(' ')
        if cut <= 0:
            cut = max_len
            out.append(current[:cut].strip())
            current = current[cut:].strip()
            continue
        out.append(current[:cut + 1].strip())
        current = current[cut + 1:].strip()
    if current:
        out.append(current)
    return [o for o in out if o]
