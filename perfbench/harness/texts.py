"""The serving traffic's texts: sentences of words from the frozen
lexicon, lowercase, single spaces, closed by a period, with character
lengths drawn to LJSpeech's shape (a Beta over [chars_min, chars_max]
matched to its clips' mean and spread). Lengths are the stratified
quantiles of that Beta, in an order drawn from the seed, so that every
seed sends the same set of sizes; the words are drawn from the seed."""
from __future__ import annotations

import random
from typing import Any, Dict, List

from perfbench.reference.frontend import load_lexicon


def _beta_quantiles(n: int, a: float, b: float) -> List[float]:
    """The midpoint quantiles (i + 0.5) / n of Beta(a, b), by a scan of
    its numerically integrated CDF (no scipy needed)."""
    grid = 4096
    xs = [(i + 0.5) / grid for i in range(grid)]
    dens = [x ** (a - 1) * (1 - x) ** (b - 1) for x in xs]
    total = sum(dens)
    cdf, acc = [], 0.0
    for d in dens:
        acc += d / total
        cdf.append(acc)
    out, j = [], 0
    for i in range(n):
        q = (i + 0.5) / n
        while j < grid - 1 and cdf[j] < q:
            j += 1
        out.append((j + 0.5) / grid)
    return out


def char_lengths(n: int, params: Dict[str, Any], rng: random.Random
                 ) -> List[int]:
    lo, hi = params['chars_min'], params['chars_max']
    a, b = params['chars_beta']
    lengths = [int(round(lo + (hi - lo) * q))
               for q in _beta_quantiles(n, a, b)]
    rng.shuffle(lengths)
    return lengths


def sentence(target: int, words: List[str], rng: random.Random) -> str:
    """Words drawn until the text (with its closing period) is at least
    `target` characters long, the last one chosen to land nearest."""
    out: List[str] = []
    length = 1
    while True:
        w = rng.choice(words)
        grow = len(w) + (1 if out else 0)
        if length + grow > target and out:
            fits = [x for x in words if length + len(x) + 1 <= target]
            if fits and target - length > 2:
                out.append(rng.choice(fits))
            break
        out.append(w)
        length += grow
        if length >= target:
            break
    return ' '.join(out) + '.'


def texts(n: int, params: Dict[str, Any], seed: int) -> List[str]:
    rng = random.Random(int(seed) * 2 + 1)
    words = sorted(load_lexicon())
    return [sentence(t, words, rng) for t in char_lengths(n, params, rng)]


def mean_chars(params: Dict[str, Any]) -> float:
    a, b = params['chars_beta']
    return params['chars_min'] + (params['chars_max'] - params['chars_min']) \
        * a / (a + b)

