"""Durations from attention matrices: a port of the JAX package's
`align/duration.py`.

The reference runs scipy's Dijkstra over a (T_mel x T_text) lattice with
right, down and diagonal edges (utils/duration_extraction.py:16-87). The
shortest path there is a dynamic program whose within-row recursion
collapses into a prefix minimum:

    dist[i, j] = cost[i, j] + min(dist[i, j-1], dist[i-1, j],
                                  dist[i-1, j-1])
    =>  with c = cumsum(cost[i]), base = min(dist[i-1], shift(dist[i-1])):
        dist[i, j] = c[j] + min_{k<=j}(base[k] - c[k-1])

Here each row is a few numpy float32 vector operations on the host, with
`np.minimum.accumulate` in place of the JAX package's
`lax.associative_scan`, and the backtrace counts one duration per mel
frame, as there. Where a float32 near-tie breaks the other way than the
JAX package's (its cumulative sums may round differently), the two paths
have the same total cost.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _dp_forward(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """cost (T, N) float32 -> (dist (T, N), choice (T, N) int8).

    choice encodes the predecessor of (i, j): 0 = left (i, j-1),
    1 = up (i-1, j), 2 = diag (i-1, j-1). Row 0 is all-left."""
    T, N = cost.shape
    big = np.full(1, 1e30, np.float32)
    zero = np.zeros(1, np.float32)
    dists = np.empty((T, N), np.float32)
    choices = np.zeros((T, N), np.int8)
    dists[0] = np.cumsum(cost[0])
    for i in range(1, T):
        up = dists[i - 1]
        diag = np.concatenate([big, up[:-1]])
        base = np.minimum(up, diag)
        c = np.cumsum(cost[i])
        keys = base - np.concatenate([zero, c[:-1]])
        dist = c + np.minimum.accumulate(keys)
        # entered this row at column j (a vertical or diagonal move) iff
        # the minimum was taken at k == j; otherwise from the left
        entered_here = dist >= base + cost[i] - 1e-6
        choice = np.where(entered_here, np.where(diag <= up, 2, 1), 0)
        choice[0] = 2 if diag[0] <= up[0] else 1
        dists[i] = dist
        choices[i] = choice
    return dists, choices


def extract_durations_with_dp(seq_len: int, att: np.ndarray,
                              mel_len: int) -> np.ndarray:
    """Shortest monotone path through (1 - att) -> per-phoneme durations
    (int32, summing to mel_len). att (T_mel_padded, N); its first mel_len
    rows and seq_len columns are used."""
    att = np.asarray(att, dtype=np.float32)
    cost = 1.0 - att[:mel_len, :seq_len]
    T, N = cost.shape
    if T == 0 or N == 0:
        return np.zeros(seq_len, dtype=np.int32)
    choices = _dp_forward(cost)[1]

    # one duration count per mel row: the rightmost text index visited
    # in that row, which is the first node the backtrace meets in it
    durations = np.zeros(seq_len, dtype=np.int32)
    i, j = T - 1, N - 1
    durations[j] += 1                      # exit node of the last row
    while i > 0:
        c = choices[i, j]
        if c == 0 and j > 0:               # left move within row i
            j -= 1
        elif c == 1:                       # vertical
            i -= 1
            durations[j] += 1
        else:                              # diagonal
            i -= 1
            j = max(j - 1, 0)
            durations[j] += 1
    if durations.sum() != mel_len:
        raise RuntimeError(f'durations sum {durations.sum()} != mel_len '
                           f'{mel_len}')
    return durations


def extract_durations_with_dijkstra(seq: np.ndarray, att: np.ndarray,
                                    mel_len: int) -> np.ndarray:
    """The reference's name for the same shortest path."""
    return extract_durations_with_dp(int(np.shape(seq)[0]), att, mel_len)


def extract_durations_per_count(seq: np.ndarray, att: np.ndarray,
                                mel_len: int) -> np.ndarray:
    """Argmax peak counting with jump smoothing (the reference's
    duration_extraction.py:90-101)."""
    argmax = np.argmax(att[:, :], axis=1)
    durations = np.zeros(np.shape(seq)[0], dtype=np.int32)
    for j in range(1, argmax.shape[0]):
        if abs(int(argmax[j]) - int(argmax[j - 1])) > 10:
            argmax[j] = argmax[j - 1]
    count = np.bincount(argmax[:mel_len])
    durations[:len(count)] = count[:len(count)]
    return durations
