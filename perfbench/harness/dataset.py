"""LJSpeech-like training items written in the layout the port's data
layer reads (`mel/`, `alg/`, `phon_pitch/`, `phon_energy/`, the text,
train and validation pickles and the attention scores): a copy of
chip_smoke.py's `_write_dataset` (its ranges, value scales and layout),
with the lengths taken as the stratified quantiles of the traffic's
ranges, so that every seed trains on the same set of sizes in another
order, and the values drawn in a few large draws."""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, Dict

import numpy as np

from perfbench.reference.frontend import SYMBOLS


def _quantile_ints(n: int, lo: int, hi: int) -> np.ndarray:
    """n integers spread evenly over [lo, hi] (the midpoints of n equal
    strata)."""
    return np.floor(lo + (hi - lo + 1) * (np.arange(n) + 0.5) / n
                    ).astype(np.int64)


def frame_lengths(traffic: Dict[str, Any]) -> np.ndarray:
    """The training items' mel lengths: per stratum [lo, hi, count] of
    `frames`, `count` lengths spread over [lo, hi]."""
    return np.concatenate([_quantile_ints(int(c), int(lo), int(hi))
                           for lo, hi, c in traffic['frames']])


def write_dataset(data: Path, traffic: Dict[str, Any], seed: int) -> None:
    train_frames = frame_lengths(traffic)
    n_train, n_val = len(train_frames), int(traffic['val_items'])
    n_all = n_train + n_val
    rng = np.random.default_rng(seed)
    phon = rng.permutation(_quantile_ints(n_all, *traffic['phonemes']))
    frames = np.concatenate([
        rng.permutation(train_frames),
        _quantile_ints(n_val, int(traffic['frames'][0][0]),
                       int(traffic['frames'][-1][1]))])
    for d in ('mel', 'alg', 'phon_pitch', 'phon_energy'):
        (data / d).mkdir(parents=True, exist_ok=True)
    # every value in a few large draws
    mels = rng.standard_normal((80, int(frames.sum())), dtype=np.float32)
    mels = mels * 2 - 5
    series = rng.standard_normal((2, int(phon.sum())), dtype=np.float32)
    symbols = rng.integers(1, len(SYMBOLS), int(phon.sum()))
    mel_at = np.concatenate([[0], np.cumsum(frames)])
    ph_at = np.concatenate([[0], np.cumsum(phon)])
    index, text_dict = [], {}
    for i in range(n_all):
        n, t = int(phon[i]), int(frames[i])
        a, b = int(ph_at[i]), int(ph_at[i + 1])
        dur = rng.multinomial(t - n, np.full(n, 1.0 / n)) + 1
        item = f'item_{i:04d}'
        np.save(data / 'mel' / f'{item}.npy',
                np.ascontiguousarray(mels[:, mel_at[i]:mel_at[i + 1]]))
        np.save(data / 'alg' / f'{item}.npy', dur.astype(np.int32))
        np.save(data / 'phon_pitch' / f'{item}.npy', series[0, a:b])
        np.save(data / 'phon_energy' / f'{item}.npy', series[1, a:b])
        text_dict[item] = ''.join(SYMBOLS[k] for k in symbols[a:b])
        index.append((item, t))
    for name, obj in (('text_dict', text_dict),
                      ('train_dataset', index[:n_train]),
                      ('val_dataset', index[n_train:]),
                      ('att_score_dict', {k: (1.0, 1.0) for k, _ in index})):
        with open(data / f'{name}.pkl', 'wb') as f:
            pickle.dump(obj, f)
