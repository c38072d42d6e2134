"""A synthetic vocoder training set in the layout the port's data layer
reads after MOL preprocessing: `mel/<item>.npy` (n_mels, T) float32,
`quant/<item>.npy` the T * hop int64 16-bit linear labels of the audio,
and `train_dataset.pkl` / `val_dataset.pkl` of (item, T). The training
items' lengths are the stratified quantiles of the traffic's `frames`
(`harness/dataset.py:frame_lengths`), in an order drawn from the seed;
the validation items' lengths spread over the same range. Mels are
random (N(0, 1) x 2 - 5, as the student's dataset); the audio is
Gaussian of the traffic's `audio_std`, clipped to [-1, 1] and labelled
as `preprocess` labels it ((x + 1)(2^16 - 1) / 2, truncated)."""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, Dict

import numpy as np

from perfbench.harness.dataset import _quantile_ints, frame_lengths

LABEL_BITS = 16


def write_voc_dataset(data: Path, traffic: Dict[str, Any],
                      dsp: Dict[str, Any], seed: int) -> None:
    train_frames = frame_lengths(traffic)
    n_train, n_val = len(train_frames), int(traffic['val_items'])
    rng = np.random.default_rng(seed)
    frames = np.concatenate([
        rng.permutation(train_frames),
        _quantile_ints(n_val, int(traffic['frames'][0][0]),
                       int(traffic['frames'][-1][1]))])
    hop, n_mels = int(dsp['hop_length']), int(dsp['num_mels'])
    top = 2 ** LABEL_BITS - 1
    for d in ('mel', 'quant'):
        (data / d).mkdir(parents=True, exist_ok=True)
    index = []
    for i, t in enumerate(int(f) for f in frames):
        item = f'voc_{i:04d}'
        mel = rng.standard_normal((n_mels, t), dtype=np.float32) * 2 - 5
        wav = np.clip(rng.standard_normal(t * hop, dtype=np.float32)
                      * float(traffic['audio_std']), -1.0, 1.0)
        np.save(data / 'mel' / f'{item}.npy', mel)
        np.save(data / 'quant' / f'{item}.npy',
                ((wav + 1.0) * top / 2).astype(np.int64))
        index.append((item, t))
    for name, obj in (('train_dataset', index[:n_train]),
                      ('val_dataset', index[n_train:])):
        with open(data / f'{name}.pkl', 'wb') as f:
            pickle.dump(obj, f)
