"""The reference's own training batches, read from the raw files the
benchmark wrote: for each item its tokens (the phoneme table's ids), mel,
durations, pitch and energy, padded to the batch's (Tx, Tm) shape as the
published collate pads them (text and series with 0, mel with
-11.5129)."""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, Sequence

import numpy as np
import torch

from perfbench.reference.frontend import SYMBOL_ID

MEL_PAD = -11.5129


def collate(data: Path, item_ids: Sequence[str], Tx: int, Tm: int,
            device) -> Dict[str, torch.Tensor]:
    with open(data / 'text_dict.pkl', 'rb') as f:
        text = pickle.load(f)
    B = len(item_ids)
    x = np.zeros((B, Tx), np.int64)
    mel = np.full((B, Tm, 80), MEL_PAD, np.float32)
    series = {k: np.zeros((B, Tx), np.float32)
              for k in ('dur', 'pitch', 'energy')}
    x_len = np.zeros(B, np.int64)
    mel_len = np.zeros(B, np.int64)
    for i, item in enumerate(item_ids):
        ids = [SYMBOL_ID[c] for c in text[item] if c in SYMBOL_ID]
        x[i, :len(ids)] = ids
        x_len[i] = len(ids)
        m = np.load(data / 'mel' / f'{item}.npy')
        mel[i, :m.shape[1]] = m.T
        mel_len[i] = m.shape[1]
        for key, sub in (('dur', 'alg'), ('pitch', 'phon_pitch'),
                         ('energy', 'phon_energy')):
            v = np.load(data / sub / f'{item}.npy')
            series[key][i, :len(v)] = v
    out = {'x': x, 'x_len': x_len, 'mel': mel, 'mel_len': mel_len, **series}
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def half(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The batch's first half of rows (a fault: half the batch left out)."""
    n = batch['x'].shape[0] // 2
    return {k: v[:n] for k, v in batch.items()}
