"""The audio helpers the inference path needs: label <-> float, mu-law
decoding and writing a wav through `scipy.io.wavfile`."""
from __future__ import annotations

import math
from pathlib import Path
from typing import Union

import numpy as np
import torch


def label_2_float(x, bits: float):
    return 2 * x / (2 ** bits - 1.0) - 1.0


def decode_mu_law(y, mu: float, from_labels: bool = True):
    """Inverse mu-law of a numpy array or a torch tensor."""
    if from_labels:
        y = label_2_float(y, math.log2(mu))
    mu = mu - 1
    if isinstance(y, torch.Tensor):
        return torch.sign(y) / mu * ((1 + mu) ** torch.abs(y) - 1)
    return np.sign(y) / mu * ((1 + mu) ** np.abs(y) - 1)


def save_wav(wav: np.ndarray, path: Union[str, Path],
             sample_rate: int) -> None:
    """Write int16 PCM as it is; float audio is clipped to [-1, 1] and
    scaled to int16 first."""
    from scipy.io import wavfile
    wav = np.asarray(wav)
    if wav.dtype != np.int16:
        wav = (np.clip(wav.astype(np.float32), -1.0, 1.0)
               * 32767).astype(np.int16)
    wavfile.write(str(path), sample_rate, wav)
