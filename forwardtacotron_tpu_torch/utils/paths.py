"""Canonical on-disk layout of data and checkpoints.

A copy of the JAX package's `utils/paths.py` (the reference's
utils/paths.py:5-46), cut to what the port reads and writes: the data
sub-directories of preprocessing, alignment and training, and the
Tacotron and ForwardTacotron checkpoint directories, where the port
writes torch `.pt` files.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Union


class Paths:

    def __init__(self, data_path: str, tts_id: str,
                 base: Optional[Union[str, Path]] = None) -> None:
        """`base` holds checkpoints/ (default: $FTT_BASE when set, else
        the repository root)."""
        if base is None:
            base = os.environ.get('FTT_BASE') or None
        self.base = Path(base).expanduser().resolve() if base is not None \
            else Path(__file__).resolve().parent.parent.parent
        self.data = Path(data_path).expanduser().resolve()
        self.quant = self.data / 'quant'
        self.mel = self.data / 'mel'
        self.gta = self.data / 'gta'
        self.alg = self.data / 'alg'
        self.raw_pitch = self.data / 'raw_pitch'
        self.phon_pitch = self.data / 'phon_pitch'
        self.phon_energy = self.data / 'phon_energy'
        self.taco_checkpoints = (self.base / 'checkpoints'
                                 / f'{tts_id}.tacotron')
        self.forward_checkpoints = (self.base / 'checkpoints'
                                    / f'{tts_id}.forward')
        for p in (self.data, self.quant, self.mel, self.gta, self.alg,
                  self.raw_pitch, self.phon_pitch, self.phon_energy,
                  self.taco_checkpoints, self.forward_checkpoints):
            os.makedirs(p, exist_ok=True)
