"""Canonical on-disk layout of data and checkpoints.

A copy of the JAX package's `utils/paths.py` (the reference's
utils/paths.py:5-46), cut to what the port reads and writes: the data
sub-directories of preprocessing, alignment and training, and the
checkpoint directories of the Tacotron teacher, the teacher-free aligner,
the ForwardTacotron student, and of WaveRNN and the GAN vocoders when a
vocoder id is given (each with its top-k directory), where the port writes
torch `.pt` files, and each one's `logs/` (TensorBoard event files and the
audio samples' wavs).
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Union


class Paths:

    def __init__(self, data_path: str, tts_id: str,
                 base: Optional[Union[str, Path]] = None,
                 voc_id: Optional[str] = None) -> None:
        """`base` holds checkpoints/ (default: $FTT_BASE when set, else
        the repository root); `voc_id` (config['voc_model_id']) names the
        vocoders' directories, which exist only when it is given."""
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
        checkpoints = self.base / 'checkpoints'
        self.taco_checkpoints = checkpoints / f'{tts_id}.tacotron'
        self.taco_top_k = self.taco_checkpoints / 'top_k_models'
        self.taco_log = self.taco_checkpoints / 'logs'
        self.forward_checkpoints = checkpoints / f'{tts_id}.forward'
        self.forward_top_k = self.forward_checkpoints / 'top_k_models'
        self.forward_log = self.forward_checkpoints / 'logs'
        self.aligner_checkpoints = checkpoints / f'{tts_id}.aligner'
        self.aligner_log = self.aligner_checkpoints / 'logs'
        dirs = [self.data, self.quant, self.mel, self.gta, self.alg,
                self.raw_pitch, self.phon_pitch, self.phon_energy,
                self.taco_checkpoints, self.taco_top_k, self.taco_log,
                self.forward_checkpoints, self.forward_top_k,
                self.forward_log, self.aligner_checkpoints,
                self.aligner_log]
        if voc_id is not None:
            self.voc_checkpoints = checkpoints / f'{voc_id}.wavernn'
            self.voc_top_k = self.voc_checkpoints / 'top_k_models'
            self.voc_log = self.voc_checkpoints / 'logs'
            self.hifigan_checkpoints = checkpoints / f'{voc_id}.hifigan'
            self.hifigan_top_k = self.hifigan_checkpoints / 'top_k_models'
            self.hifigan_log = self.hifigan_checkpoints / 'logs'
            dirs += [self.voc_checkpoints, self.voc_top_k, self.voc_log,
                     self.hifigan_checkpoints, self.hifigan_top_k,
                     self.hifigan_log]
        for p in dirs:
            os.makedirs(p, exist_ok=True)
