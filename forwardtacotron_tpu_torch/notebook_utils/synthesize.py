"""One-class inference API: the import path and call shape of the JAX
package's `notebook_utils/synthesize.py` (the reference's notebook
helper) on the port.

    from forwardtacotron_tpu_torch.notebook_utils.synthesize import (
        Synthesizer)
    synth = Synthesizer('latest_model.pt', voc_path='voc.pt')
    wav = synth('Hello world.', voc_model='wavernn')

Checkpoints are `.pt` files or `.dcp` directories of this package, or
JAX `.fjax` files, loaded as `gen_forward` loads them (`load_tts`,
`load_voc`, and the GAN loaders of `load_vocoder`); `hifigan_path` takes
an official HiFi-GAN file or a `.fjax`, `melgan_path` a hub MelGAN file.
A call synthesizes as `gen_forward` does: `synthesize` (kernel #1 in every
recurrence) on a 16-token and 256-frame bucket, then Griffin-Lim, WaveRNN
through the folded `vocode` (kernel #4), or the GAN generator, and returns
the float32 waveform; 'melgan' or 'hifigan' with no generator loaded
returns the mel (n_mels, T) to feed an external vocoder. Everything runs
on `device` (default 'cuda'); `seed` seeds random weights where a path is
None, Griffin-Lim's phase and WaveRNN's sampling; `compute_dtype` is the
type of ForwardTacotron's recurrences and of the sampler (bfloat16, as
`gen_forward`; float32 for bit-parity work).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from forwardtacotron_tpu_torch.config import default_config
from forwardtacotron_tpu_torch.dsp.audio import DSP
from forwardtacotron_tpu_torch.gen_forward import (check_speaker, load_tts,
                                                   load_voc, synthesize,
                                                   text_to_ids)
from forwardtacotron_tpu_torch.models.hifigan import (load_hifigan,
                                                      vocode_generator)
from forwardtacotron_tpu_torch.models.melgan import load_melgan
from forwardtacotron_tpu_torch.models.wavernn import OVERLAP, vocode


class Synthesizer:

    def __init__(self, tts_path: Optional[str],
                 voc_path: Optional[str] = None,
                 hifigan_path: Optional[str] = None,
                 melgan_path: Optional[str] = None, device='cuda',
                 seed: int = 0,
                 compute_dtype: torch.dtype = torch.bfloat16) -> None:
        self.seed = int(seed)
        self.compute_dtype = compute_dtype
        self.tts_model, self.config, _ = load_tts(
            tts_path, default_config(), device, self.seed)
        self.voc_model, self.mu_law = None, True
        if voc_path is not None:
            self.voc_model, voc_config = load_voc(voc_path, self.config,
                                                  device, self.seed)
            self.mu_law = voc_config['dsp']['mu_law']
        self.hifigan_model = None if hifigan_path is None \
            else load_hifigan(hifigan_path, device=device)
        self.melgan_model = None if melgan_path is None \
            else load_melgan(melgan_path, device=device)
        self.dsp = DSP.from_config(self.config, device)

    def __call__(self, text: str, voc_model: str = 'griffinlim',
                 alpha: float = 1.0, pitch_scale: float = 1.0,
                 energy_scale: float = 1.0, speaker: int = 0) -> np.ndarray:
        error = check_speaker(self.tts_model, speaker)
        if error:
            raise ValueError(error)
        mel = synthesize(self.tts_model, text_to_ids(text, self.config),
                         alpha, pitch_scale, energy_scale=energy_scale,
                         compute_dtype=self.compute_dtype, speaker=speaker)
        if voc_model == 'griffinlim':
            return self.dsp.griffinlim(mel, n_iter=32, seed=self.seed)
        if voc_model == 'wavernn':
            assert self.voc_model is not None, 'no WaveRNN loaded'
            return vocode(self.voc_model, mel, target=None, overlap=OVERLAP,
                          mu_law=self.mu_law, seed=self.seed,
                          compute_dtype=self.compute_dtype)
        if voc_model == 'hifigan' and self.hifigan_model is not None:
            return vocode_generator(self.hifigan_model, mel)
        if voc_model == 'melgan' and self.melgan_model is not None:
            return vocode_generator(self.melgan_model, mel)
        return mel  # 'melgan'/'hifigan' w/o generator: export mel
