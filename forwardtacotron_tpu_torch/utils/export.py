"""A self-contained text -> mel / wav artifact (the JAX package's
`utils/export.py`, which writes StableHLO).

Each bucket (text length `tx`, mel frames `max_t`) is a non-strict
`torch.export.export` of the TTS model's `generate`, weights baked in, and
optionally a vocoder behind it, saved with `torch.export.save`. The
recurrences and the WaveRNN sampler are the custom ops
`ftt::birnn_recurrence` and `ftt::wavernn_sample` (`kernels/ops.py`) in
the exported graph, so the program runs kernels #1 and #4 on the card and
their plain versions on the CPU. Nothing is compiled ahead of time (no
Inductor): that would compile the plain versions, not the kernels.

The program's inputs are

    (x (1, tx) int64, x_len (1,) int64,
     alpha (), pitch_scale (), energy_scale () float32
     [, speaker (1,) int64: multi-speaker models]
     [, seed () int64: WaveRNN-fused artifacts])
    -> {'mel_post': (1, max_t, n_mels), 'mel_len': (1,), 'dur': (1, tx)
        [, 'wav': (1, total) int16, 'wav_len': (1,)]}

so one artifact serves every alpha / pitch / energy setting, voice and
seed. The file is `MAGIC`, a JSON meta header, then (tx, max_t, len,
blob) records, as the JAX package lays out its `FTTX2` files. Loading
(`ExportedTTS`) needs `forwardtacotron_tpu_torch.kernels` for the op
registrations and no model class. An artifact exported for CUDA refuses
to load without a GPU.
"""
from __future__ import annotations

import io
import json
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from forwardtacotron_tpu_torch import kernels  # noqa: F401  (the ops)

MAGIC = b'FTTPT1\n'
JAX_MAGICS = (b'FTTX1\n', b'FTTX2\n')   # the JAX package's StableHLO files


def _is_wavernn(voc_model) -> bool:
    return hasattr(voc_model, 'upsample_cond') \
        and hasattr(voc_model, 'sample_scan')


class PcmVocoder(nn.Module):
    """The tail of a text -> wav program: mel (B, max_t, n_mels) float32,
    mel_len (B,) and an int64 seed -> (int16 PCM (B, total), wav_len
    (B,)). A GAN generator's output is clipped to [-1, 1] and scaled by
    32767, wav_len = mel_len x the samples a frame; WaveRNN runs
    `vocode_program` (with the seed, in `compute_dtype`, on the device's
    fold) over wav_len = (mel_len - 1) x hop. The exported program and
    the fused server (`serving.py`) both end in it."""

    def __init__(self, vocoder: nn.Module, mu_law: bool = True,
                 compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.gan = self.vocode = None
        if _is_wavernn(vocoder):
            from forwardtacotron_tpu_torch.models.wavernn import (
                OVERLAP, vocode_program)
            self.hop = vocoder.hop_length
            self.vocode = vocode_program(vocoder, None, OVERLAP, mu_law,
                                         pcm16=True,
                                         compute_dtype=compute_dtype)
        else:
            self.gan = vocoder

    def forward(self, mel, mel_len, seed=None):
        if self.vocode is not None:
            wav_len = (mel_len - 1) * self.hop
            return self.vocode(mel, wav_len, seed), wav_len
        wav = self.gan(mel.transpose(1, 2))
        pcm = (torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)
        return pcm, mel_len * (wav.shape[-1] // mel.shape[1])


class GenerateProgram(nn.Module):
    """One bucket's program: `model.generate` at `max_t` frames, then
    `PcmVocoder` where a vocoder is given, returning the outputs of the
    module docstring."""

    def __init__(self, model: nn.Module, max_t: int,
                 vocoder: Optional[nn.Module] = None,
                 voc_mu_law: bool = True) -> None:
        super().__init__()
        self.model, self.max_t = model, int(max_t)
        self.pcm = None if vocoder is None \
            else PcmVocoder(vocoder, voc_mu_law)

    def forward(self, x, x_len, alpha, pitch_scale, energy_scale,
                speaker=None, seed=None):
        out = self.model.generate(x, self.max_t, alpha=alpha,
                                  pitch_scale=pitch_scale,
                                  energy_scale=energy_scale, x_len=x_len,
                                  compute_dtype=torch.float32,
                                  speaker=speaker)
        mel = out['mel_post'].float()
        result = {'mel_post': mel, 'mel_len': out['mel_len'],
                  'dur': out['dur']}
        if self.pcm is not None:
            result['wav'], result['wav_len'] = self.pcm(mel, out['mel_len'],
                                                        seed)
        return result


def _example(model: nn.Module, tx: int, device, wavernn: bool
             ) -> Tuple[tuple, Dict[str, torch.Tensor]]:
    args = (torch.ones((1, tx), dtype=torch.long, device=device),
            torch.full((1,), tx, dtype=torch.long, device=device),
            *(torch.ones((), device=device) for _ in range(3)))
    kwargs = {}
    if getattr(model, 'n_speakers', 1) > 1:
        kwargs['speaker'] = torch.zeros((1,), dtype=torch.long,
                                        device=device)
    if wavernn:
        kwargs['seed'] = torch.zeros((), dtype=torch.long, device=device)
    return args, kwargs


def export_tts_generate(model: nn.Module, tx: int, max_t: int,
                        vocoder: Optional[nn.Module] = None,
                        voc_mu_law: bool = True) -> bytes:
    """`torch.export.save` bytes of the program of text bucket `tx` and
    mel bucket `max_t` (the module docstring's signature), exported on the
    model's device, in float32 (the recurrences and the sampler, as the
    JAX export's float path). `vocoder`: None, a HiFi-GAN / MelGAN
    generator, or a WaveRNN (sampled with the runtime seed, mu-law as
    `voc_mu_law` says, on the device's fold:
    `models/wavernn.py:fold_target`)."""
    device = next(model.parameters()).device
    program = GenerateProgram(model, max_t, vocoder, voc_mu_law).eval()
    args, kwargs = _example(model, tx, device,
                            vocoder is not None and _is_wavernn(vocoder))
    with torch.no_grad():
        exported = torch.export.export(program, args, kwargs, strict=False)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def save_exported_tts(model: nn.Module, path: Union[str, Path],
                      buckets: Sequence[Tuple[int, int]] = ((64, 512),),
                      vocoder: Optional[nn.Module] = None,
                      voc_mu_law: bool = True) -> None:
    """Write a multi-bucket artifact:
    [MAGIC][meta_len][meta json][n][(tx, max_t, len, blob)*]. Each bucket
    is an independent exported program (`export_tts_generate`); the
    loader picks the smallest text bucket that fits the input. The meta
    records the optional inputs (speaker, seed), the vocoder and the
    device the programs were exported on."""
    device = next(model.parameters()).device
    meta = {
        'multispeaker': getattr(model, 'n_speakers', 1) > 1,
        'n_speakers': getattr(model, 'n_speakers', 1),
        'vocoder': (None if vocoder is None
                    else 'wavernn' if _is_wavernn(vocoder) else 'gan'),
        'device': device.type, 'torch': torch.__version__,
    }
    meta_bytes = json.dumps(meta).encode('utf-8')
    with open(path, 'wb') as f:
        f.write(MAGIC)
        f.write(np.int32(len(meta_bytes)).tobytes())
        f.write(meta_bytes)
        f.write(np.int32(len(buckets)).tobytes())
        for tx, max_t in buckets:
            blob = export_tts_generate(model, tx, max_t, vocoder,
                                       voc_mu_law)
            f.write(np.int32(tx).tobytes())
            f.write(np.int32(max_t).tobytes())
            f.write(np.int64(len(blob)).tobytes())
            f.write(blob)


class ExportedTTS:
    """Loads a saved artifact and synthesizes without the model code.
    The programs run on the device they were exported for: an artifact
    exported for CUDA raises on a machine without a GPU."""

    def __init__(self, path: Union[str, Path]) -> None:
        self.buckets: Dict[Tuple[int, int], Any] = {}
        with open(path, 'rb') as f:
            magic = f.read(len(MAGIC))
            if magic[:len(JAX_MAGICS[0])] in JAX_MAGICS:
                raise ValueError(
                    f'{path}: a JAX StableHLO artifact '
                    f'({magic[:5].decode()}, written by '
                    'forwardtacotron_tpu.utils.export); load it with the '
                    'JAX package, this loader reads torch.export '
                    'artifacts of forwardtacotron_tpu_torch')
            if magic != MAGIC:
                raise ValueError(f'{path}: not a ForwardTacotron-TPU '
                                 f'export artifact')
            meta_len = int(np.frombuffer(f.read(4), np.int32)[0])
            self.meta = json.loads(f.read(meta_len).decode('utf-8'))
            self.device = torch.device(self.meta['device'])
            if self.device.type == 'cuda' and not torch.cuda.is_available():
                raise RuntimeError(
                    f'{path} was exported for CUDA, and torch.cuda is not '
                    'available here; export it again with --device cpu '
                    'to run it on the CPU')
            n = int(np.frombuffer(f.read(4), np.int32)[0])
            for _ in range(n):
                tx = int(np.frombuffer(f.read(4), np.int32)[0])
                max_t = int(np.frombuffer(f.read(4), np.int32)[0])
                ln = int(np.frombuffer(f.read(8), np.int64)[0])
                program = torch.export.load(io.BytesIO(f.read(ln)))
                self.buckets[(tx, max_t)] = program.module()

    def _run(self, text_ids: Sequence[int], alpha: float,
             pitch_scale: float, energy_scale: float, speaker: int,
             seed: int = 0
             ) -> Tuple[Dict[str, np.ndarray], int, int]:
        """Pick the smallest exported text bucket that fits and call it.
        -> (outputs as numpy, x_len, max_t)."""
        x_len = len(text_ids)
        fitting = sorted(tx for tx, _ in self.buckets if tx >= x_len)
        if not fitting:
            raise ValueError(f'input length {x_len} exceeds all exported '
                             f'buckets {sorted(self.buckets)}')
        tx = fitting[0]
        max_t = max(mt for t, mt in self.buckets if t == tx)
        dev = self.device
        x = torch.zeros((1, tx), dtype=torch.long)
        x[0, :x_len] = torch.as_tensor(list(text_ids), dtype=torch.long)
        args = (x.to(dev), torch.tensor([x_len], device=dev),
                *(torch.tensor(float(v), device=dev)
                  for v in (alpha, pitch_scale, energy_scale)))
        kwargs = {}
        if self.meta.get('multispeaker'):
            n_spk = self.meta.get('n_speakers', 0)
            if n_spk and not 0 <= int(speaker) < n_spk:
                raise ValueError(f'speaker {speaker} out of range '
                                 f'for a {n_spk}-speaker artifact')
            kwargs['speaker'] = torch.tensor([int(speaker)], device=dev)
        if self.meta.get('vocoder') == 'wavernn':
            kwargs['seed'] = torch.tensor(int(seed), device=dev)
        with torch.no_grad():
            out = self.buckets[(tx, max_t)](*args, **kwargs)
        return {k: v.cpu().numpy() for k, v in out.items()}, x_len, max_t

    def generate(self, text_ids: Sequence[int], alpha: float = 1.0,
                 pitch_scale: float = 1.0, energy_scale: float = 1.0,
                 speaker: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """-> (mel_post (n_mels, mel_len), dur (x_len,)) from the smallest
        exported text bucket that fits. `speaker` selects the voice of a
        multi-speaker artifact (ignored otherwise)."""
        out, x_len, _ = self._run(text_ids, alpha, pitch_scale,
                                  energy_scale, speaker)
        mel_len = int(out['mel_len'][0])
        return out['mel_post'][0, :mel_len].T, out['dur'][0, :x_len]

    def synthesize(self, text_ids: Sequence[int], alpha: float = 1.0,
                   pitch_scale: float = 1.0, energy_scale: float = 1.0,
                   speaker: int = 0, seed: int = 0) -> np.ndarray:
        """Text -> int16 PCM of an artifact exported with a vocoder,
        trimmed to its length; raises without one. `seed` drives the
        WaveRNN sampler's noise (ignored by a GAN)."""
        out, _, _ = self._run(text_ids, alpha, pitch_scale, energy_scale,
                              speaker, seed=seed)
        if 'wav' not in out:
            raise ValueError('artifact was exported without a vocoder; '
                             'use .generate() for mels')
        return out['wav'][0, :int(out['wav_len'][0])]

    def synthesize_long(self, text: str, tokenize, alpha: float = 1.0,
                        pitch_scale: float = 1.0,
                        energy_scale: float = 1.0, speaker: int = 0,
                        seed: int = 0, sample_rate: int = 22050,
                        gap_ms: float = 120.0) -> np.ndarray:
        """Article-length synthesis: split on sentence boundaries
        (`text/segmenter.py`), synthesize each sentence within the
        exported buckets (sentence i with seed + i) and join them with
        `gap_ms` of silence. `tokenize` maps a sentence to token ids: the
        artifact holds no text front end."""
        from forwardtacotron_tpu_torch.text.segmenter import split_sentences
        sentences = split_sentences(text)
        if not sentences:
            raise ValueError('no synthesizable text')
        gap = np.zeros(int(sample_rate * gap_ms / 1000.0), np.int16)
        out: list = []
        for i, sent in enumerate(sentences):
            if i:
                out.append(gap)
            out.append(self.synthesize(
                tokenize(sent), alpha=alpha, pitch_scale=pitch_scale,
                energy_scale=energy_scale, speaker=speaker, seed=seed + i))
        return np.concatenate(out) if len(out) > 1 else out[0]
