"""Streaming WaveRNN synthesis: audio chunks as fold groups finish.

Mirrors `forwardtacotron_tpu/models/streaming.py`: the upsampled
conditioning is folded as `generate_wav` folds it, but the fold lanes are
sampled in groups of `group` (one sampling-kernel launch each on the
card, seeded seed + g0), and each group's crossfaded audio is yielded as
soon as it is final. Every lane starts from zero state and the
crossfade mixes only neighbouring folds, so the concatenated chunks equal
`generate_wav`'s bookkeeping for the same per-fold samples.
"""
from __future__ import annotations

import wave
from pathlib import Path
from typing import Callable, Iterator, Optional, Union

import numpy as np
import torch
from torch.nn import functional as F

from forwardtacotron_tpu_torch.dsp.audio import decode_mu_law
from forwardtacotron_tpu_torch.kernels.wavernn_sample import (
    pack_weights, sample_conditioned, seed_tensor)
from forwardtacotron_tpu_torch.models.wavernn import (OVERLAP, _fades,
                                                      _time_major,
                                                      fold_target,
                                                      fold_with_overlap)


def stream_fold_groups(samples_by_group: Iterator[np.ndarray],
                       target: int, overlap: int) -> Iterator[np.ndarray]:
    """Crossfade-unfold groups of fold lanes into final audio chunks: the
    concatenation equals `xfade_and_unfold` of all lanes. After fold i
    only the samples before fold i+1's start are final, so `overlap`
    samples are carried from one chunk to the next."""
    fade_in, fade_out = _fades(overlap)
    stride = target + overlap
    carry = np.zeros(overlap, dtype=np.float64)
    for y in samples_by_group:
        y = y.astype(np.float64).copy()        # (G, target + 2*overlap)
        y[:, :overlap] *= fade_in
        y[:, -overlap:] *= fade_out
        g = y.shape[0]
        unfolded = np.zeros(g * stride + overlap, dtype=np.float64)
        for i in range(g):
            unfolded[i * stride:i * stride + target + 2 * overlap] += y[i]
        unfolded[:overlap] += carry
        carry = unfolded[-overlap:].copy()
        yield unfolded[:-overlap]
    yield carry


def write_wav_streaming(chunks: Iterator[np.ndarray],
                        path: Union[str, Path], sample_rate: int) -> int:
    """Write float chunks to a 16-bit PCM wav as they come (the `wave`
    module patches the RIFF sizes when the file closes); returns the
    number of samples written."""
    total = 0
    with wave.open(str(path), 'wb') as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        for chunk in chunks:
            pcm = (np.clip(chunk, -1.0, 1.0) * 32767).astype('<i2')
            w.writeframes(pcm.tobytes())
            total += len(pcm)
    return total


@torch.no_grad()
def stream_wav(model, mel, target: Optional[int] = None,
               overlap: int = OVERLAP, group: int = 8, mu_law: bool = True,
               seed: int = 0, sample_fn: Optional[Callable] = None,
               greedy: bool = False,
               compute_dtype: torch.dtype = torch.bfloat16
               ) -> Iterator[np.ndarray]:
    """Float64 audio chunks of one utterance (mel (n_mels, T) or
    (T, n_mels)), on the model's device up to the samples. `target=None`
    folds as `fold_target` says for that device.

    sample_fn(mels_f, aux_f, seed) -> (G, L) samples replaces the sampler
    (a test seam); by default each group goes through
    `sample_conditioned`, the sampling kernel on the card."""
    device = next(model.parameters()).device
    target = fold_target(target, device)
    mu_law = mu_law and model.mode == 'RAW'
    mel = torch.as_tensor(_time_major(model, mel), device=device)
    wave_len = (mel.shape[0] - 1) * model.hop_length
    mels_up, aux = model.upsample_cond(
        F.pad(mel[None], (0, 0, model.pad, model.pad)))
    mels_f = fold_with_overlap(mels_up, target, overlap)
    aux_f = fold_with_overlap(aux, target, overlap)
    if sample_fn is None:
        w = pack_weights(model, compute_dtype)   # once for every group

        def sample_fn(m, a, s):
            return sample_conditioned(model, m, a,
                                      seed=seed_tensor(s, device),
                                      greedy=greedy,
                                      compute_dtype=compute_dtype, w=w)

    def groups():
        for g0 in range(0, mels_f.shape[0], group):
            samples = sample_fn(mels_f[g0:g0 + group], aux_f[g0:g0 + group],
                                seed + g0)
            if isinstance(samples, torch.Tensor):
                samples = samples.cpu().numpy()
            samples = np.asarray(samples, dtype=np.float64)
            if mu_law:
                samples = decode_mu_law(samples, model.n_classes, False)
            yield samples

    emitted = 0
    fade_out = np.linspace(1, 0, 20 * model.hop_length)
    fade_start = wave_len - len(fade_out)
    for chunk in stream_fold_groups(groups(), target, overlap):
        # trim to the wave length, and the terminal fade as generate_wav
        start, emitted = emitted, emitted + len(chunk)
        if start >= wave_len:
            return
        chunk = chunk[:max(0, wave_len - start)].copy()
        lo = max(fade_start, start)
        if lo < start + len(chunk):
            chunk[lo - start:] *= fade_out[lo - fade_start:
                                           lo - fade_start + len(chunk)
                                           - (lo - start)]
        yield chunk
