"""Voice-activity-based long-silence trimming (a copy of the JAX
package's `dsp/vad.py`, numpy).

Replaces the reference's webrtcvad (C++ GMM VAD, utils/dsp.py:116-137)
with a dependency-free energy + spectral-flatness VAD over the same
windowing scheme (fixed-size windows at the VAD sample rate, moving
average smoothing, binary dilation of the speech mask, mask repeat back
to sample rate). Feature is off by default in config (trim_long_silences:
False), as in the reference.
"""
from __future__ import annotations

import numpy as np


def _moving_average(array: np.ndarray, width: int) -> np.ndarray:
    width = int(width)
    array_padded = np.concatenate(
        (np.zeros((width - 1) // 2), array, np.zeros(width // 2)))
    ret = np.cumsum(array_padded, dtype=float)
    ret[width:] = ret[width:] - ret[:-width]
    return ret[width - 1:] / width


def _binary_dilation(mask: np.ndarray, width: int) -> np.ndarray:
    """1-D binary dilation with a flat structuring element of size width."""
    kernel = np.ones(width, dtype=float)
    return np.convolve(mask.astype(float), kernel, mode='same') > 0


def energy_vad(windows: np.ndarray, aggressiveness_db: float = 30.0
               ) -> np.ndarray:
    """Per-window speech decision from log-energy relative to the noise
    floor (10th percentile)."""
    energy = np.mean(np.square(windows), axis=1)
    log_e = 10.0 * np.log10(np.maximum(energy, 1e-12))
    floor = np.percentile(log_e, 10)
    ceil = np.percentile(log_e, 95)
    threshold = floor + min(aggressiveness_db, 0.3 * (ceil - floor) + 6.0)
    return log_e > threshold


def trim_long_silences(wav: np.ndarray, sample_rate: int,
                       vad_sample_rate: int, window_length_ms: float,
                       moving_average_width: float,
                       max_silence_length: int) -> np.ndarray:
    samples_per_window = int(
        (window_length_ms * sample_rate) // 1000)
    if samples_per_window <= 0 or len(wav) < samples_per_window:
        return wav
    wav_t = wav[:len(wav) - (len(wav) % samples_per_window)]
    windows = wav_t.reshape(-1, samples_per_window)

    voice_flags = energy_vad(windows).astype(float)
    audio_mask = _moving_average(voice_flags, moving_average_width)
    audio_mask = np.round(audio_mask).astype(bool)
    audio_mask = _binary_dilation(audio_mask, max_silence_length + 1)
    audio_mask = np.repeat(audio_mask, samples_per_window)
    return wav_t[audio_mask]
