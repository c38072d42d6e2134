"""Audio helpers and the config-driven `DSP` facade.

Mirrors `forwardtacotron_tpu/dsp/audio.py`: the same constructor fields
(config['dsp']) and method names (load_wav / save_wav / wav_to_mel /
wav_to_mel_bucketed / wav_to_mel_batch / griffinlim / normalize /
denormalize / trim_silence / trim_long_silences / the quantizers). The
spectral work runs in PyTorch (`dsp/stft.py`, `dsp/griffinlim.py`) on the
DSP's `device`, which defaults to ``'cuda'``; wavs are read and written
through the port's C++ library (`utils/native_audio.py`), as the JAX
package does. Mels keep the reference layout (n_mels, T).
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict, Union

import numpy as np
import torch

from forwardtacotron_tpu_torch import resolve_device
from forwardtacotron_tpu_torch.dsp import griffinlim as _gl
from forwardtacotron_tpu_torch.dsp import stft as _stft
from forwardtacotron_tpu_torch.utils import native_audio


def label_2_float(x, bits: float):
    return 2 * x / (2 ** bits - 1.0) - 1.0


def float_2_label(x, bits: float):
    peak = float(abs(x).max())
    if peak > 1.0:
        raise ValueError(f'Expected waveform in [-1, 1], peak was {peak}')
    x = (x + 1.0) * (2 ** bits - 1) / 2
    return x.clip(0, 2 ** bits - 1)


def encode_mu_law(x, mu: float):
    """Mu-law labels of a numpy array or a torch tensor. A numpy array is
    divided by the float64 scalar np.log(1 + mu), so float32 input gives
    float64 labels, as the JAX package's numpy path (a float32 quotient
    floors differently on ~1 in 1e5 samples)."""
    mu = mu - 1
    if isinstance(x, torch.Tensor):
        fx = torch.sign(x) * torch.log(1 + mu * torch.abs(x)) \
            / math.log(1 + mu)
        return torch.floor((fx + 1) / 2 * mu + 0.5)
    fx = np.sign(x) * np.log(1 + mu * np.abs(x)) / np.log(1 + mu)
    return np.floor((fx + 1) / 2 * mu + 0.5)


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
    """Write int16 PCM as it is (e.g. `vocode(pcm16=True)`'s); float audio
    as 16-bit PCM through the native writer, clipped to [-1, 1] and
    rounded to nearest."""
    wav = np.asarray(wav)
    if wav.dtype == np.int16:
        from scipy.io import wavfile
        wavfile.write(str(path), sample_rate, wav)
        return
    native_audio.write_wav(path, wav.astype(np.float32), sample_rate)


class DSP:
    """Feature extraction and Griffin-Lim for one `dsp` config section."""

    def __init__(self, num_mels: int, sample_rate: int, hop_length: int,
                 win_length: int, n_fft: int, fmin: float, fmax: float,
                 peak_norm: bool, trim_start_end_silence: bool,
                 trim_silence_top_db: int, pitch_max_freq: int,
                 trim_long_silences: bool, vad_sample_rate: int,
                 vad_window_length: float, vad_moving_average_width: float,
                 vad_max_silence_length: int, bits: int, mu_law: bool,
                 voc_mode: str, device='cuda') -> None:
        self.n_mels = num_mels
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.win_length = win_length
        self.n_fft = n_fft
        self.fmin = fmin
        self.fmax = fmax
        self.should_peak_norm = peak_norm
        self.should_trim_start_end_silence = trim_start_end_silence
        self.should_trim_long_silences = trim_long_silences
        self.trim_silence_top_db = trim_silence_top_db
        self.pitch_max_freq = pitch_max_freq
        self.vad_sample_rate = vad_sample_rate
        self.vad_window_length = vad_window_length
        self.vad_moving_average_width = vad_moving_average_width
        self.vad_max_silence_length = vad_max_silence_length
        self.bits = bits
        self.mu_law = mu_law
        self.voc_mode = voc_mode
        self.device = resolve_device(device)
        self.mel_basis = _stft.mel_filterbank(sample_rate, n_fft, num_mels,
                                              fmin, fmax)
        self._mel_basis = torch.as_tensor(self.mel_basis, device=self.device)

    @classmethod
    def from_config(cls, config: Dict[str, Any], device='cuda') -> 'DSP':
        return cls(**config['dsp'], device=device)

    # ------------------------------------------------------------ file IO
    def load_wav(self, path: Union[str, Path]) -> np.ndarray:
        """Mono float32 at the DSP's sample rate (the native reader:
        integer PCM over 2^(bits-1), channels averaged, other rates
        resampled linearly); a format it refuses raises IOError."""
        wav, _ = native_audio.read_wav(path, target_sr=self.sample_rate)
        return wav

    def save_wav(self, wav: np.ndarray, path: Union[str, Path]) -> None:
        save_wav(wav, path, self.sample_rate)

    # ------------------------------------------------------------ compute
    def wav_to_mel(self, y: np.ndarray, normalize: bool = True,
                   center: bool = True) -> np.ndarray:
        """Log-mel of y (N,) as (n_mels, T), the reference layout; of a
        batch (B, N) as (B, T, n_mels). `center=False` expects y already
        reflect-padded by n_fft//2 on both sides."""
        y = torch.as_tensor(np.asarray(y, dtype=np.float32),
                            device=self.device)
        mel = _stft.wav_to_mel(y, self._mel_basis, self.n_fft,
                               self.hop_length, self.win_length,
                               normalize=normalize, center=center)
        mel = mel.cpu().numpy()
        return mel.T if mel.ndim == 2 else mel

    def wav_to_mel_bucketed(self, y: np.ndarray,
                            bucket_multiple: int = 16384) -> np.ndarray:
        """Log-mel (n_mels, T) of one utterance with the JAX package's
        shapes: centred reflect padding on the host, zeros up to a multiple
        of `bucket_multiple`, then the exact 1 + len(y)//hop frames, whose
        values equal `wav_to_mel`'s (the FFT sizes repeat across files)."""
        y = np.asarray(y, dtype=np.float32)
        true_frames = 1 + len(y) // self.hop_length
        pad = self.n_fft // 2
        y_p = np.pad(y, (pad, pad), mode='reflect')
        bucket = int(np.ceil(len(y_p) / bucket_multiple)) * bucket_multiple
        y_p = np.pad(y_p, (0, bucket - len(y_p)))
        return self.wav_to_mel(y_p, center=False)[:, :true_frames]

    def wav_to_mel_batch(self, y: torch.Tensor) -> torch.Tensor:
        """Log-mel of a batch (B, N) on the DSP's device, time-major
        (B, T, n_mels), as a tensor."""
        return _stft.wav_to_mel(y.to(self.device, torch.float32),
                                self._mel_basis, self.n_fft, self.hop_length,
                                self.win_length)

    def griffinlim(self, mel: np.ndarray, n_iter: int = 32,
                   seed: int = 0) -> np.ndarray:
        """Waveform (float32) of a normalised log-mel in (n_mels, T) or
        (T, n_mels) layout; the initial phase drawn from `seed`."""
        mel = np.asarray(mel, dtype=np.float32)
        if mel.shape[0] == self.n_mels and mel.shape[-1] != self.n_mels:
            mel = mel.T
        wav = _gl.mel_to_wav(torch.as_tensor(mel, device=self.device),
                             self._mel_basis, self.n_fft, self.hop_length,
                             self.win_length, n_iter=n_iter, seed=seed)
        return wav.cpu().numpy()

    def normalize(self, mel: np.ndarray) -> np.ndarray:
        return np.log(np.clip(mel, a_min=1e-5, a_max=None))

    def denormalize(self, mel: np.ndarray) -> np.ndarray:
        return np.exp(mel)

    # ----------------------------------------------------------- trimming
    def trim_silence(self, wav: np.ndarray) -> np.ndarray:
        """librosa.effects.trim (frame 2048, hop 512): drop the leading
        and trailing frames more than top_db below the peak RMS."""
        frame_length, hop = 2048, 512
        if len(wav) < frame_length:
            return wav
        n_frames = 1 + (len(wav) - frame_length) // hop
        idx = (np.arange(n_frames)[:, None] * hop
               + np.arange(frame_length)[None, :])
        rms = np.sqrt(np.mean(np.square(wav[idx]), axis=1))
        ref = np.max(rms)
        db = 20.0 * np.log10(np.maximum(rms, 1e-10) / max(ref, 1e-10))
        keep = np.where(db > -self.trim_silence_top_db)[0]
        if len(keep) == 0:
            return wav[:0]
        start = keep[0] * hop
        end = min(len(wav), (keep[-1] + 1) * hop + frame_length)
        return wav[start:end]

    def trim_long_silences(self, wav: np.ndarray) -> np.ndarray:
        """Cut silences longer than `vad_max_silence_length` windows
        (`dsp/vad.py`, numpy)."""
        from forwardtacotron_tpu_torch.dsp.vad import trim_long_silences
        return trim_long_silences(
            wav, sample_rate=self.sample_rate,
            vad_sample_rate=self.vad_sample_rate,
            window_length_ms=self.vad_window_length,
            moving_average_width=self.vad_moving_average_width,
            max_silence_length=self.vad_max_silence_length)

    # --------------------------------------------------------- quantizers
    label_2_float = staticmethod(label_2_float)
    float_2_label = staticmethod(float_2_label)
    encode_mu_law = staticmethod(encode_mu_law)
    decode_mu_law = staticmethod(decode_mu_law)
