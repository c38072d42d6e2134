"""STFT, inverse STFT and the mel filterbank in PyTorch.

Mirrors `forwardtacotron_tpu/dsp/stft.py`: centred reflect padding, a
periodic Hann window, a Slaney-normalised mel filterbank (computed in
numpy in float64, as there) and a time-major layout, (..., T, n_fft//2+1)
for spectra and (..., T, n_mels) for mels. The transforms are
`torch.fft.rfft`/`irfft` on whatever device the signal lies.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch.nn import functional as F


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic (fftbins=True) Hann window, as librosa and torch use."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(dtype)


_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel(f) -> np.ndarray:
    """Slaney mel scale (librosa htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    return np.where(f >= _MIN_LOG_HZ,
                    _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10)
                                          / _MIN_LOG_HZ) / _LOGSTEP,
                    f / _F_SP)


def _mel_to_hz(mels) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    return np.where(mels >= _MIN_LOG_MEL,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels - _MIN_LOG_MEL)),
                    _F_SP * mels)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                   fmin: float, fmax: Optional[float],
                   dtype=np.float32) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank (n_mels, 1 + n_fft//2),
    librosa.filters.mel(htk=False, norm=1)."""
    if fmax is None:
        fmax = sample_rate / 2
    fft_freqs = np.linspace(0, sample_rate / 2, 1 + n_fft // 2)
    hz_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                    n_mels + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.astype(dtype)


# the padded analysis windows made so far, by (win_length, n_fft, device)
_WINDOWS: Dict[tuple, torch.Tensor] = {}


def _window(win_length: int, n_fft: int, device) -> torch.Tensor:
    """The periodic Hann window centred in n_fft, made once a device: a
    step captured as a CUDA graph (the GAN step's mel loss) may copy
    nothing from the host."""
    key = (win_length, n_fft, str(device))
    w = _WINDOWS.get(key)
    if w is None:
        w = torch.as_tensor(hann_window(win_length), device=device)
        pad = (n_fft - win_length) // 2
        w = _WINDOWS[key] = F.pad(w, (pad, n_fft - win_length - pad))
    return w


def stft(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
         center: bool = True, pad_mode: str = 'reflect') -> torch.Tensor:
    """Complex STFT (..., n_frames, 1 + n_fft//2) of y (..., N)."""
    if center:
        lead = y.shape[:-1]
        y = F.pad(y.reshape(-1, 1, y.shape[-1]), (n_fft // 2, n_fft // 2),
                  mode=pad_mode).reshape(*lead, -1)
    frames = y.unfold(-1, n_fft, hop_length)          # (..., T, n_fft)
    return torch.fft.rfft(frames * _window(win_length, n_fft, y.device),
                          dim=-1)


def _overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """(B, T, n_fft) -> (B, n_fft + hop*(T-1)): frame t added at t*hop."""
    B, T, n_fft = frames.shape
    total = n_fft + hop_length * (T - 1)
    out = F.fold(frames.transpose(1, 2), output_size=(1, total),
                 kernel_size=(1, n_fft), stride=(1, hop_length))
    return out.reshape(B, total)


def istft(spec: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
          length: Optional[int] = None) -> torch.Tensor:
    """Inverse STFT of a time-major spectrum (..., n_frames, n_fft//2+1)
    by windowed overlap-add, normalised by the summed squared window
    (NOLA); `length` samples from n_fft//2 on (default: hop*(T-1))."""
    window = torch.as_tensor(hann_window(win_length), device=spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    T = frames.shape[-2]
    y = _overlap_add(frames.reshape(-1, T, n_fft), hop_length)
    wsum = _overlap_add(torch.square(window).expand(1, T, n_fft),
                        hop_length)
    y = (y / torch.clamp(wsum, min=1e-10)).reshape(*spec.shape[:-2], -1)
    total = y.shape[-1]
    if length is None:
        length = total - n_fft
    return y[..., n_fft // 2:n_fft // 2 + length]


def magnitude_stft(y: torch.Tensor, n_fft: int, hop_length: int,
                   win_length: int) -> torch.Tensor:
    return torch.abs(stft(y, n_fft, hop_length, win_length))


def wav_to_mel(y: torch.Tensor, mel_basis: torch.Tensor, n_fft: int,
               hop_length: int, win_length: int, normalize: bool = True,
               center: bool = True) -> torch.Tensor:
    """Log-mel (..., T, n_mels) of y (..., N): |STFT| -> mel_basis ->
    log(clip(1e-5)) (utils/dsp.py:71-87 of the reference). With
    `center=False` the caller has applied the reflect padding."""
    spec = torch.abs(stft(y, n_fft, hop_length, win_length, center=center))
    mel = spec @ mel_basis.T
    if normalize:
        mel = torch.log(torch.clamp(mel, min=1e-5))
    return mel
