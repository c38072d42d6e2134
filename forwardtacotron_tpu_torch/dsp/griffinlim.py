"""Griffin-Lim vocoding in PyTorch: mel -> linear magnitude (NNLS) ->
phase recovery.

Mirrors `forwardtacotron_tpu/dsp/griffinlim.py`: the mel is inverted by
FISTA (accelerated projected gradient for argmin_{S>=0} ||S A^T - M||^2,
step 1/L with L from 30 power iterations), then 32 Griffin-Lim
iterations with momentum 0.99 from a random initial phase. The initial
phase's uniform draw is an argument, so that one draw can go into both
packages; without it, a `torch.Generator` seeded with `seed` draws it on
the CPU (the same numbers on every device).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from forwardtacotron_tpu_torch.dsp.stft import istft, stft


def nnls_mel_inverse(mel_basis: torch.Tensor, mel: torch.Tensor,
                     n_iter: int = 200) -> torch.Tensor:
    """S >= 0 minimising ||S @ A^T - M|| for A (n_mels, n_freq) and M
    time-major (..., T, n_mels); returns (..., T, n_freq)."""
    A, M = mel_basis, mel
    v = torch.ones(A.shape[1], dtype=A.dtype, device=A.device)
    for _ in range(30):
        w = A.T @ (A @ v)
        v = w / (torch.linalg.vector_norm(w) + 1e-12)
    L = torch.dot(v, A.T @ (A @ v)) / (torch.dot(v, v) + 1e-12)
    step = 1.0 / (L + 1e-12)
    x = torch.clamp(M @ A, min=0.0)
    y, t = x, 1.0
    for _ in range(n_iter):
        grad = (y @ A.T - M) @ A
        x_new = torch.clamp(y - step * grad, min=0.0)
        t_new = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * t * t))
        y = x_new + ((t - 1.0) / t_new) * (x_new - x)
        x, t = x_new, t_new
    return x


def initial_phase(shape, seed: int) -> torch.Tensor:
    """The uniform [0, 1) draw of Griffin-Lim's initial phase, from a
    CPU `torch.Generator` seeded with `seed`."""
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed))


def griffinlim(spec_mag: torch.Tensor, n_fft: int, hop_length: int,
               win_length: int, n_iter: int = 32, momentum: float = 0.99,
               length: Optional[int] = None, seed: int = 0,
               uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Phase recovery of a time-major magnitude (..., T, n_freq) into a
    waveform (..., samples), on spec_mag's device. The initial phase is
    exp(2 pi i u) for `uniform` u, or for `initial_phase(shape, seed)`."""
    if uniform is None:
        uniform = initial_phase(spec_mag.shape, seed)
    angles = torch.exp(2j * math.pi * uniform.to(spec_mag.device,
                                                 torch.float32))
    rebuilt = torch.zeros_like(angles)
    for _ in range(n_iter):
        tprev = rebuilt
        inverse = istft(spec_mag * angles, n_fft, hop_length, win_length,
                        length=length)
        rebuilt = stft(inverse, n_fft, hop_length, win_length)
        angles = rebuilt - (momentum / (1 + momentum)) * tprev
        angles = angles / torch.clamp(torch.abs(angles), min=1e-16)
    return istft(spec_mag * angles, n_fft, hop_length, win_length,
                 length=length)


def mel_to_wav(mel: torch.Tensor, mel_basis: torch.Tensor, n_fft: int,
               hop_length: int, win_length: int, n_iter: int = 32,
               nnls_iter: int = 200, seed: int = 0,
               uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalised log-mel (..., T, n_mels) -> waveform (DSP.griffinlim of
    the reference, utils/dsp.py:89-103): exp, NNLS, Griffin-Lim."""
    lin = nnls_mel_inverse(mel_basis, torch.exp(mel), n_iter=nnls_iter)
    return griffinlim(lin, n_fft, hop_length, win_length, n_iter=n_iter,
                      seed=seed, uniform=uniform)
