"""Batched F0 estimation in PyTorch.

Mirrors `forwardtacotron_tpu/dsp/pitch.py`, the JAX package's stand-in
for WORLD's `dio`: a normalized-autocorrelation (NAC) pitch tracker over
every frame of the utterance at once, on whatever device the signal
lies:

1. frame the signal (one frame per hop; centred by reflect padding, or
   pre-padded by the caller with `center=False`);
2. per frame, the NAC by Wiener-Khinchin (`torch.fft.rfft` at n = 2·win,
   |.|², `irfft`), normalised by the frame's energy;
3. lags restricted to [sr/f0_ceil, sr/f0_floor] (71-800 Hz); among the
   local maxima within 13% of the best one the smallest lag wins
   (octave suppression), refined by a parabola through its neighbours;
4. unvoiced (0.0) where the peak NAC or the frame's RMS is low, then a
   median of 3 over frames.

The frame count is 1 + len(y)//hop, dio's count for the same hop.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F


def estimate_f0(y: torch.Tensor, sample_rate: int, hop_length: int,
                win_length: int = 1024, f0_floor: float = 71.0,
                f0_ceil: float = 800.0, nac_threshold: float = 0.35,
                energy_threshold: float = 1e-4,
                center: bool = True) -> torch.Tensor:
    """F0 per frame (..., n_frames) of y (..., N), float32; 0.0 for
    unvoiced frames. `center=False` expects input pre-padded by
    win_length//2 on both sides and gives 1 + (N - win_length)//hop
    frames."""
    min_lag = max(int(sample_rate / f0_ceil), 2)
    max_lag = min(int(np.ceil(sample_rate / f0_floor)), win_length - 2)
    y = y.float()
    if center:
        pad = win_length // 2
        lead = y.shape[:-1]
        y = F.pad(y.reshape(-1, 1, y.shape[-1]), (pad, pad),
                  mode='reflect').reshape(*lead, -1)
    frames = y.unfold(-1, win_length, hop_length)     # (..., T, win)
    frames = frames - frames.mean(dim=-1, keepdim=True)

    n_fft = 2 * win_length
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    ac = torch.fft.irfft(spec * spec.conj(), n=n_fft, dim=-1)
    ac = ac[..., :win_length]
    energy = ac[..., 0:1]
    nac = ac / torch.clamp(energy, min=1e-12)

    lags = torch.arange(win_length, device=y.device)
    valid = (lags >= min_lag) & (lags <= max_lag)
    nac_masked = torch.where(valid, nac, torch.full_like(nac, -1.0))
    peak_val = nac_masked.max(dim=-1).values

    # octave suppression: among the local maxima within 13% of the peak,
    # the smallest lag (a sine's NAC peaks equally at p, 2p, 3p)
    mid = nac_masked[..., 1:-1]
    no = torch.zeros_like(nac_masked[..., :1], dtype=torch.bool)
    is_local_max = torch.cat([no, (mid >= nac_masked[..., :-2])
                              & (mid >= nac_masked[..., 2:]), no], dim=-1)
    candidate = valid & is_local_max & \
        (nac_masked >= 0.87 * peak_val[..., None])
    first_candidate = torch.where(
        candidate, lags, torch.full_like(lags, win_length)).min(dim=-1).values
    best_lag = torch.where(candidate.any(dim=-1), first_candidate,
                           nac_masked.argmax(dim=-1))
    best_val = nac_masked.gather(-1, best_lag[..., None])[..., 0]

    # parabolic interpolation around the peak
    lag_m = torch.clamp(best_lag - 1, 0, win_length - 1)
    lag_p = torch.clamp(best_lag + 1, 0, win_length - 1)
    y0 = nac.gather(-1, lag_m[..., None])[..., 0]
    y2 = nac.gather(-1, lag_p[..., None])[..., 0]
    denom = y0 - 2 * best_val + y2
    big = denom.abs() > 1e-9
    delta = torch.where(big, 0.5 * (y0 - y2) / torch.where(
        big, denom, torch.ones_like(denom)), torch.zeros_like(denom))
    refined_lag = best_lag.float() + torch.clamp(delta, -0.5, 0.5)

    f0 = sample_rate / torch.clamp(refined_lag, min=1.0)
    rms = torch.sqrt(energy[..., 0] / win_length)
    voiced = (best_val > nac_threshold) & (rms > energy_threshold) & \
        (f0 >= f0_floor) & (f0 <= f0_ceil)
    f0 = torch.where(voiced, f0, torch.zeros_like(f0)).float()

    # median of 3 across frames removes single-frame outliers
    left = torch.cat([f0[..., :1], f0[..., :-1]], dim=-1)
    right = torch.cat([f0[..., 1:], f0[..., -1:]], dim=-1)
    return torch.stack([left, f0, right], dim=-1).median(dim=-1).values


def extract_pitch(y: np.ndarray, sample_rate: int, hop_length: int,
                  device='cuda') -> np.ndarray:
    """F0 of one utterance as numpy float32, computed on `device`."""
    y = torch.as_tensor(np.asarray(y, dtype=np.float32), device=device)
    return estimate_f0(y, sample_rate, hop_length).cpu().numpy()


def extract_pitch_bucketed(y: np.ndarray, sample_rate: int,
                           hop_length: int, win_length: int = 1024,
                           bucket_multiple: int = 16384,
                           device='cuda') -> np.ndarray:
    """F0 of one utterance with the JAX package's shapes: reflect padding
    on the host, zeros up to a multiple of `bucket_multiple`, then the
    first 1 + len(y)//hop frames (the last one's median sees the padded
    frame after it, as there)."""
    y = np.asarray(y, dtype=np.float32)
    true_frames = 1 + len(y) // hop_length
    pad = win_length // 2
    y_p = np.pad(y, (pad, pad), mode='reflect')
    bucket = int(np.ceil(len(y_p) / bucket_multiple)) * bucket_multiple
    y_p = np.pad(y_p, (0, bucket - len(y_p)))
    f0 = estimate_f0(torch.as_tensor(y_p, device=device), sample_rate,
                     hop_length, win_length=win_length, center=False)
    return f0[:true_frames].cpu().numpy()
