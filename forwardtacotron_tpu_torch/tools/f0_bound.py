"""Quantified deviation bound of the port's F0 tracker (`dsp/pitch.py`,
normalized autocorrelation) on the committed speech fixture
(tests/resources/golden_speech.wav), the JAX package's
`tools/f0_bound.py` run against the port's tracker on `--device`:

  1. TRUTH: the constructed contour (tests/resources/golden_f0.npy), the
     fixture being synthesized from a known F0;
  2. YIN: an independent float64 implementation of de Cheveigné &
     Kawahara (2002) (difference function -> cumulative mean normalized
     difference -> absolute threshold -> parabolic interpolation), numpy
     only and sharing no code with `dsp/pitch.py` (a copy of the JAX
     tool's).

Reported per pair: voiced/unvoiced decision agreement and cents RMSE over
commonly voiced frames, away from voicing transitions. The JAX tracker's
bound is pinned in PARITY.md and tests/test_dsp_golden.py.

    python -m forwardtacotron_tpu_torch.tools.f0_bound [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

RES = Path(__file__).resolve().parents[2] / 'tests' / 'resources'


def yin_f0(y: np.ndarray, sample_rate: int, hop_length: int,
           win_length: int = 1024, f0_floor: float = 71.0,
           f0_ceil: float = 800.0, threshold: float = 0.15) -> np.ndarray:
    """Frame-wise YIN in float64. Returns per-frame F0, 0 = unvoiced.

    Centered framing matching dsp/pitch.py's frame grid (reflect pad
    win//2, 1 + len//hop frames) so contours align index-for-index."""
    y = np.asarray(y, np.float64)
    pad = win_length // 2
    yp = np.pad(y, (pad, pad), mode='reflect')
    n_frames = 1 + len(y) // hop_length
    tau_min = max(int(sample_rate / f0_ceil), 2)
    tau_max = min(int(np.ceil(sample_rate / f0_floor)), win_length // 2)

    out = np.zeros(n_frames)
    for t in range(n_frames):
        frame = yp[t * hop_length: t * hop_length + win_length]
        if len(frame) < win_length:
            break
        w = win_length // 2
        x = frame
        # YIN difference function d(tau) = sum_{j<w} (x[j]-x[j+tau])^2
        # via the cross-correlation identity, with the cross term
        # restricted to the SAME w-sample window as the energy terms:
        # c(tau) = sum_{j<w} x[j] x[j+tau] = irfft(conj(X1) * X)[tau]
        n_fft = 2 * win_length
        x1 = np.zeros(win_length)
        x1[:w] = x[:w]
        cross = np.fft.irfft(np.conj(np.fft.rfft(x1, n_fft))
                             * np.fft.rfft(x, n_fft), n_fft)[:w + 1]
        csum = np.concatenate([[0.0], np.cumsum(x * x)])
        e0 = csum[w] - csum[0]
        e_tau = csum[np.arange(w + 1) + w] - csum[np.arange(w + 1)]
        d = e0 + e_tau - 2.0 * cross
        d = np.maximum(d, 0.0)
        # cumulative mean normalized difference
        cmndf = np.ones(w + 1)
        run = np.cumsum(d[1:])
        cmndf[1:] = d[1:] * np.arange(1, w + 1) / np.maximum(run, 1e-12)
        # absolute threshold: first tau in range dipping below
        tau = 0
        for k in range(tau_min, min(tau_max + 1, w)):
            if cmndf[k] < threshold:
                while k + 1 < w and cmndf[k + 1] < cmndf[k]:
                    k += 1
                tau = k
                break
        if tau == 0:
            # fallback: global minimum if it is convincing
            k = int(np.argmin(cmndf[tau_min:tau_max + 1])) + tau_min
            if cmndf[k] < 2 * threshold:
                tau = k
        if tau <= 0:
            continue
        # parabolic interpolation around tau
        if 1 <= tau < w - 1:
            a, b, c = d[tau - 1], d[tau], d[tau + 1]
            denom = a - 2 * b + c
            shift = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
            shift = float(np.clip(shift, -1.0, 1.0))
        else:
            shift = 0.0
        out[t] = sample_rate / (tau + shift)
    return out


def cents_rmse(f_a: np.ndarray, f_b: np.ndarray) -> float:
    cents = 1200.0 * np.log2(f_a / f_b)
    return float(np.sqrt(np.mean(cents ** 2)))


def compare(f_a: np.ndarray, f_b: np.ndarray, skip_edges: int = 2):
    """V/UV agreement + cents RMSE between two aligned contours,
    excluding frames within `skip_edges` of a voicing transition in
    either contour (windowed estimators are ill-defined there)."""
    n = min(len(f_a), len(f_b))
    f_a, f_b = f_a[:n], f_b[:n]
    va, vb = f_a > 0, f_b > 0
    stable = np.ones(n, bool)
    for v in (va, vb):
        for s in range(1, skip_edges + 1):
            stable &= (np.roll(v, s) == v) & (np.roll(v, -s) == v)
    agree = float(np.mean(va[stable] == vb[stable]))
    both = stable & va & vb
    rmse = cents_rmse(f_a[both], f_b[both]) if both.any() else float('nan')
    return {'vuv_agreement': round(agree, 4),
            'cents_rmse_voiced': round(rmse, 2),
            'n_frames': int(n), 'n_stable': int(stable.sum()),
            'n_both_voiced': int(both.sum())}


def run(device='cuda') -> Dict[str, Dict]:
    """The three comparisons of the module docstring, the port's tracker
    on `device` at the built-in config's (config.yaml's) DSP."""
    from forwardtacotron_tpu_torch import resolve_device
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.dsp.audio import DSP
    from forwardtacotron_tpu_torch.dsp.pitch import extract_pitch
    device = resolve_device(device)
    dsp = DSP.from_config(default_config(), device)
    y = dsp.load_wav(RES / 'golden_speech.wav')
    truth = np.load(RES / 'golden_f0.npy')
    nac = extract_pitch(y, dsp.sample_rate, dsp.hop_length, device=device)
    yin = yin_f0(np.asarray(y), dsp.sample_rate, dsp.hop_length)
    return {
        'nac_vs_truth': compare(nac, truth),
        'yin_vs_truth': compare(yin, truth),
        'nac_vs_yin': compare(nac, yin),
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict]:
    parser = argparse.ArgumentParser(
        description="F0 tracker bound against the fixture's contour and YIN")
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)
    out = run(args.device)
    print(json.dumps(out, indent=2))
    return out


if __name__ == '__main__':
    main()
