"""Objective TTS evaluation: MCD-DTW, F0 RMSE / VDE and duration
accuracy.

A copy of the JAX package's `evaluation.py` (numpy on the host), whose
`eval_wav_pair` reads the mels and the F0 with the port's DSP
(`DSP.wav_to_mel_bucketed`, `dsp/pitch.extract_pitch_bucketed`) on the
DSP's device:

- **MCD (mel-cepstral distortion) with DTW alignment**: cepstra are a
  DCT over the log-mel channels; frames are aligned by dynamic time
  warping on cepstral euclidean distance, so free-running synthesis
  (whose timing differs from the recording) is compared fairly.
- **F0 RMSE** in Hz and cents over frames voiced in both signals, and
  the **voicing decision error** (VDE), aligned by the mel DTW path.
- **Duration accuracy** (frame-exact match rate and MAE) of predicted
  phoneme durations against forced-alignment targets.

The O(T*N) DTW dynamic program runs one vectorised pass a row, by a
cumulative-min decomposition (`dtw_path`). CLI: `eval_tts`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from forwardtacotron_tpu_torch.dsp.pitch import extract_pitch_bucketed

LOG10_FACTOR = 10.0 / np.log(10.0)


def dct_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Orthonormal DCT-II basis, shape (n_in, n_out): `log_mel @ dct`
    yields the first n_out cepstral coefficients per frame."""
    k = np.arange(n_out)[None, :]
    n = np.arange(n_in)[:, None]
    basis = np.cos(np.pi * (n + 0.5) * k / n_in)
    basis *= np.sqrt(2.0 / n_in)
    basis[:, 0] *= np.sqrt(0.5)
    return basis.astype(np.float32)


def mel_cepstra(log_mel: np.ndarray, n_mcc: int = 13) -> np.ndarray:
    """(T, n_mels) natural-log mel -> (T, n_mcc) cepstra (c0 included
    as column 0; MCD conventionally excludes it)."""
    log_mel = np.asarray(log_mel, np.float32)
    if log_mel.ndim != 2:
        raise ValueError(f'expected (T, n_mels), got {log_mel.shape}')
    return log_mel @ dct_matrix(log_mel.shape[1], n_mcc)


def _euclidean_cost(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise euclidean distances, (Ta, D) x (Tb, D) -> (Ta, Tb)."""
    sq = (np.sum(a * a, axis=1)[:, None] + np.sum(b * b, axis=1)[None, :]
          - 2.0 * (a @ b.T))
    return np.sqrt(np.maximum(sq, 0.0))


def dtw_path(cost: np.ndarray) -> np.ndarray:
    """Minimum-cost monotonic alignment through a (Ta, Tb) cost matrix
    with steps (down, right, diag); returns the path as (L, 2) index
    pairs from (0, 0) to (Ta-1, Tb-1).

    The row recurrence D[i,j] = c[i,j] + min(A[j], D[i,j-1]) with
    A[j] = min(D[i-1,j], D[i-1,j-1]) has a closed form over the row:
    D[i,j] = S[j] + cummin(A[k] - S[k-1]) where S is the row's cost
    prefix sum — so each row is one vectorized pass instead of a
    per-cell Python loop.
    """
    cost = np.asarray(cost, np.float64)
    ta, tb = cost.shape
    d = np.empty((ta, tb), np.float64)
    d[0] = np.cumsum(cost[0])
    for i in range(1, ta):
        prev = d[i - 1]
        a = np.minimum(prev, np.concatenate(([np.inf], prev[:-1])))
        s = np.cumsum(cost[i])
        s_km1 = np.concatenate(([0.0], s[:-1]))
        d[i] = s + np.minimum.accumulate(a - s_km1)

    i, j = ta - 1, tb - 1
    path = [(i, j)]
    while i > 0 or j > 0:
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            k = int(np.argmin((d[i - 1, j - 1], d[i - 1, j], d[i, j - 1])))
            if k == 0:
                i, j = i - 1, j - 1
            elif k == 1:
                i -= 1
            else:
                j -= 1
        path.append((i, j))
    return np.asarray(path[::-1], np.int64)


def mcd_dtw(log_mel_ref: np.ndarray, log_mel_syn: np.ndarray,
            n_mcc: int = 13,
            path: Optional[np.ndarray] = None
            ) -> Tuple[Dict[str, float], np.ndarray]:
    """Mel-cepstral distortion in dB between two natural-log mel
    spectrograms (time-major (T, n_mels)), DTW-aligned on cepstral
    distance. MCD = (10/ln10) * sqrt(2 * sum_d (delta mc_d)^2), mean
    over the alignment path, c0 (overall energy) excluded.

    Returns (metrics, path); pass `path` to reuse an alignment."""
    mc_ref = mel_cepstra(log_mel_ref, n_mcc)[:, 1:]
    mc_syn = mel_cepstra(log_mel_syn, n_mcc)[:, 1:]
    if path is None:
        path = dtw_path(_euclidean_cost(mc_ref, mc_syn))
    diff = mc_ref[path[:, 0]] - mc_syn[path[:, 1]]
    frame_mcd = LOG10_FACTOR * np.sqrt(
        2.0 * np.sum(diff * diff, axis=1))
    metrics = {
        'mcd_db': float(np.mean(frame_mcd)),
        'dtw_path_len': int(path.shape[0]),
        'frames_ref': int(mc_ref.shape[0]),
        'frames_syn': int(mc_syn.shape[0]),
    }
    return metrics, path


def f0_metrics(f0_ref: np.ndarray, f0_syn: np.ndarray,
               path: Optional[np.ndarray] = None) -> Dict[str, float]:
    """F0 comparison over an alignment path (frame pairs); 0 = unvoiced
    per the NAC tracker's convention (dsp/pitch.py). Without a path,
    frames are paired 1:1 up to the shorter length.

    - f0_rmse_hz / f0_rmse_cents: RMSE over frames voiced in BOTH
    - vde: fraction of frame pairs whose voicing decisions disagree
    - voiced_ref / voiced_syn: voicing rates (diagnostic)
    """
    f0_ref = np.asarray(f0_ref, np.float64).reshape(-1)
    f0_syn = np.asarray(f0_syn, np.float64).reshape(-1)
    if path is None:
        n = min(len(f0_ref), len(f0_syn))
        a, b = f0_ref[:n], f0_syn[:n]
    else:
        # the mel path may be longer than the f0 track by a frame or
        # two at the edges (different paddings upstream); clamp
        ia = np.clip(path[:, 0], 0, len(f0_ref) - 1)
        ib = np.clip(path[:, 1], 0, len(f0_syn) - 1)
        a, b = f0_ref[ia], f0_syn[ib]
    va, vb = a > 0, b > 0
    both = va & vb
    out = {
        'vde': float(np.mean(va != vb)) if len(a) else 0.0,
        'voiced_ref': float(np.mean(va)) if len(a) else 0.0,
        'voiced_syn': float(np.mean(vb)) if len(b) else 0.0,
        'co_voiced_frames': int(np.sum(both)),
    }
    if np.any(both):
        d_hz = a[both] - b[both]
        d_cents = 1200.0 * np.log2(a[both] / b[both])
        out['f0_rmse_hz'] = float(np.sqrt(np.mean(d_hz ** 2)))
        out['f0_rmse_cents'] = float(np.sqrt(np.mean(d_cents ** 2)))
    else:
        out['f0_rmse_hz'] = float('nan')
        out['f0_rmse_cents'] = float('nan')
    return out


def duration_metrics(dur_pred: np.ndarray, dur_target: np.ndarray
                     ) -> Dict[str, float]:
    """Per-phoneme duration accuracy: frame-exact match rate, MAE in
    frames, and total-length relative error (what the listener hears
    as speaking-rate error)."""
    p = np.asarray(dur_pred, np.float64).reshape(-1)
    t = np.asarray(dur_target, np.float64).reshape(-1)
    if p.shape != t.shape:
        raise ValueError(f'duration shapes differ: {p.shape} vs {t.shape}')
    pr, tr = np.rint(p), np.rint(t)
    total_t = max(float(np.sum(t)), 1e-9)
    return {
        'dur_exact_acc': float(np.mean(pr == tr)) if len(p) else 0.0,
        'dur_mae_frames': float(np.mean(np.abs(p - t))) if len(p) else 0.0,
        'dur_total_rel_err': float(abs(np.sum(p) - np.sum(t)) / total_t),
    }


def eval_mel_pair(log_mel_ref: np.ndarray, log_mel_syn: np.ndarray,
                  n_mcc: int = 13, n_mels: int = 80) -> Dict[str, float]:
    """MCD-DTW between two time-major natural-log mels; accepts the
    reference (n_mels, T) layout too (auto-transposed using the known
    channel count, falling back to a smaller-axis heuristic)."""
    log_mel_ref = _time_major(log_mel_ref, n_mels)
    log_mel_syn = _time_major(log_mel_syn, n_mels)
    if log_mel_ref.shape[1] != log_mel_syn.shape[1]:
        raise ValueError('mel channel counts differ: '
                         f'{log_mel_ref.shape} vs {log_mel_syn.shape}')
    metrics, _ = mcd_dtw(log_mel_ref, log_mel_syn, n_mcc)
    return metrics


def _time_major(mel: np.ndarray, n_mels: int = 80) -> np.ndarray:
    """Layout fix: mels are either (T, n_mels) or the reference's
    (n_mels, T); return time-major. The known channel count
    disambiguates short clips (T < n_mels); ambiguous squares pass
    through unchanged."""
    mel = np.asarray(mel, np.float32)
    if mel.ndim != 2:
        raise ValueError(f'expected 2-D mel, got {mel.shape}')
    if mel.shape[1] == n_mels:
        return mel
    if mel.shape[0] == n_mels:
        return mel.T
    return mel.T if mel.shape[0] < mel.shape[1] else mel


def eval_wav_pair(wav_ref: np.ndarray, wav_syn: np.ndarray, dsp,
                  n_mcc: int = 13) -> Dict[str, float]:
    """Full objective comparison of a synthesized waveform against a
    reference recording (both at dsp.sample_rate): MCD-DTW on mels plus
    F0 RMSE/VDE along the same alignment path, the mels and F0 computed
    on `dsp`'s device (the port's `dsp.audio.DSP`)."""
    mel_ref = dsp.wav_to_mel_bucketed(np.asarray(wav_ref, np.float32)).T
    mel_syn = dsp.wav_to_mel_bucketed(np.asarray(wav_syn, np.float32)).T
    metrics, path = mcd_dtw(mel_ref, mel_syn, n_mcc)
    f0_ref = extract_pitch_bucketed(wav_ref, dsp.sample_rate,
                                    dsp.hop_length, device=dsp.device)
    f0_syn = extract_pitch_bucketed(wav_syn, dsp.sample_rate,
                                    dsp.hop_length, device=dsp.device)
    metrics.update(f0_metrics(f0_ref, f0_syn, path))
    return metrics


def summarize(per_file: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    """Mean of each finite numeric metric across files."""
    keys = sorted({k for m in per_file.values() for k in m})
    out = {}
    for k in keys:
        vals = [m[k] for m in per_file.values()
                if k in m and np.isfinite(m[k])]
        if vals:
            out[k] = float(np.mean(vals))
    return out
