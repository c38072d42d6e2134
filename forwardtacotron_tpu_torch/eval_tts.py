"""Objective TTS evaluation over paired audio (or mel) directories.

    python -m forwardtacotron_tpu_torch.eval_tts --gen_dir out/ --ref_dir gt/
    python -m forwardtacotron_tpu_torch.eval_tts --gen_dir gta/ \\
        --ref_dir data/mel/ --mels
    ... --json report.json [--device cuda]

The counterpart of the JAX package's `tools/eval_tts.py`, with its flags
and output: files are paired by basename (`.wav` in audio mode, `.npy` in
`--mels` mode), each pair is scored by `evaluation.py` (MCD-DTW in dB; in
audio mode also F0 RMSE in Hz and cents over co-voiced frames and the
voicing decision error), a table goes to stderr and one JSON summary line
to stdout, and `--json` writes the per-file report. In audio mode the
mels and F0 are computed on `--device` (default `cuda`; `--device cpu`
runs the plain PyTorch DSP). Without `--config` the built-in config's
`dsp` section is used.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np


def _pairs(gen_dir: Path, ref_dir: Path, ext: str):
    gen = {p.stem: p for p in gen_dir.glob(f'*{ext}')}
    ref = {p.stem: p for p in ref_dir.glob(f'*{ext}')}
    common = sorted(set(gen) & set(ref))
    missing = sorted(set(gen) ^ set(ref))
    return [(name, ref[name], gen[name]) for name in common], missing


def _load_wav(path: Path, expect_sr: int) -> np.ndarray:
    from scipy.io import wavfile
    sr, wav = wavfile.read(str(path))
    if sr != expect_sr:
        raise ValueError(f'{path}: sample rate {sr} != config {expect_sr} '
                         '(resample first, e.g. through preprocess)')
    if wav.dtype == np.int16:
        wav = wav.astype(np.float32) / 32767.0
    elif wav.dtype == np.int32:
        wav = wav.astype(np.float32) / 2147483647.0
    else:
        wav = wav.astype(np.float32)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    return wav


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description='Objective TTS evaluation: MCD-DTW + F0 metrics')
    parser.add_argument('--gen_dir', required=True,
                        help='directory of synthesized .wav (or .npy mel)')
    parser.add_argument('--ref_dir', required=True,
                        help='directory of ground-truth .wav (or .npy mel)')
    parser.add_argument('--mels', action='store_true',
                        help='inputs are .npy log-mel spectrograms '
                             '((T, n_mels) or the reference (n_mels, T)) '
                             '- skips F0 metrics')
    parser.add_argument('--config', default=None,
                        help='YAML config for the DSP parameters in audio '
                             'mode (needs pyyaml; default: built-in config)')
    parser.add_argument('--n_mcc', type=int, default=13,
                        help='cepstral order for MCD (default 13)')
    parser.add_argument('--n_mels', type=int, default=80,
                        help='mel channel count for layout detection '
                             'in --mels mode (default 80)')
    parser.add_argument('--json', default=None,
                        help='write the full per-file report here')
    parser.add_argument('--limit', type=int, default=0,
                        help='evaluate at most N pairs (0 = all)')
    parser.add_argument('--device', default='cuda',
                        help='device of the mels and F0 in audio mode')
    args = parser.parse_args(argv)

    from forwardtacotron_tpu_torch import evaluation as ev

    gen_dir, ref_dir = Path(args.gen_dir), Path(args.ref_dir)
    ext = '.npy' if args.mels else '.wav'
    pairs, missing = _pairs(gen_dir, ref_dir, ext)
    if missing:
        print(f'# {len(missing)} unpaired file(s) skipped: '
              f'{", ".join(missing[:5])}{"..." if len(missing) > 5 else ""}',
              file=sys.stderr)
    if not pairs:
        print(f'no {ext} pairs found between {gen_dir} and {ref_dir}',
              file=sys.stderr)
        return 2
    if args.limit:
        pairs = pairs[:args.limit]

    dsp = None
    if not args.mels:
        from forwardtacotron_tpu_torch.config import (default_config,
                                                      read_config)
        from forwardtacotron_tpu_torch.dsp.audio import DSP
        config = read_config(args.config) if args.config \
            else default_config()
        dsp = DSP.from_config(config, args.device)

    per_file = {}
    for name, ref_path, gen_path in pairs:
        if args.mels:
            m = ev.eval_mel_pair(np.load(ref_path), np.load(gen_path),
                                 n_mcc=args.n_mcc, n_mels=args.n_mels)
        else:
            m = ev.eval_wav_pair(_load_wav(ref_path, dsp.sample_rate),
                                 _load_wav(gen_path, dsp.sample_rate),
                                 dsp, n_mcc=args.n_mcc)
        per_file[name] = m
        cols = f'mcd {m["mcd_db"]:7.3f} dB'
        if 'f0_rmse_hz' in m and np.isfinite(m['f0_rmse_hz']):
            cols += (f'  f0 {m["f0_rmse_hz"]:6.1f} Hz '
                     f'({m["f0_rmse_cents"]:6.1f} c)  vde {m["vde"]:.3f}')
        print(f'{name:24s} {cols}', file=sys.stderr)

    summary = ev.summarize(per_file)
    summary['n_files'] = len(per_file)
    if args.json:
        Path(args.json).write_text(json.dumps(
            {'summary': summary, 'per_file': per_file}, indent=2))
    print(json.dumps({'metric': 'mcd_db', 'value': summary['mcd_db'],
                      'unit': 'dB', 'extra': summary}))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
