"""Dataset preprocessing CLI of the port.

    python -m forwardtacotron_tpu_torch.preprocess --path CORPUS \\
        [--num_workers N] [--config FILE] [--device cuda]

The contract follows the JAX package's root `preprocess.py` (the
reference's preprocess.py): for every wav of an LJSpeech-layout corpus
(`metadata.csv` with `id|...|text` lines) that the metadata indexes with
more than `min_text_len` characters of text, it writes the log-mel
(n_mels, T) to `data/mel`, the quantized waveform to `data/quant` and
the frame F0 to `data/raw_pitch`, cleans the text, and writes
`text_dict.pkl`, `train_dataset.pkl` and `val_dataset.pkl` with the same
seeded split (Random(seed) over the sorted items, the first `n_val` as
validation, sorted longest first). Host threads decode and trim the wavs
while the mel and the F0 run on `--device` (default `cuda`). A file that
fails to decode or to featurize is skipped with a log line. Without
`--config` the built-in copy of config.yaml is used. With
`--metadata_format multispeaker` the metadata lines are `id|speaker|text`
and `speaker_dict.pkl` ({item id: speaker id}, dense ids in sorted name
order, only the items written) goes beside the other pickles; the model
sections' `n_speakers` must then match it.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
from collections import deque
from pathlib import Path
from random import Random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from forwardtacotron_tpu_torch.config import default_config, read_config
from forwardtacotron_tpu_torch.dsp.audio import DSP
from forwardtacotron_tpu_torch.dsp.pitch import extract_pitch_bucketed
from forwardtacotron_tpu_torch.text.cleaners import Cleaner
from forwardtacotron_tpu_torch.text.recipes import ljspeech, multispeaker
from forwardtacotron_tpu_torch.utils.display import (progbar, simple_table,
                                                     stream)
from forwardtacotron_tpu_torch.utils.files import get_files, pickle_binary
from forwardtacotron_tpu_torch.utils.paths import Paths


def valid_n_workers(num: str) -> int:
    n = int(num)
    if n < 1:
        raise argparse.ArgumentTypeError(
            f'{num!r} must be an integer greater than 0')
    return n


def featurize(dsp: DSP, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                                np.ndarray]:
    """Trimmed wav -> (log-mel (n_mels, T), quantized wave, frame F0); the
    mel and the F0 on the DSP's device."""
    mel = dsp.wav_to_mel_bucketed(y)
    pitch = extract_pitch_bucketed(y, dsp.sample_rate, dsp.hop_length,
                                   device=dsp.device)
    if dsp.voc_mode == 'RAW':
        quant = dsp.encode_mu_law(y, mu=2 ** dsp.bits) if dsp.mu_law \
            else dsp.float_2_label(y, bits=dsp.bits)
    elif dsp.voc_mode == 'MOL':
        quant = dsp.float_2_label(y, bits=16)
    else:
        raise ValueError(f'Unexpected voc mode {dsp.voc_mode}, '
                         f'should be either RAW or MOL.')
    return (mel.astype(np.float32), np.asarray(quant).astype(np.int64),
            pitch.astype(np.float32))


def load_trimmed(dsp: DSP, path: Path) -> np.ndarray:
    """Read a wav, trim long silences and the ends as configured, and
    peak-normalise when configured or when the peak exceeds 1."""
    y = dsp.load_wav(path)
    if dsp.should_trim_long_silences:
        y = dsp.trim_long_silences(y)
    if dsp.should_trim_start_end_silence:
        y = dsp.trim_silence(y)
    peak = np.abs(y).max() if len(y) else 1.0
    if dsp.should_peak_norm or peak > 1.0:
        y = y / peak
    return y


def convert_file(dsp: DSP, path: Path) -> Tuple[np.ndarray, np.ndarray,
                                                np.ndarray]:
    """One file: load, trim, featurize."""
    return featurize(dsp, load_trimmed(dsp, path))


def _loaded(dsp: DSP, wav_files: List[Path], n_workers: int):
    """(path, trimmed wav) in file order, decoded by `n_workers` threads
    at most 2·n_workers files ahead; a file that fails to decode is
    skipped with a log line."""
    window = max(2 * n_workers, 2)
    pending: deque = deque()

    def drain(path, fut):
        try:
            return path, fut.result()
        except Exception as e:            # a corrupt file: skip, go on
            print(f'\nFailed to load {path}: {e}')
            return None

    with cf.ThreadPoolExecutor(max_workers=max(n_workers, 1)) as pool:
        for path in wav_files:
            pending.append((path, pool.submit(load_trimmed, dsp, path)))
            if len(pending) >= window:
                item = drain(*pending.popleft())
                if item is not None:
                    yield item
        while pending:
            item = drain(*pending.popleft())
            if item is not None:
                yield item


def process_all(paths: Paths, dsp: DSP, cleaner: Cleaner,
                text_dict: Dict[str, str], wav_files: List[Path],
                n_workers: int = 1) -> Tuple[list, list]:
    """Featurize every file and write its npys: host threads decode the
    next files while the device computes mel and F0 of this one. Returns
    ([(item id, mel frames)], [(item id, cleaned text)])."""
    dataset, cleaned_texts = [], []
    for i, (path, y) in enumerate(_loaded(dsp, wav_files, n_workers), 1):
        wav_id = path.stem
        if len(y) < dsp.hop_length:       # empty or silent after trimming
            print(f'\nSkipping {path}: too short after trimming '
                  f'({len(y)} samples)')
            continue
        try:
            mel, quant, pitch = featurize(dsp, y)
        except Exception as e:            # a corrupt file: skip, go on
            print(f'\nFailed to process {path}: {e}')
            continue
        np.save(paths.mel / f'{wav_id}.npy', mel, allow_pickle=False)
        np.save(paths.quant / f'{wav_id}.npy', quant, allow_pickle=False)
        np.save(paths.raw_pitch / f'{wav_id}.npy', pitch,
                allow_pickle=False)
        dataset.append((wav_id, mel.shape[-1]))
        cleaned_texts.append((wav_id, cleaner(text_dict[wav_id])))
        stream(f'{progbar(i, len(wav_files))} {i}/{len(wav_files)} ')
    return dataset, cleaned_texts


def split_dataset(dataset: List[tuple], seed: int, n_val: int
                  ) -> Tuple[List[tuple], List[tuple]]:
    """(train, val): the sorted items shuffled by Random(seed), the first
    `n_val` as validation, sorted longest first."""
    dataset = sorted(dataset)
    Random(seed).shuffle(dataset)
    val = sorted(dataset[:n_val], key=lambda d: -d[1])
    return dataset[n_val:], val


def main(argv: Optional[Sequence[str]] = None) -> Tuple[list, list]:
    parser = argparse.ArgumentParser(
        description='Preprocessing for WaveRNN and Tacotron (PyTorch)')
    parser.add_argument('--path', '-p', required=True,
                        help='directly point to dataset path')
    parser.add_argument('--num_workers', '-w', metavar='N',
                        type=valid_n_workers, default=1,
                        help='threads for wav decoding')
    parser.add_argument('--config', metavar='FILE', default=None,
                        help='YAML (needs pyyaml) or .json config '
                             '(default: built-in copy of config.yaml)')
    parser.add_argument('--metadata_format', default='ljspeech',
                        choices=['ljspeech', 'multispeaker'],
                        help='metadata csv layout: ljspeech '
                             '(id|...|text) or multispeaker '
                             '(id|speaker|text; also writes '
                             'speaker_dict.pkl)')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    config = read_config(args.config) if args.config else default_config()
    dsp = DSP.from_config(config, device=args.device)
    wav_files = get_files(args.path, '.wav')
    wav_ids = {w.stem for w in wav_files}
    paths = Paths(config['data_path'], config['tts_model_id'])
    print(f'\n{len(wav_files)} .wav files found in "{args.path}"')
    if not wav_files:
        raise SystemExit(f'Found no wav files in {args.path}, exiting.')

    speaker_dict = None
    if args.metadata_format == 'multispeaker':
        text_dict, speaker_dict = multispeaker(args.path)
    else:
        text_dict = ljspeech(args.path)
    min_len = config['preprocessing']['min_text_len']
    text_dict = {item_id: text for item_id, text in text_dict.items()
                 if item_id in wav_ids and len(text) > min_len}
    wav_files = [w for w in wav_files if w.stem in text_dict]
    print(f'Using {len(wav_files)} wav files that are indexed in '
          f'metafile.\n')
    cleaner = Cleaner.from_config(config)
    n_val = config['preprocessing']['n_val']
    simple_table([
        ('Sample Rate', dsp.sample_rate),
        ('Bit Depth', dsp.bits),
        ('Mu Law', dsp.mu_law),
        ('Hop Length', dsp.hop_length),
        ('Num Validation', n_val),
        ('Device', dsp.device),
    ])

    dataset, cleaned_texts = process_all(paths, dsp, cleaner, text_dict,
                                         wav_files,
                                         n_workers=args.num_workers)
    train_dataset, val_dataset = split_dataset(
        dataset, config['preprocessing'].get('seed', 42), n_val)
    if val_dataset:
        print(f'First val sample: {val_dataset[0][0]}')
    pickle_binary(dict(cleaned_texts), paths.data / 'text_dict.pkl')
    pickle_binary(train_dataset, paths.data / 'train_dataset.pkl')
    pickle_binary(val_dataset, paths.data / 'val_dataset.pkl')
    if speaker_dict is not None:
        used = {i for i, _ in cleaned_texts}
        speaker_dict = {i: s for i, s in speaker_dict.items() if i in used}
        pickle_binary(speaker_dict, paths.data / 'speaker_dict.pkl')
        n_spk = len(set(speaker_dict.values()))
        print(f'\n{n_spk} speakers -> speaker_dict.pkl; set '
              f'n_speakers: {n_spk} in the model config section.')
    print('\n\nCompleted. Ready to run "python -m forwardtacotron_tpu_torch.'
          'train_tacotron".\n')
    return train_dataset, val_dataset


if __name__ == '__main__':
    main()
