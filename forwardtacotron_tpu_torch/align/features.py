"""Alignment features: teacher attention -> durations, per-phoneme pitch
and energy, ground-truth-aligned mels.

A port of the JAX package's `align/features.py` (the reference's
train_tacotron.py:23-175). `normalize_values`, `phoneme_pitch_energy` and
`extract_pitch_energy` are copies (numpy). `create_align_features` runs
the teacher in eval mode at r=1 under no_grad on the device that holds
it, so its BiGRUs take the inference kernel (#1) on the card; the
attention scores of a batch come from one call, the durations from the
host's dynamic program per utterance.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from forwardtacotron_tpu_torch.align.duration import (
    extract_durations_per_count, extract_durations_with_dp)
from forwardtacotron_tpu_torch.align.metrics import attention_score
from forwardtacotron_tpu_torch.utils.display import progbar, stream
from forwardtacotron_tpu_torch.utils.files import (pickle_binary,
                                                   unpickle_binary)
from forwardtacotron_tpu_torch.utils.paths import Paths


def normalize_values(phoneme_val: List[Tuple[str, np.ndarray]]
                     ) -> Tuple[float, float]:
    """Global z-normalization of the nonzero values, in place
    (train_tacotron.py:23-32)."""
    nonzeros = np.concatenate([v[np.where(v != 0.0)[0]]
                               for _, v in phoneme_val]) \
        if phoneme_val else np.zeros(1)
    if len(nonzeros) == 0:
        return 0.0, 1.0
    mean, std = float(np.mean(nonzeros)), float(np.std(nonzeros))
    std = std if std > 0 else 1.0
    for _, v in phoneme_val:
        zero_idxs = np.where(v == 0.0)[0]
        v -= mean
        v /= std
        v[zero_idxs] = 0.0
    return mean, std


def phoneme_pitch_energy(dur: np.ndarray, mel: np.ndarray,
                         pitch: np.ndarray, pitch_max_freq: float
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Frame pitch and energy averaged over each phoneme's span
    (train_tacotron.py:57-86). mel (n_mels, T); energy is the L2 norm of
    exp(mel) per frame."""
    mel_len = mel.shape[-1]
    energy = np.linalg.norm(np.exp(mel), axis=0, ord=2)
    durs_cum = np.cumsum(np.pad(dur, (1, 0)))
    pitch_char = np.zeros(dur.shape[0], dtype=np.float32)
    energy_char = np.zeros(dur.shape[0], dtype=np.float32)
    for idx in range(min(mel_len, len(dur))):
        a, b = int(durs_cum[idx]), int(durs_cum[idx + 1])
        values = pitch[a:b][np.where(pitch[a:b] != 0.0)[0]]
        values = values[np.where(values < pitch_max_freq)[0]]
        pitch_char[idx] = np.mean(values) if len(values) > 0 else 0.0
        energy_values = energy[a:b]
        energy_char[idx] = np.mean(energy_values) \
            if len(energy_values) > 0 else 0.0
    return pitch_char, energy_char


def extract_pitch_energy(paths: Paths, save_path_pitch: Path,
                         save_path_energy: Path,
                         pitch_max_freq: float) -> Tuple[float, float]:
    """Write every item's per-phoneme energy and normalised pitch from its
    durations, mel and frame F0; returns the pitch mean and std."""
    train_data = unpickle_binary(paths.data / 'train_dataset.pkl')
    val_data = unpickle_binary(paths.data / 'val_dataset.pkl')
    all_data = train_data + val_data

    phoneme_pitches, phoneme_energies = [], []
    for prog_idx, (item_id, mel_len) in enumerate(all_data, 1):
        dur = np.load(paths.alg / f'{item_id}.npy')
        mel = np.load(paths.mel / f'{item_id}.npy')
        pitch = np.load(paths.raw_pitch / f'{item_id}.npy')
        if np.sum(dur) != mel_len:
            print(f'WARNING: Sum of durations != mel length for '
                  f'{item_id} ({np.sum(dur)} vs {mel_len})')
        pitch_char, energy_char = phoneme_pitch_energy(
            dur, mel, pitch, pitch_max_freq)
        phoneme_pitches.append((item_id, pitch_char))
        phoneme_energies.append((item_id, energy_char))
        stream(f'{progbar(prog_idx, len(all_data))} '
               f'{prog_idx}/{len(all_data)} Files ')

    for item_id, phoneme_energy in phoneme_energies:
        np.save(str(save_path_energy / f'{item_id}.npy'), phoneme_energy,
                allow_pickle=False)
    mean, var = normalize_values(phoneme_pitches)
    for item_id, phoneme_pitch in phoneme_pitches:
        np.save(str(save_path_pitch / f'{item_id}.npy'), phoneme_pitch,
                allow_pickle=False)
    print(f'\nPitch mean: {mean} var: {var}')
    return mean, var


def _teacher_batches(model: torch.nn.Module, train_set, val_set, r: int):
    """(batch, (mel_out, linear, attention)) of the teacher-forced eval
    forward at reduction r over every batch, on the model's device, each
    conditioned on its batch's `speaker` where the corpus has them."""
    device = next(model.parameters()).device
    model.eval()
    for batcher in (train_set, val_set):
        for batch in batcher:
            x = torch.from_numpy(batch['x']).to(device)
            mel = torch.from_numpy(batch['mel']).to(device)
            spk = batch.get('speaker')
            if spk is not None:
                spk = torch.from_numpy(spk).to(device)
            with torch.no_grad():
                out = model(x, mel, r, speaker=spk)
            yield batch, out


def create_align_features(model: torch.nn.Module, train_set, val_set,
                          paths: Paths, config: Dict,
                          pitch_max_freq: float) -> None:
    """Run the teacher over the dataset and write each item's durations
    (`alg/`) and attention scores (`att_score_dict.pkl`), then the
    per-phoneme pitch and energy (train_tacotron.py:129-175)."""
    use_dijkstra = config['preprocessing'].get(
        'extract_durations_with_dijkstra', True)
    print('Extracting durations using '
          + ('dijkstra (dynamic program)...' if use_dijkstra
             else 'attention peak counts...'))
    att_score_dict = {}
    iters = len(train_set) + len(val_set)
    for i, (batch, (_, _, att)) in enumerate(
            _teacher_batches(model, train_set, val_set, r=1), 1):
        align_scores, sharp_scores = attention_score(
            att, torch.from_numpy(batch['mel_len']), r=1)
        att_np = att.cpu().numpy()
        align_scores, sharp_scores = (align_scores.cpu().numpy(),
                                      sharp_scores.cpu().numpy())
        for j in range(batch.get('n_real', att_np.shape[0])):
            item_id = batch['item_id'][j]
            mel_len = int(batch['mel_len'][j])
            x_len = int(batch['x_len'][j])
            att_j = att_np[j, :, :x_len]
            att_score_dict[item_id] = (float(align_scores[j]),
                                       float(sharp_scores[j]))
            if use_dijkstra:
                durs = extract_durations_with_dp(x_len, att_j, mel_len)
            else:
                durs = extract_durations_per_count(np.zeros(x_len), att_j,
                                                   mel_len)
            if np.sum(durs) != mel_len:
                print(f'WARNING: Sum of durations did not match mel '
                      f'length for item {item_id}!')
            np.save(str(paths.alg / f'{item_id}.npy'), durs,
                    allow_pickle=False)
        stream(f'{progbar(i, iters)} {i}/{iters} Batches ')

    pickle_binary(att_score_dict, paths.data / 'att_score_dict.pkl')
    print('Extracting Pitch Values...')
    extract_pitch_energy(paths, save_path_pitch=paths.phon_pitch,
                         save_path_energy=paths.phon_energy,
                         pitch_max_freq=pitch_max_freq)


def create_gta_features(model: torch.nn.Module, train_set, val_set,
                        save_path: Path, r: int = 1) -> None:
    """Write the teacher-forced postnet mels (n_mels, mel_len) of every
    item for vocoder training (train_tacotron.py:107-126)."""
    iters = len(train_set) + len(val_set)
    for i, (batch, (_, linear, _)) in enumerate(
            _teacher_batches(model, train_set, val_set, r), 1):
        gta = linear.cpu().numpy()
        for j in range(batch.get('n_real', gta.shape[0])):
            mel_len = int(batch['mel_len'][j])
            np.save(str(save_path / f'{batch["item_id"][j]}.npy'),
                    gta[j, :mel_len].T.astype(np.float32),
                    allow_pickle=False)
        stream(f'{progbar(i, iters)} {i}/{iters} Batches ')
