"""Datasets, collation and length-bucketed batching of the TTS models.

A copy of the TTS parts of the JAX package's `data/dataset.py` (the
reference's utils/dataset.py field contracts and collate_tts padding):
`TacoDataset` (the Tacotron teacher's items: text and mel),
`ForwardDataset` (the student's: also durations, pitch and energy; both
add an int `speaker` to each item when given a multi-speaker corpus's
`speaker_dict`), the
max-length and attention filters, `collate_tts` (mels padded to a
multiple of r), `BucketBatcher`, `get_tts_datasets` and `Prefetcher`;
and the vocoders' parts, `VocoderDataset`, the `VocCollator` and
`GANVocCollator` crops, `VocBatcher`, `get_vocoder_datasets` and
`get_gan_vocoder_datasets`. Items are grouped by mel length into a
ladder of padded (T_text, T_mel) shapes; the batch plan of an epoch is a
pure function of (seed, epoch), so a resumed run replays the data order
of an uninterrupted one. The TTS batches' padded mel block and WaveRNN's
windows are read by the port's C++ loader (`data/native_loader.py`); a
batch with a file the loader refuses, or every batch under
`FTT_NATIVE_LOADER=0`, is assembled by numpy with the same output.
Batches are numpy; the trainer moves them to its device. Mels are stored
on disk as (n_mels, T) and come out time-major.
"""
from __future__ import annotations

import os
import queue
import random
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from forwardtacotron_tpu_torch.data import native_loader
from forwardtacotron_tpu_torch.dsp.audio import decode_mu_law, label_2_float
from forwardtacotron_tpu_torch.text.tokenizer import Tokenizer
from forwardtacotron_tpu_torch.utils.files import unpickle_binary
from forwardtacotron_tpu_torch.utils.profiling import annotate

MEL_PAD = -11.5129


def native_enabled() -> bool:
    """False under `FTT_NATIVE_LOADER=0`, which sends every batch through
    numpy."""
    return os.environ.get('FTT_NATIVE_LOADER') != '0'


def filter_max_len(dataset: List[tuple], max_mel_len: Optional[int]
                   ) -> List[tuple]:
    if max_mel_len is None:
        return dataset
    return [(i, l) for i, l in dataset if l <= max_mel_len]


def filter_bad_attentions(dataset: List[tuple],
                          attention_score_dict: Dict[str, tuple],
                          min_alignment: float,
                          min_sharpness: float) -> List[tuple]:
    out = []
    for item_id, mel_len in dataset:
        align_score, sharp_score = attention_score_dict[item_id]
        if align_score > min_alignment and sharp_score > min_sharpness:
            out.append((item_id, mel_len))
    return out


class TacoDataset:

    def __init__(self, path: Path, dataset_ids: Sequence[str],
                 text_dict: Dict[str, str], tokenizer: Tokenizer,
                 speaker_dict: Optional[Dict[str, int]] = None) -> None:
        self.path = Path(path)
        self.metadata = list(dataset_ids)
        self.text_dict = text_dict
        self.tokenizer = tokenizer
        self.speaker_dict = speaker_dict
        self._light_cache: Dict[int, Dict] = {}

    def _with_speaker(self, item: Dict) -> Dict:
        """`item` with its int `speaker` (0 for an id the dict lacks) when
        the corpus has a speaker_dict; unchanged otherwise."""
        if self.speaker_dict is not None:
            item['speaker'] = int(self.speaker_dict.get(item['item_id'], 0))
        return item

    def __getitem__(self, index: int) -> Dict:
        item_id = self.metadata[index]
        x = self.tokenizer(self.text_dict[item_id])
        mel = np.load(str(self.path / 'mel' / f'{item_id}.npy'))
        return self._with_speaker({
            'x': np.asarray(x, dtype=np.int64), 'mel': mel,
            'item_id': item_id, 'mel_len': mel.shape[-1], 'x_len': len(x)})

    def _light(self, item_id: str) -> Dict:
        x = self.tokenizer(self.text_dict[item_id])
        return {'x': np.asarray(x, dtype=np.int64), 'item_id': item_id,
                'x_len': len(x)}

    def light_item(self, index: int) -> Dict:
        """Everything of the item but its mel (the native loader reads
        the mels straight into the batch); cached, as epochs revisit every
        item."""
        cached = self._light_cache.get(index)
        if cached is None:
            cached = self._with_speaker(self._light(self.metadata[index]))
            self._light_cache[index] = cached
        return cached

    def __len__(self) -> int:
        return len(self.metadata)


class ForwardDataset(TacoDataset):

    def __getitem__(self, index: int) -> Dict:
        item_id = self.metadata[index]
        x = self.tokenizer(self.text_dict[item_id])
        mel = np.load(str(self.path / 'mel' / f'{item_id}.npy'))
        dur = np.load(str(self.path / 'alg' / f'{item_id}.npy'))
        pitch = np.load(str(self.path / 'phon_pitch' / f'{item_id}.npy'))
        energy = np.load(str(self.path / 'phon_energy' / f'{item_id}.npy'))
        return self._with_speaker({
            'x': np.asarray(x, dtype=np.int64), 'mel': mel,
            'item_id': item_id, 'x_len': len(x), 'mel_len': mel.shape[-1],
            'dur': dur, 'pitch': pitch, 'energy': energy})

    def _light(self, item_id: str) -> Dict:
        out = super()._light(item_id)
        for key, sub in (('dur', 'alg'), ('pitch', 'phon_pitch'),
                         ('energy', 'phon_energy')):
            out[key] = np.load(str(self.path / sub / f'{item_id}.npy'))
        return out


def pad1d(x, max_len: int) -> np.ndarray:
    return np.pad(x, (0, max_len - len(x)), mode='constant')


def pad2d(x, max_len: int) -> np.ndarray:
    return np.pad(x, ((0, 0), (0, max_len - x.shape[-1])),
                  constant_values=MEL_PAD, mode='constant')


def collate_tts(batch: List[Dict], r: int,
                pad_to: Optional[Tuple[int, int]] = None,
                mel: Optional[Tuple[np.ndarray, np.ndarray]] = None) -> Dict:
    """Pad and stack a list of items: text zero-padded, mel padded with
    -11.5129 to max_len+1 rounded up to a multiple of r (the reference's
    collate_tts). `pad_to` forces static (T_text, T_mel) bucket shapes
    (both still r-rounded). Mel is returned time-major (B, T, n_mels);
    items with a `speaker` give a (B,) int32 `speaker`. `mel`, the padded
    block and its lengths already read (the native loader's), stands in
    for the items' mels, which they then need not carry."""
    x_len = np.asarray([b['x_len'] for b in batch], dtype=np.int64)
    max_x_len = int(x_len.max()) if pad_to is None else pad_to[0]
    text = np.stack([pad1d(b['x'], max_x_len) for b in batch]
                    ).astype(np.int64)
    if mel is None:
        mel_lens = np.asarray([b['mel_len'] for b in batch], dtype=np.int64)
        max_spec_len = (int(mel_lens.max()) + 1) if pad_to is None \
            else pad_to[1]
        mel = np.stack([pad2d(b['mel'], _round_up(max_spec_len, r))
                        for b in batch]).transpose(0, 2, 1).astype(np.float32)
    else:
        mel, mel_lens = mel

    out = {'x': text, 'mel': mel,
           'item_id': [b['item_id'] for b in batch],
           'x_len': x_len, 'mel_len': mel_lens}
    for key in ('dur', 'pitch', 'energy'):
        if key in batch[0]:
            out[key] = np.stack(
                [pad1d(b[key][:max_x_len], max_x_len) for b in batch]
            ).astype(np.float32)
    if 'speaker' in batch[0]:
        out['speaker'] = np.asarray([b['speaker'] for b in batch],
                                    dtype=np.int32)
    return out


def _epoch_seed(seed: int, epoch: int, batch: int = -1) -> int:
    """Deterministic per-(epoch[, batch]) RNG seed, stable across
    processes (plain integer mixing, no hash())."""
    v = (seed * 1_000_003 + epoch) * 1_000_003 + (batch + 1)
    return v % (2 ** 31 - 1)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class BucketBatcher:
    """Length-bucketed batch iterator with static padded shapes.

    Items are assigned to buckets by mel length (a ladder of multiples of
    `mel_multiple`); each bucket's text pad is the bucket's own max,
    rounded to `x_multiple`. Batches within a bucket have one shape and
    are shuffled across and within buckets. Incomplete tail batches are
    padded by repeating items, with `n_real` counting the genuine rows.
    The padded mel block comes from the native loader (`_make_batch`).
    """

    def __init__(self, dataset, batch_size: int, r: int = 1,
                 mel_multiple: int = 128, x_multiple: int = 16,
                 seed: int = 42, shuffle: bool = True) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.r = r
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0  # next epoch yielded by plain iter()
        self._n_mels: Optional[int] = None

        self.buckets: Dict[int, List[int]] = {}
        self.x_pad: Dict[int, int] = {}
        for idx in range(len(dataset)):
            item_id = dataset.metadata[idx]
            mel = np.load(str(dataset.path / 'mel' / f'{item_id}.npy'),
                          mmap_mode='r')
            x_len = len(dataset.tokenizer(dataset.text_dict[item_id]))
            b = _round_up(mel.shape[-1] + 1, mel_multiple)
            self.buckets.setdefault(b, []).append(idx)
            self.x_pad[b] = max(self.x_pad.get(b, 1), x_len)
        for b in self.x_pad:
            self.x_pad[b] = _round_up(self.x_pad[b], x_multiple)

    def __len__(self) -> int:
        return sum((len(idxs) + self.batch_size - 1) // self.batch_size
                   for idxs in self.buckets.values())

    def first_batch(self) -> Optional[Dict]:
        """The smallest bucket's first `batch_size` items as one batch,
        padded as every batch is (the trainers' plotting sample); None
        without items."""
        if not self.buckets:
            return None
        b = min(self.buckets)
        return self._make_batch(b, self.buckets[b][:self.batch_size])

    def _make_batch(self, bucket: int, idxs: List[int]) -> Dict:
        n_real = len(idxs)
        while len(idxs) < self.batch_size:
            idxs = idxs + idxs[:self.batch_size - len(idxs)]
        idxs = idxs[:self.batch_size]
        batch = self._make_batch_native(bucket, idxs)
        if batch is None:
            batch = collate_tts([self.dataset[i] for i in idxs], self.r,
                                pad_to=(self.x_pad[bucket], bucket))
        batch['n_real'] = n_real
        return batch

    def _make_batch_native(self, bucket: int,
                           idxs: List[int]) -> Optional[Dict]:
        """`collate_tts`'s batch of the padded mel block read by the native
        loader and the datasets' `light_item`s; None when a file fails the
        loader's validation or under `FTT_NATIVE_LOADER=0`."""
        if not native_enabled():
            return None
        ds = self.dataset
        paths = [ds.path / 'mel' / f'{ds.metadata[i]}.npy' for i in idxs]
        if self._n_mels is None:
            self._n_mels = int(np.load(str(paths[0]),
                                       mmap_mode='r').shape[0])
        max_spec = _round_up(bucket, self.r)
        loaded = native_loader.load_mel_batch(paths, max_spec, self._n_mels,
                                              MEL_PAD)
        if loaded is None:
            return None
        return collate_tts([ds.light_item(i) for i in idxs], self.r,
                           pad_to=(self.x_pad[bucket], bucket), mel=loaded)

    def epoch_plan(self, epoch: int) -> List[tuple]:
        """The batch plan of one epoch as a pure function of (seed,
        epoch): [(bucket, [item idx, ...]), ...]."""
        rng = random.Random(_epoch_seed(self.seed, epoch))
        plan = []
        for bucket, idxs in self.buckets.items():
            idxs = list(idxs)
            if self.shuffle:
                rng.shuffle(idxs)
            for i in range(0, len(idxs), self.batch_size):
                plan.append((bucket, idxs[i:i + self.batch_size]))
        if self.shuffle:
            rng.shuffle(plan)
        return plan

    def batches(self, epoch: int, start: int = 0):
        """Yield epoch `epoch`'s batches from position `start` (the
        mid-epoch resume entry point of the trainer)."""
        for bucket, chunk in self.epoch_plan(epoch)[start:]:
            yield self._make_batch(bucket, chunk)

    def __iter__(self):
        epoch, self._epoch = self._epoch, self._epoch + 1
        return self.batches(epoch)


def get_tts_datasets(path: Path, batch_size: int, r: int,
                     max_mel_len: Optional[int],
                     filter_attention: bool = True,
                     filter_min_alignment: float = 0.5,
                     filter_min_sharpness: float = 0.9,
                     model_type: str = 'forward',
                     mel_multiple: int = 128
                     ) -> Tuple[BucketBatcher, BucketBatcher]:
    """(train, val) BucketBatchers of the Tacotron teacher
    (`model_type='tacotron'`) or the forward model (the reference's
    get_tts_datasets); the attention filter applies to the forward model
    only. A `speaker_dict.pkl` beside the indexes (a multi-speaker corpus)
    gives every batch a (B,) int32 `speaker`."""
    if model_type not in ('tacotron', 'forward'):
        raise ValueError(f'Unknown model: {model_type}, must be either '
                         '[tacotron, forward]!')
    path = Path(path)
    spk_path = path / 'speaker_dict.pkl'
    speaker_dict = unpickle_binary(spk_path) if spk_path.exists() else None
    tokenizer = Tokenizer()
    train_data = unpickle_binary(path / 'train_dataset.pkl')
    val_data = unpickle_binary(path / 'val_dataset.pkl')
    text_dict = unpickle_binary(path / 'text_dict.pkl')

    train_data = filter_max_len(train_data, max_mel_len)
    val_data = filter_max_len(val_data, max_mel_len)
    train_len_original = len(train_data)
    if model_type == 'forward' and filter_attention:
        att_score_dict = unpickle_binary(path / 'att_score_dict.pkl')
        train_data = filter_bad_attentions(train_data, att_score_dict,
                                           filter_min_alignment,
                                           filter_min_sharpness)
        val_data = filter_bad_attentions(val_data, att_score_dict,
                                         filter_min_alignment,
                                         filter_min_sharpness)
        print(f'Using {len(train_data)} train files. Filtered '
              f'{train_len_original - len(train_data)} files due to bad '
              f'attention!')

    ds_cls = TacoDataset if model_type == 'tacotron' else ForwardDataset

    def batcher(data, shuffle):
        ds = ds_cls(path, [i for i, _ in data], text_dict, tokenizer,
                    speaker_dict)
        return BucketBatcher(ds, batch_size, r=r, mel_multiple=mel_multiple,
                             shuffle=shuffle)
    return batcher(train_data, True), batcher(val_data, False)


# ---------------------------------------------------------------- vocoder

class VocoderDataset:
    """Items {'mel' (n_mels, T), 'x' quant labels, 'item_id'} of the
    vocoders, with the mels of `mel/` or, for `train_gta`, of `gta/`."""

    def __init__(self, path: Path, dataset_ids: Sequence[str],
                 train_gta: bool = False) -> None:
        self.metadata = list(dataset_ids)
        self.mel_path = Path(path) / ('gta' if train_gta else 'mel')
        self.quant_path = Path(path) / 'quant'
        self._len_cache: Dict[int, int] = {}

    def prime_len_cache(self) -> None:
        """Fill the frame-count cache with one threaded native sweep of
        the headers; a refused file is left to `mel_len`."""
        missing = [i for i in range(len(self.metadata))
                   if i not in self._len_cache]
        if not missing:
            return
        lens = native_loader.npy_lengths(
            [self.mel_path / f'{self.metadata[i]}.npy' for i in missing])
        if lens is None:
            return
        for i, length in zip(missing, lens):
            self._len_cache[i] = int(length)

    def mel_len(self, index: int) -> int:
        """The frame count of the mel on disk (its header, cached): GTA
        mels can differ from the index pickles' lengths."""
        length = self._len_cache.get(index)
        if length is None:
            length = int(np.load(
                str(self.mel_path / f'{self.metadata[index]}.npy'),
                mmap_mode='r').shape[-1])
            self._len_cache[index] = length
        return length

    def __getitem__(self, index: int) -> Dict:
        item_id = self.metadata[index]
        mel = np.load(str(self.mel_path / f'{item_id}.npy'))
        x = np.load(str(self.quant_path / f'{item_id}.npy'))
        return {'mel': mel, 'x': x, 'item_id': item_id}

    def __len__(self) -> int:
        return len(self.metadata)


class VocCollator:
    """WaveRNN batches: a random mel window per item and the waveform
    labels it conditions, shifted by one sample into input x and target y
    (the reference's dataset.py:86-126; the JAX package's numpy path).
    x is float in [-1, 1]; y is the class label (RAW) or float (MOL,
    16-bit labels). Mels come out time-major (B, T_win, n_mels)."""

    def __init__(self, hop_length: int, voc_pad: int, voc_seq_len: int,
                 voc_mode: str, bits: int,
                 rng: Optional[np.random.RandomState] = None) -> None:
        self.hop_length = hop_length
        self.voc_pad = voc_pad
        self.voc_seq_len = voc_seq_len
        self.voc_mode = voc_mode
        self.bits = bits
        self.rng = rng or np.random.RandomState()
        self._n_mels: Optional[int] = None

    def _offsets(self, mel_lens: Sequence[int]) -> Tuple[int, list, list]:
        """(mel window, mel offsets, signal offsets): one draw an item,
        in item order."""
        mel_win = self.voc_seq_len // self.hop_length + 2 * self.voc_pad
        mel_offsets = [self.rng.randint(0, n - 2 - (mel_win
                                                    + 2 * self.voc_pad))
                       for n in mel_lens]
        sig_offsets = [(o + self.voc_pad) * self.hop_length
                       for o in mel_offsets]
        return mel_win, mel_offsets, sig_offsets

    def _labels(self, labels: np.ndarray) -> Dict[str, np.ndarray]:
        x = labels[:, :self.voc_seq_len]
        y = labels[:, 1:]
        bits = 16 if self.voc_mode == 'MOL' else self.bits
        x = label_2_float(x.astype(np.float32), bits)
        if self.voc_mode == 'MOL':
            y = label_2_float(y.astype(np.float32), bits)
        return {'x': x, 'y': y}

    def __call__(self, batch: List[Dict]) -> Dict[str, np.ndarray]:
        mel_win, mel_offsets, sig_offsets = self._offsets(
            [b['mel'].shape[-1] for b in batch])
        mels = np.stack([b['mel'][:, mel_offsets[i]:mel_offsets[i] + mel_win]
                         for i, b in enumerate(batch)]).astype(np.float32)
        labels = np.stack(
            [b['x'][sig_offsets[i]:sig_offsets[i] + self.voc_seq_len + 1]
             for i, b in enumerate(batch)]).astype(np.int64)
        return {'mel': mels.transpose(0, 2, 1), **self._labels(labels)}

    def collate_native(self, mel_paths: List[Path], quant_paths: List[Path],
                       mel_lens: List[int]) -> Dict[str, np.ndarray]:
        """`__call__`'s batch from the files, reading only the windows
        through the native loader. The draws come once, in `__call__`'s
        order, and a refused file's windows are read by numpy at the same
        offsets, so every path gives the same batch."""
        mel_win, mel_offsets, sig_offsets = self._offsets(mel_lens)
        if self._n_mels is None:
            self._n_mels = int(np.load(str(mel_paths[0]),
                                       mmap_mode='r').shape[0])
        mels = native_loader.load_mel_windows(mel_paths, mel_offsets,
                                              mel_win, self._n_mels)
        if mels is None:
            mels = np.stack([np.load(str(p))[:, o:o + mel_win].T
                             for p, o in zip(mel_paths, mel_offsets)]
                            ).astype(np.float32)
        count = self.voc_seq_len + 1
        labels = native_loader.load_i64_windows(quant_paths, sig_offsets,
                                                count)
        if labels is None:
            labels = np.stack([np.load(str(p))[s:s + count]
                               for p, s in zip(quant_paths, sig_offsets)]
                              ).astype(np.int64)
        return {'mel': mels, **self._labels(labels)}


class VocBatcher:
    """Fixed-size batches of a VocoderDataset (the tail dropped). The
    epoch's item order is a pure function of (seed, epoch), and a
    shuffling batcher reseeds its collator's window draws per (seed,
    epoch, batch), so a run resumed mid-epoch draws the crops of an
    uninterrupted one. A batcher that does not shuffle (the validation
    sets) keeps its collator's own generator. A collator with
    `collate_native` (WaveRNN's) reads only its windows from the files."""

    def __init__(self, dataset: VocoderDataset, batch_size: int,
                 collator, shuffle: bool = True, seed: int = 42) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.collator = collator
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0  # next epoch yielded by plain iter()

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def epoch_plan(self, epoch: int) -> List[List[int]]:
        idxs = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(_epoch_seed(self.seed, epoch)).shuffle(idxs)
        return [idxs[i:i + self.batch_size]
                for i in range(0, len(idxs) - self.batch_size + 1,
                               self.batch_size)]

    def batches(self, epoch: int, start: int = 0):
        """Yield epoch `epoch`'s batches from position `start`."""
        use_native = native_enabled() and hasattr(self.collator,
                                                  'collate_native')
        if use_native:
            self.dataset.prime_len_cache()
        ds = self.dataset
        for b, chunk in enumerate(self.epoch_plan(epoch)[start:], start):
            if self.shuffle:
                self.collator.rng = np.random.RandomState(
                    _epoch_seed(self.seed, epoch, b))
            if use_native:
                ids = [ds.metadata[j] for j in chunk]
                yield self.collator.collate_native(
                    [ds.mel_path / f'{i}.npy' for i in ids],
                    [ds.quant_path / f'{i}.npy' for i in ids],
                    [ds.mel_len(j) for j in chunk])
            else:
                yield self.collator([ds[j] for j in chunk])

    def __iter__(self):
        epoch, self._epoch = self._epoch, self._epoch + 1
        return self.batches(epoch)


def _vocoder_sets(path: Path, batch_size: int, train_gta: bool,
                  max_mel_len: int, num_gen_samples: int, make_collator):
    """(train batcher, val batches, the first `num_gen_samples` val items)
    over `make_collator(rng)`; the val windows come from seed 42 (the
    reference seeds numpy at dataset.py:70-72)."""
    path = Path(path)
    ids = [[i for i, _ in filter_max_len(unpickle_binary(path / name),
                                         max_mel_len)]
           for name in ('train_dataset.pkl', 'val_dataset.pkl')]
    train_dataset = VocoderDataset(path, ids[0], train_gta)
    val_dataset = VocoderDataset(path, ids[1], train_gta)
    train_set = VocBatcher(train_dataset, batch_size, make_collator(None),
                           shuffle=True)
    val_set = list(VocBatcher(val_dataset, batch_size,
                              make_collator(np.random.RandomState(42)),
                              shuffle=False))
    val_set_samples = [val_dataset[i] for i in
                       range(min(num_gen_samples, len(val_dataset)))]
    return train_set, val_set, val_set_samples


def get_vocoder_datasets(path: Path, batch_size: int, train_gta: bool,
                         max_mel_len: int, hop_length: int, voc_pad: int,
                         voc_seq_len: int, voc_mode: str, bits: int,
                         num_gen_samples: int):
    """WaveRNN's (train, val, samples) (the reference's
    get_vocoder_datasets, dataset.py:35-83)."""
    return _vocoder_sets(
        path, batch_size, train_gta, max_mel_len, num_gen_samples,
        lambda rng: VocCollator(hop_length, voc_pad, voc_seq_len, voc_mode,
                                bits, rng=rng))


class GANVocCollator:
    """Frame-aligned (mel window, float audio segment) pairs of the GAN
    vocoders: `seg_len // hop` frames and the `seg_len` samples they
    generate, with no shifted labels and no conditioning pad. The audio
    is decoded from the quant labels (mu-law for RAW preprocessing with
    mu_law, linear labels otherwise). A clip of at most one window is
    repeated to more than one; a clip without a whole frame is dropped,
    and the batch is refilled with the rows it has, in turn."""

    def __init__(self, hop_length: int, seg_len: int, voc_mode: str,
                 bits: int, mu_law: bool,
                 rng: Optional[np.random.RandomState] = None) -> None:
        if seg_len % hop_length:
            raise ValueError(f'seg_len {seg_len} must be a multiple of hop '
                             f'{hop_length}')
        self.hop_length = hop_length
        self.seg_len = seg_len
        self.voc_mode = voc_mode
        self.bits = bits
        self.mu_law = mu_law
        self.rng = rng or np.random.RandomState()

    def __call__(self, batch: List[Dict]) -> Dict[str, np.ndarray]:
        win = self.seg_len // self.hop_length
        bits = 16 if self.voc_mode == 'MOL' else self.bits
        mels, audios = [], []
        for b in batch:
            mel, x = b['mel'], b['x']
            t = min(mel.shape[-1], len(x) // self.hop_length)
            if t == 0:
                continue
            if t <= win:
                reps = -(-(win + 1) // t)
                mel = np.tile(mel[:, :t], (1, reps))
                x = np.tile(x[:t * self.hop_length], reps)
                t = win + 1
            o = self.rng.randint(0, max(t - win - 1, 1))
            mels.append(mel[:, o:o + win])
            seg = x[o * self.hop_length:o * self.hop_length + self.seg_len]
            if self.mu_law and self.voc_mode != 'MOL':
                audios.append(decode_mu_law(seg, 2 ** bits,
                                            from_labels=True))
            else:
                audios.append(label_2_float(seg.astype(np.float32), bits))
        if not mels:
            raise ValueError('GANVocCollator: every clip in the batch was '
                             'empty (no full mel frame)')
        n_real = len(mels)
        while len(mels) < len(batch):
            i = len(mels) % n_real
            mels.append(mels[i])
            audios.append(audios[i])
        return {'mel': np.stack(mels).astype(np.float32).transpose(0, 2, 1),
                'audio': np.stack(audios).astype(np.float32)}


def get_gan_vocoder_datasets(path: Path, batch_size: int, train_gta: bool,
                             max_mel_len: int, hop_length: int, seg_len: int,
                             voc_mode: str, bits: int, mu_law: bool,
                             num_gen_samples: int):
    """The GAN vocoders' (train, val, samples), over the layout of
    `get_vocoder_datasets`."""
    return _vocoder_sets(
        path, batch_size, train_gta, max_mel_len, num_gen_samples,
        lambda rng: GANVocCollator(hop_length, seg_len, voc_mode, bits,
                                   mu_law, rng=rng))


class Prefetcher:
    """Bounded background-thread prefetch over a batch iterable: `DEPTH`
    batches in flight on one daemon thread, so disk reads and collation
    overlap the device step. Exceptions propagate to the consumer;
    iteration order is unchanged."""

    DEPTH = 2
    _DONE = object()

    def __init__(self, iterable) -> None:
        self.iterable = iterable

    def __len__(self) -> int:
        return len(self.iterable)

    def __iter__(self):
        q: 'queue.Queue' = queue.Queue(maxsize=self.DEPTH)

        def worker():
            try:
                for item in self.iterable:
                    q.put(item)
            except BaseException as e:  # re-raised on the main thread
                q.put(e)
                return
            q.put(self._DONE)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            with annotate('ftt.data.next'):
                item = q.get()
            if item is self._DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
