"""Synthesize a tiny on-disk dataset so every training CLI of the port can
be driven end to end without LJSpeech (a copy of the JAX package's
`tools/make_synthetic_dataset.py` over the port's own `text/` and
`utils/`: for the same `--seed`, `--items` and config it writes the same
files).

Writes the layout `preprocess` produces: data/{mel,quant,raw_pitch,alg,
phon_pitch,phon_energy}/<id>.npy plus the pkl indexes (text_dict,
train/val datasets, att_score_dict), with the invariants the real
pipeline guarantees (durations sum to mel frames, quant length = frames *
hop, phoneme series match token counts).

    python -m forwardtacotron_tpu_torch.tools.make_synthetic_dataset \\
        [--items 10] [--config FILE]

Without `--config` the built-in config (config.yaml's values) is used;
`--config` takes a YAML (needs pyyaml) or JSON file. Then `train_tacotron`,
`train_forward`, `train_wavernn`, `train_hifigan` and `gen_forward` run
against it.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import numpy as np

from forwardtacotron_tpu_torch.config import default_config, read_config
from forwardtacotron_tpu_torch.text.tokenizer import Tokenizer
from forwardtacotron_tpu_torch.utils.files import pickle_binary
from forwardtacotron_tpu_torch.utils.paths import Paths

SENTENCES = [
    'hello there world', 'a quick brown fox jumps', 'testing one two',
    'synthesized tiny data', 'the teacher aligns phonemes',
    'forward tacotron on tpu', 'pitch and energy values',
    'wave rnn vocoder sample', 'short utterance here',
    'final validation item', 'more items for larger runs',
    'the birch canoe slid', 'glue the sheet down',
    'depth of a well', 'a rare chicken dish', 'rice in round bowls',
]


def make_dataset(paths: Paths, config: Dict[str, Any], n_items: int = 10,
                 n_val: int = 2, seed: int = 0, min_frames: int = 40,
                 max_frames: int = 90) -> int:
    n_mels = config['dsp']['num_mels']
    hop = config['dsp']['hop_length']
    bits = config['dsp']['bits']
    rng = np.random.RandomState(seed)
    tok = Tokenizer()

    dataset, text_dict = [], {}
    for i in range(n_items):
        text = SENTENCES[i % len(SENTENCES)]
        item_id = f'syn{i:03d}'
        n_frames = rng.randint(min_frames, max_frames)
        x_len = len(tok(text))
        mel = (rng.randn(n_mels, n_frames) * 1.5 - 6).astype(np.float32)
        np.save(paths.mel / f'{item_id}.npy', mel)
        quant = rng.randint(0, 2 ** bits,
                            n_frames * hop).astype(np.int64)
        np.save(paths.quant / f'{item_id}.npy', quant)
        pitch = np.abs(rng.randn(n_frames) * 60 + 120).astype(np.float32)
        np.save(paths.raw_pitch / f'{item_id}.npy', pitch)
        # durations: positive ints summing exactly to n_frames
        dur = rng.multinomial(n_frames - x_len,
                              np.ones(x_len) / x_len) + 1
        assert int(dur.sum()) == n_frames
        np.save(paths.alg / f'{item_id}.npy', dur.astype(np.float32))
        np.save(paths.phon_pitch / f'{item_id}.npy',
                rng.randn(x_len).astype(np.float32))
        np.save(paths.phon_energy / f'{item_id}.npy',
                np.abs(rng.randn(x_len)).astype(np.float32) + 1)
        text_dict[item_id] = text
        dataset.append((item_id, n_frames))

    pickle_binary(text_dict, paths.data / 'text_dict.pkl')
    pickle_binary(dataset[n_val:], paths.data / 'train_dataset.pkl')
    pickle_binary(dataset[:n_val], paths.data / 'val_dataset.pkl')
    att_scores = {i: (1.0, 1.0) for i, _ in dataset}
    pickle_binary(att_scores, paths.data / 'att_score_dict.pkl')
    return len(dataset)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description='Create a tiny synthetic dataset for e2e runs')
    parser.add_argument('--items', type=int, default=10)
    parser.add_argument('--n_val', type=int, default=2)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--config', metavar='FILE', default=None,
                        help='YAML or JSON config (default: built-in)')
    args = parser.parse_args(argv)

    config = read_config(args.config) if args.config else default_config()
    paths = Paths(config['data_path'], config['tts_model_id'],
                  voc_id=config['voc_model_id'])
    n = make_dataset(paths, config, n_items=args.items,
                     n_val=args.n_val, seed=args.seed)
    print(f'wrote {n} items under {paths.data}')
    return n


if __name__ == '__main__':
    main()
