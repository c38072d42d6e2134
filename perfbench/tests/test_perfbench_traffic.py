"""The traffic generators: seeded output, the parameters they honour, and
the same set of sizes for every seed."""
import random
from collections import Counter
from pathlib import Path

import numpy as np

from perfbench.harness import dataset, texts
from perfbench.harness.poisson_open import arrival_offsets
from perfbench.tests.conftest import SMALL_TRAIN, _json


def _read(data: Path):
    import pickle
    index = pickle.loads((data / 'train_dataset.pkl').read_bytes())
    text = pickle.loads((data / 'text_dict.pkl').read_bytes())
    mels = {i: np.load(data / 'mel' / f'{i}.npy') for i, _ in index}
    durs = {i: np.load(data / 'alg' / f'{i}.npy') for i, _ in index}
    return index, text, mels, durs


def test_dataset_is_seeded_and_keeps_its_sizes(tmp_path):
    dataset.write_dataset(tmp_path / 'a', SMALL_TRAIN, 2 ** 31 + 7)
    dataset.write_dataset(tmp_path / 'b', SMALL_TRAIN, 2 ** 31 + 7)
    dataset.write_dataset(tmp_path / 'c', SMALL_TRAIN, 12)
    a, b, c = (_read(tmp_path / k) for k in 'abc')
    assert a[0] == b[0] and a[1] == b[1]
    assert all(np.array_equal(a[2][i], b[2][i]) for i in a[2])
    # another seed: the same lengths in another order, other values
    assert sorted(t for _, t in a[0]) == sorted(t for _, t in c[0])
    assert Counter(len(v) for v in a[1].values()) == \
        Counter(len(v) for v in c[1].values())
    assert [t for _, t in a[0]] != [t for _, t in c[0]]
    assert not np.array_equal(a[2][a[0][0][0]], c[2][c[0][0][0]])
    for index, text, mels, durs in (a, c):
        for item, t in index:
            assert mels[item].shape == (80, t)
            assert durs[item].sum() == t and durs[item].min() >= 1
            assert len(durs[item]) == len(text[item])
            assert 10 <= len(text[item]) <= 18


def test_training_mix_fills_whole_batches_per_bucket():
    traffic = _json('traffic/train_b32.json')
    frames = dataset.frame_lengths(traffic)
    assert 520 <= frames.min() and frames.max() <= 870
    assert abs(frames.mean() - 695) < 10
    buckets = Counter(((f + 1 + 127) // 128) * 128 for f in frames)
    assert sorted(buckets) == [640, 768, 896]
    assert all(n % traffic['batch_size'] == 0 for n in buckets.values())


def test_texts_are_seeded_with_the_same_lengths():
    params = _json('traffic/serve_poisson.json')
    one = texts.texts(400, params, 5)
    assert one == texts.texts(400, params, 5)
    other = texts.texts(400, params, 6)
    assert one != other
    lo, hi = params['chars_min'], params['chars_max']
    assert all(lo - 12 <= len(t) <= hi for t in one)
    assert abs(np.mean([len(t) for t in one]) - texts.mean_chars(params)) < 4
    rng = random.Random(1)
    assert sorted(texts.char_lengths(50, params, rng)) == \
        sorted(texts.char_lengths(50, params, random.Random(2)))
    assert all(t.endswith('.') and t[:-1] == t[:-1].lower() for t in one)


def test_arrivals_are_poisson_quantiles_in_seeded_order():
    import math
    a = arrival_offsets(1000, 40.0, random.Random(1))
    b = arrival_offsets(1000, 40.0, random.Random(2))
    assert a[0] == 0.0 and all(x < y for x, y in zip(a, a[1:]))
    assert a != b
    # every gap is a midpoint quantile of the exponential at the rate
    quantiles = np.array([-math.log(1.0 - (i + 0.5) / 1000) / 40.0
                          for i in range(1000)])
    for offsets in (a, b):
        gaps = np.diff(offsets)
        nearest = np.abs(gaps[:, None] - quantiles[None, :]).min(axis=1)
        assert nearest.max() < 1e-12
        assert len(set(np.round(gaps, 12))) == 999
    assert abs(quantiles.mean() * 40.0 - 1.0) < 0.01


def test_reference_front_end_matches_the_port_on_generated_texts():
    from forwardtacotron_tpu_torch.text.cleaners import Cleaner
    from forwardtacotron_tpu_torch.text.tokenizer import Tokenizer
    from perfbench.reference.frontend import load_lexicon, token_ids
    params = _json('traffic/serve_poisson.json')
    lexicon = load_lexicon()
    cleaner, tokenizer = Cleaner('english_cleaners', True, 'en-us'), \
        Tokenizer()
    for t in texts.texts(200, params, 3):
        assert tokenizer(cleaner(t)) == token_ids(t, lexicon)
