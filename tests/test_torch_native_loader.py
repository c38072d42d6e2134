"""The port's batch loader (`data/native_loader.py` over its own
`native/batch_loader.cc`) against the JAX package's `native_loader` on the
same files, refusals included; and the batches of `BucketBatcher` and
`VocBatcher` on the native path against `FTT_NATIVE_LOADER=0` and against
the JAX package's, for the same seed and epoch, from an epoch's start and
mid-epoch. Every comparison is exact.
"""
import pickle

import numpy as np
import pytest

N_MELS = 20


def _write_tts_data(base, n_items=11, seed=0, speakers=False):
    """Mels of 30-150 frames, durations, pitch, energy, text and indexes
    (and a speaker_dict when `speakers`) under `base`."""
    rng = np.random.RandomState(seed)
    for d in ('mel', 'alg', 'phon_pitch', 'phon_energy'):
        (base / d).mkdir(parents=True)
    items, text = [], {}
    for i in range(n_items):
        iid = f'u{i:03d}'
        frames, n_tok = int(rng.randint(30, 150)), int(rng.randint(6, 20))
        np.save(base / 'mel' / f'{iid}.npy',
                rng.randn(N_MELS, frames).astype(np.float32))
        np.save(base / 'alg' / f'{iid}.npy', rng.multinomial(
            frames, np.ones(n_tok) / n_tok).astype(np.int32))
        for d in ('phon_pitch', 'phon_energy'):
            np.save(base / d / f'{iid}.npy', rng.randn(n_tok).astype(
                np.float32))
        items.append((iid, frames))
        text[iid] = 'hello world ' * (n_tok // 2 + 1)
    for name, obj in (('train_dataset', items[2:]), ('val_dataset', items[:2]),
                      ('text_dict', text)):
        with open(base / f'{name}.pkl', 'wb') as f:
            pickle.dump(obj, f)
    if speakers:
        with open(base / 'speaker_dict.pkl', 'wb') as f:
            pickle.dump({iid: i % 3 for i, (iid, _) in enumerate(items)}, f)
    return base


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k


def _files(tmp_path):
    """Good mels and labels, and one file of each kind the loader refuses."""
    rng = np.random.RandomState(1)
    d = tmp_path / 'files'
    d.mkdir()
    mels, quants = [], []
    for i, frames in enumerate((37, 64, 90)):
        np.save(d / f'm{i}.npy', rng.randn(N_MELS, frames).astype(np.float32))
        np.save(d / f'q{i}.npy', rng.randint(0, 512, frames * 8))
        mels.append(d / f'm{i}.npy')
        quants.append(d / f'q{i}.npy')
    np.save(d / 'f64.npy', rng.randn(N_MELS, 40))
    np.save(d / 'fortran.npy', np.asfortranarray(
        rng.randn(N_MELS, 40).astype(np.float32)))
    np.save(d / 'other_mels.npy', rng.randn(N_MELS + 1, 40).astype(
        np.float32))
    full = (d / 'm2.npy').read_bytes()
    (d / 'truncated.npy').write_bytes(full[:len(full) // 2])
    np.save(d / 'i32.npy', np.arange(800, dtype=np.int32))
    bad = {k: d / f'{k}.npy' for k in ('f64', 'fortran', 'other_mels',
                                        'truncated', 'missing', 'i32')}
    return mels, quants, bad


def _same(got, want):
    if want is None:
        assert got is None
        return
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_loader_functions_equal_jax(tmp_path):
    """The four functions on the same files, and each refusal (None): a
    float64 or Fortran-order mel, another mel count, a truncated or
    missing file, a mel longer than the batch, a window past the end, an
    int32 label file."""
    from forwardtacotron_tpu.data import native_loader as jnl
    from forwardtacotron_tpu_torch.data import native_loader as nl
    assert jnl.available()
    mels, quants, bad = _files(tmp_path)
    pad = -11.5129
    for got, want in (
            (nl.load_mel_batch(mels, 96, N_MELS, pad),
             jnl.load_mel_batch(mels, 96, N_MELS, pad)),
            (nl.npy_lengths(mels), jnl.npy_lengths(mels)),
            (nl.npy_lengths(quants, '<i8'), jnl.npy_lengths(quants, '<i8')),
            (nl.load_mel_windows(mels, [0, 20, 50], 30, N_MELS),
             jnl.load_mel_windows(mels, [0, 20, 50], 30, N_MELS)),
            (nl.load_i64_windows(quants, [5, 100, 0], 33),
             jnl.load_i64_windows(quants, [5, 100, 0], 33))):
        assert want is not None
        _same(got, want)
    mel, lens = nl.load_mel_batch(mels, 96, N_MELS, pad)
    for i, p in enumerate(mels):
        ref = np.load(p)
        assert lens[i] == ref.shape[1]
        np.testing.assert_array_equal(mel[i, :lens[i]], ref.T)
        assert np.all(mel[i, lens[i]:] == np.float32(pad))

    refusals = 0
    for name in ('f64', 'fortran', 'other_mels', 'truncated', 'missing'):
        paths = mels[:1] + [bad[name]]
        for fn, args in ((lambda m, *a: m.load_mel_batch(*a),
                          (paths, 96, N_MELS, pad)),
                         (lambda m, *a: m.npy_lengths(*a), (paths,)),
                         (lambda m, *a: m.load_mel_windows(*a),
                          (paths, [0, 0], 30, N_MELS))):
            got, want = fn(nl, *args), fn(jnl, *args)
            _same(got, want)
            refusals += got is None
    for args in (([mels[2]], 64, N_MELS, pad), ):      # longer than max_t
        _same(nl.load_mel_batch(*args), jnl.load_mel_batch(*args))
        assert nl.load_mel_batch(*args) is None
    for args in (([mels[0]], [20], 30, N_MELS), ):     # past the end
        assert nl.load_mel_windows(*args) is None
        assert jnl.load_mel_windows(*args) is None
    for paths, starts in (([quants[0], bad['i32']], [0, 0]),
                          ([quants[0]], [37 * 8 - 10]),
                          ([bad['missing']], [0])):
        _same(nl.load_i64_windows(paths, starts, 33),
              jnl.load_i64_windows(paths, starts, 33))
        assert nl.load_i64_windows(paths, starts, 33) is None
    assert nl.npy_lengths([bad['i32']], '<i8') is None
    assert refusals >= 13


@pytest.mark.parametrize('model_type,speakers', [('tacotron', False),
                                                 ('forward', False),
                                                 ('forward', True)])
def test_bucket_batches_native_numpy_and_jax(tmp_path, monkeypatch,
                                             model_type, speakers):
    """The train set's batches over three epochs (one resumed mid-epoch)
    and the val set's: native path, numpy path, the JAX package's."""
    from forwardtacotron_tpu.data import dataset as jds
    from forwardtacotron_tpu_torch.data import dataset as tds
    base = _write_tts_data(tmp_path / 'data', speakers=speakers)
    kw = dict(batch_size=3, r=2, max_mel_len=None, filter_attention=False,
              model_type=model_type, mel_multiple=64)
    train, val = tds.get_tts_datasets(base, **kw)
    jtrain, jval = jds.get_tts_datasets(base, **kw)
    calls = []
    real = tds.native_loader.load_mel_batch
    monkeypatch.setattr(tds.native_loader, 'load_mel_batch',
                        lambda *a: calls.append(1) or real(*a))
    runs = [(0, 0), (1, 2), (2, 0)]
    native = [list(train.batches(e, s)) for e, s in runs] + [list(val)]
    n_batches = sum(len(b) for b in native)
    assert len(calls) == n_batches
    assert all(np.asarray(b['mel']).flags['C_CONTIGUOUS']
               for run in native for b in run)
    if speakers:
        assert all('speaker' in b for run in native for b in run)
    monkeypatch.setenv('FTT_NATIVE_LOADER', '0')
    plain = [list(train.batches(e, s)) for e, s in runs] + [list(val)]
    assert len(calls) == n_batches
    monkeypatch.delenv('FTT_NATIVE_LOADER')
    theirs = [list(jtrain.batches(e, s)) for e, s in runs] + [list(jval)]
    for got, numpy_run, jax_run in zip(native, plain, theirs):
        _assert_batches_equal(got, numpy_run)
        _assert_batches_equal(got, jax_run)


def test_bucket_batch_with_a_refused_file_is_assembled_by_numpy(tmp_path):
    """A mel the loader refuses (float64 here) sends that batch through
    `collate_tts`, with the batch the native path would give."""
    from forwardtacotron_tpu_torch.data import dataset as tds
    base = _write_tts_data(tmp_path / 'data')
    train, _ = tds.get_tts_datasets(base, 3, 1, max_mel_len=None,
                                    filter_attention=False,
                                    model_type='tacotron', mel_multiple=64)
    want = list(train.batches(0))
    bucket, idxs = train.epoch_plan(0)[0]
    iid = train.dataset.metadata[idxs[0]]
    path = base / 'mel' / f'{iid}.npy'
    np.save(path, np.load(path).astype(np.float64))
    got = list(train.batches(0))
    assert got[0]['mel'].dtype == np.float32
    assert not got[0]['mel'].flags['C_CONTIGUOUS']      # collate_tts's
    _assert_batches_equal(got, want)


def _write_voc_data(base, n_items=9, hop=16, seed=2):
    rng = np.random.RandomState(seed)
    for d in ('mel', 'quant'):
        (base / d).mkdir(parents=True)
    items = []
    for i in range(n_items):
        iid = f'v{i:03d}'
        frames = int(rng.randint(40, 90))
        np.save(base / 'mel' / f'{iid}.npy',
                rng.randn(N_MELS, frames).astype(np.float32))
        np.save(base / 'quant' / f'{iid}.npy',
                rng.randint(0, 512, frames * hop).astype(np.int64))
        items.append((iid, frames))
    for name, obj in (('train_dataset', items[3:]),
                      ('val_dataset', items[:3])):
        with open(base / f'{name}.pkl', 'wb') as f:
            pickle.dump(obj, f)
    return base


@pytest.mark.parametrize('mode', ['RAW', 'MOL'])
def test_voc_batches_native_numpy_and_jax(tmp_path, monkeypatch, mode):
    """WaveRNN's windows over three epochs (one resumed mid-epoch) and the
    fixed-seed val batches: native path (windows only), numpy path, the
    JAX package's; the draws come once, in item order, on every path."""
    from forwardtacotron_tpu.data import dataset as jds
    from forwardtacotron_tpu_torch.data import dataset as tds
    hop = 16
    base = _write_voc_data(tmp_path / 'data', hop=hop)
    kw = dict(path=base, batch_size=2, train_gta=False, max_mel_len=None,
              hop_length=hop, voc_pad=2, voc_seq_len=10 * hop,
              voc_mode=mode, bits=9, num_gen_samples=2)
    calls = []
    real = tds.native_loader.load_mel_windows
    monkeypatch.setattr(tds.native_loader, 'load_mel_windows',
                        lambda *a: calls.append(1) or real(*a))
    train, val, _ = tds.get_vocoder_datasets(**kw)
    jtrain, jval, _ = jds.get_vocoder_datasets(**kw)
    runs = [(0, 0), (1, 1), (2, 0)]
    native = [list(train.batches(e, s)) for e, s in runs] + [val]
    assert len(calls) == sum(len(b) for b in native)
    monkeypatch.setenv('FTT_NATIVE_LOADER', '0')
    plain_train, plain_val, _ = tds.get_vocoder_datasets(**kw)
    plain = [list(plain_train.batches(e, s)) for e, s in runs] + [plain_val]
    assert len(calls) == sum(len(b) for b in native)
    monkeypatch.delenv('FTT_NATIVE_LOADER')
    theirs = [list(jtrain.batches(e, s)) for e, s in runs] + [jval]
    for got, numpy_run, jax_run in zip(native, plain, theirs):
        _assert_batches_equal(got, numpy_run)
        _assert_batches_equal(got, jax_run)


def test_voc_lengths_come_from_the_headers(tmp_path):
    """`prime_len_cache` reads every mel's frame count in one native
    sweep; a file it refuses is read by `mel_len` alone."""
    from forwardtacotron_tpu_torch.data.dataset import VocoderDataset
    base = _write_voc_data(tmp_path / 'data')
    ids = [f'v{i:03d}' for i in range(9)]
    np.save(base / 'mel' / 'v004.npy',
            np.load(base / 'mel' / 'v004.npy').astype(np.float64))
    ds = VocoderDataset(base, ids)
    ds.prime_len_cache()
    assert ds._len_cache == {}
    want = [np.load(base / 'mel' / f'{i}.npy').shape[1] for i in ids]
    assert [ds.mel_len(j) for j in range(9)] == want
    ds = VocoderDataset(base, ids[:4])
    ds.prime_len_cache()
    assert ds._len_cache == dict(enumerate(want[:4]))
