"""The port's data preparation on the CPU against the JAX package: the F0
estimator, the long-silence trim, the bucketed mel, and `preprocess` on
a seeded LJSpeech-layout corpus, with the bad files of
tests/test_preprocess_edge_cases.py.

Tolerances: F0 against the JAX package's on the same signal, the same
voicing on every frame and voiced values within 1e-3 relative (two
float32 FFT autocorrelations; measured 1.5e-5 Hz on the golden speech);
F0 against tests/resources/golden_f0.npy at tests/test_dsp_golden.py's
bounds; the trimmed wav exact (the same numpy code); mels within 1e-4 of
the peak before the log, as tests/test_torch_dsp.py holds them (after the
log, two float32 FFTs differ most where the mel sits at the 1e-5 clip
floor); the quantized wav exact; the pickles and the split equal.
"""
import pathlib
import struct
import wave

import numpy as np
import pytest

import torch

RES = pathlib.Path(__file__).parent / 'resources'
SR = 22050


def _write_wav(path, data, sr=SR, channels=1):
    pcm = np.clip(np.round(np.asarray(data) * 32767.0), -32768,
                  32767).astype('<i2')
    with wave.open(str(path), 'wb') as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def _tone(n, sr=SR, f=220.0, amp=0.5):
    return amp * np.sin(2 * np.pi * f * np.arange(n) / sr)


def _harmonic(n, seed, sr=SR):
    """A five-harmonic signal whose F0 glides around 100-200 Hz, with
    silence and faint noise at both ends."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / sr
    f0 = 150 + 50 * np.sin(2 * np.pi * rng.uniform(0.5, 2.0) * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    y = sum(0.3 / k * np.sin(k * phase) for k in range(1, 6))
    gap = np.zeros(3000)
    return np.concatenate([gap, y, gap]) + 1e-4 * rng.randn(n + 6000)


@pytest.fixture
def config():
    from forwardtacotron_tpu_torch.config import default_config
    return default_config()


def _assert_same_f0(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got > 0, want > 0)
    voiced = want > 0
    np.testing.assert_allclose(got[voiced], want[voiced], rtol=1e-3)


def test_estimate_f0_matches_jax(config):
    from forwardtacotron_tpu.dsp import pitch as jpitch
    from forwardtacotron_tpu_torch.dsp import pitch as tpitch
    hop = config['dsp']['hop_length']
    for seed in range(3):
        y = _harmonic(9000 + 2000 * seed, seed).astype(np.float32)
        _assert_same_f0(tpitch.extract_pitch(y, SR, hop, device='cpu'),
                        jpitch.extract_pitch(y, SR, hop))
        _assert_same_f0(
            tpitch.extract_pitch_bucketed(y, SR, hop, device='cpu'),
            jpitch.extract_pitch_bucketed(y, SR, hop))
    # a batch, centred, against the JAX estimator
    ys = np.stack([_harmonic(8000, s) for s in range(2)]).astype(np.float32)
    got = tpitch.estimate_f0(torch.from_numpy(ys), SR, hop).numpy()
    want = np.asarray(jpitch.estimate_f0(ys, SR, hop))
    for g, w in zip(got, want):
        _assert_same_f0(g, w)


def test_estimate_f0_matches_golden_contour(config):
    """tests/test_dsp_golden.py's gate, on the port's estimator."""
    from forwardtacotron_tpu_torch.dsp.audio import DSP
    from forwardtacotron_tpu_torch.dsp.pitch import extract_pitch
    dsp = DSP.from_config(config, device='cpu')
    wav = dsp.load_wav(RES / 'golden_speech.wav')
    true_f0 = np.load(RES / 'golden_f0.npy')
    f0 = extract_pitch(wav, dsp.sample_rate, dsp.hop_length, device='cpu')
    n = min(len(f0), len(true_f0))
    f0, true_f0 = f0[:n], true_f0[:n]
    voiced = true_f0 > 0
    interior = voiced.copy()
    for s in (1, 2):
        interior &= np.roll(voiced, s) & np.roll(voiced, -s)
    est_voiced = f0[interior] > 0
    assert est_voiced.mean() > 0.9
    rel_err = np.abs(f0[interior][est_voiced]
                     - true_f0[interior][est_voiced]) \
        / true_f0[interior][est_voiced]
    assert np.median(rel_err) < 0.01
    assert np.mean(rel_err < 0.05) > 0.95
    far_unvoiced = ~voiced
    for s in (1, 2):
        far_unvoiced &= ~np.roll(voiced, s) & ~np.roll(voiced, -s)
    assert (f0[far_unvoiced] > 0).mean() < 0.1


def test_trim_and_bucketed_mel_match_jax(config):
    from forwardtacotron_tpu.dsp.audio import DSP as JDSP
    from forwardtacotron_tpu_torch.dsp.audio import DSP
    dsp, jdsp = DSP.from_config(config, device='cpu'), JDSP.from_config(
        config)
    wav = dsp.load_wav(RES / 'golden_speech.wav')
    long_gaps = np.concatenate([np.zeros(20000), wav, 1e-4 * np.ones(30000),
                                wav, np.zeros(9000)]).astype(np.float32)
    trimmed = dsp.trim_long_silences(long_gaps)
    np.testing.assert_array_equal(trimmed,
                                  jdsp.trim_long_silences(long_gaps))
    assert len(trimmed) < len(long_gaps)
    for y in (wav, trimmed, wav[:5000]):
        mel = dsp.wav_to_mel_bucketed(y)
        ref = jdsp.wav_to_mel_bucketed(y)
        assert mel.shape == ref.shape == (80, 1 + len(y) // 256)
        peak = float(np.exp(ref).max())
        assert float(np.abs(np.exp(mel) - np.exp(ref)).max()) <= 1e-4 * peak
        np.testing.assert_allclose(mel, dsp.wav_to_mel(y), atol=1e-4)
    batch = torch.from_numpy(np.stack([wav[:6000], wav[1000:7000]]))
    mels = dsp.wav_to_mel_batch(batch)
    assert mels.shape == (2, 1 + 6000 // 256, 80)
    np.testing.assert_allclose(mels[0].numpy().T, dsp.wav_to_mel(wav[:6000]),
                               atol=1e-5)


def _write_corpus(root, n_items=6):
    """An LJSpeech-layout corpus: metadata.csv (id|text|normalized text)
    plus a wav per line, one line without a wav and one with too short a
    text."""
    wavs = root / 'wavs'
    wavs.mkdir(parents=True)
    texts = ['Printing, in the only sense with which we are concerned.',
             'The cat sat on the mat.', 'One two three.',
             'She sells sea shells by the sea shore.', 'Hello world!',
             'A quick brown fox jumps over the lazy dog.']
    lines = []
    for i in range(n_items):
        _write_wav(wavs / f'LJ{i:03d}.wav',
                   _harmonic(7000 + 1500 * i, seed=i))
        lines.append(f'LJ{i:03d}|{texts[i]}|{texts[i]}')
    lines += ['LJ900|no wav for this line|no wav for this line', 'LJ901|a|a']
    _write_wav(wavs / 'LJ901.wav', _harmonic(6000, seed=9))
    (root / 'metadata.csv').write_text('\n'.join(lines) + '\n',
                                       encoding='utf-8')


def preprocess_both(tmp_path, monkeypatch, config, corpus):
    """Both packages' `main` on `corpus` with `config`: (the port's data
    directory, JAX's, train, val), the pickles and the split equal."""
    import yaml
    import preprocess as jax_preprocess
    from forwardtacotron_tpu.utils import jax_setup
    from forwardtacotron_tpu_torch import preprocess
    from forwardtacotron_tpu_torch.utils.files import unpickle_binary
    runs = {}
    for name in ('port', 'jax'):
        cfg = dict(config, data_path=str(tmp_path / name / 'data'))
        path = tmp_path / f'{name}.yaml'
        path.write_text(yaml.safe_dump(cfg))
        runs[name] = tmp_path / name / 'data'
        monkeypatch.setenv('FTT_BASE', str(tmp_path / name))
        argv = ['--path', str(corpus), '--config', str(path),
                '--num_workers', '2']
        if name == 'port':
            train, val = preprocess.main(argv + ['--device', 'cpu'])
        else:
            monkeypatch.setattr(jax_setup, 'enable_compilation_cache',
                                lambda *a: None)
            monkeypatch.setattr('sys.argv', ['preprocess.py'] + argv)
            jax_preprocess.main()
    ours, theirs = runs['port'], runs['jax']
    for pkl in ('train_dataset.pkl', 'val_dataset.pkl', 'text_dict.pkl'):
        assert unpickle_binary(ours / pkl) == unpickle_binary(theirs / pkl)
    assert unpickle_binary(ours / 'train_dataset.pkl') == train
    return ours, theirs, train, val


def assert_same_features(ours, theirs, items):
    """Mels, quantized wavs and F0 of `items` at the module's tolerances."""
    for item, frames in items:
        mel = np.load(ours / 'mel' / f'{item}.npy')
        ref = np.load(theirs / 'mel' / f'{item}.npy')
        assert mel.shape == ref.shape == (80, frames)
        peak = float(np.exp(ref).max())
        assert float(np.abs(np.exp(mel) - np.exp(ref)).max()) <= 1e-4 * peak
        quant = np.load(ours / 'quant' / f'{item}.npy')
        want = np.load(theirs / 'quant' / f'{item}.npy')
        assert quant.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(quant, want)
        _assert_same_f0(np.load(ours / 'raw_pitch' / f'{item}.npy'),
                        np.load(theirs / 'raw_pitch' / f'{item}.npy'))


def test_preprocess_matches_jax(tmp_path, monkeypatch, config):
    """Both packages' `main` on the same corpus and config (n_val 2): the
    same items, split, texts, quantized wavs; mels and F0 at the module's
    tolerances."""
    corpus = tmp_path / 'corpus'
    _write_corpus(corpus)
    config['preprocessing']['n_val'] = 2
    ours, theirs, train, val = preprocess_both(tmp_path, monkeypatch,
                                               config, corpus)
    assert len(train) == 4 and len(val) == 2
    assert val[0][1] >= val[1][1]
    assert_same_features(ours, theirs, train + val)


def test_process_all_skips_bad_files_and_keeps_going(config, tmp_path,
                                                     capsys):
    """tests/test_preprocess_edge_cases.py's inputs through the port."""
    from forwardtacotron_tpu_torch.dsp.audio import DSP
    from forwardtacotron_tpu_torch.preprocess import process_all
    from forwardtacotron_tpu_torch.text.cleaners import Cleaner
    from forwardtacotron_tpu_torch.utils.paths import Paths
    config['dsp']['trim_start_end_silence'] = False
    dsp = DSP.from_config(config, device='cpu')
    wav_dir = tmp_path / 'wavs'
    wav_dir.mkdir()
    _write_wav(wav_dir / 'good.wav', _tone(SR))
    _write_wav(wav_dir / 'clipped.wav', 3.0 * _tone(SR))
    _write_wav(wav_dir / 'quiet.wav', 1e-4 * _tone(SR))
    _write_wav(wav_dir / 'stereo.wav', np.repeat(_tone(SR // 2), 2),
               channels=2)
    _write_wav(wav_dir / 'fast.wav', _tone(44100, sr=44100), sr=44100)
    _write_wav(wav_dir / 'empty.wav', np.zeros(0))
    (wav_dir / 'corrupt.wav').write_bytes(
        b'RIFF' + struct.pack('<I', 10) + b'WAVEjunk')
    paths = Paths(str(tmp_path / 'data'), 'tts_id', base=tmp_path)
    cleaner = Cleaner('english_cleaners', use_phonemes=False, lang='en-us')
    ids = ['good', 'clipped', 'quiet', 'stereo', 'fast', 'empty', 'corrupt']
    dataset, cleaned = process_all(paths, dsp, cleaner,
                                   {i: 'hello world' for i in ids},
                                   sorted(wav_dir.glob('*.wav')),
                                   n_workers=2)
    done = {d[0] for d in dataset}
    assert done == {'good', 'clipped', 'quiet', 'stereo', 'fast'}
    assert {c[0] for c in cleaned} == done
    out = capsys.readouterr().out
    assert 'corrupt.wav' in out and 'empty.wav' in out
    for wav_id in done:
        mel = np.load(paths.mel / f'{wav_id}.npy')
        pitch = np.load(paths.raw_pitch / f'{wav_id}.npy')
        assert mel.shape[0] == dsp.n_mels and np.isfinite(mel).all()
        assert mel.shape[1] == len(pitch)
        assert len(np.load(paths.quant / f'{wav_id}.npy')) > 0
    q = np.load(paths.quant / 'clipped.npy')
    assert q.min() >= 0 and q.max() < 2 ** dsp.bits
    assert abs(np.load(paths.mel / 'fast.npy').shape[1]
               - (1 + SR // dsp.hop_length)) <= 2


def test_preprocess_refusals(tmp_path):
    from forwardtacotron_tpu_torch import preprocess
    with pytest.raises(SystemExit):
        preprocess.main(['--path', str(tmp_path), '--metadata_format',
                         'multispeaker', '--device', 'cpu'])
    with pytest.raises(SystemExit):
        preprocess.main(['--path', str(tmp_path), '--num_workers', '0',
                         '--device', 'cpu'])


def test_mu_law_labels_equal_jax():
    """The labels of a float32 numpy wav are floored from float64
    quotients, as the JAX package's numpy path does (a float32 quotient
    put 13 of these 2e6 labels one apart)."""
    from forwardtacotron_tpu.dsp.audio import DSP as JDSP
    from forwardtacotron_tpu_torch.dsp.audio import encode_mu_law
    rng = np.random.RandomState(0)
    y = (rng.rand(2_000_000) * 2 - 1).astype(np.float32)
    got, want = encode_mu_law(y, 512), JDSP.encode_mu_law(y, 512)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
