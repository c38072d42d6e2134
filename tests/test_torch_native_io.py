"""The port's wav reader and writer (`utils/native_audio.py` over its own
`native/audio_io.cc`, built by g++ at first use) against the JAX package's
`DSP.load_wav` / `save_wav`, which go through its committed native
library; and a 44.1 kHz corpus through both packages' `preprocess`.

Tolerances: the decoded, mixed and resampled samples bit for bit, at
16 / 22.05 / 24 / 44.1 / 48 kHz, 16 / 24 / 32-bit PCM and 32-bit float,
mono and stereo; the written files byte for byte, for floats inside and
outside [-1, 1] and for int16; a format the reader refuses raises IOError
in both. The preprocessed features as tests/test_torch_preprocess.py
holds them (mels within 1e-4 of the peak before the log, F0 within 1e-3
relative on the same voicing, quantized labels exact); the per-phoneme
energy is computed later from these mels (`align/features.py`).
"""
import struct

import numpy as np
import pytest

from test_torch_preprocess import _harmonic, _write_wav

SECONDS = 0.4
FORMATS = {'pcm16': (1, 16), 'pcm24': (1, 24), 'pcm32': (1, 32),
           'float32': (3, 32)}


def write_wav(path, frames, sr, fmt, bits):
    """A RIFF wav of `frames` (n, channels) in [-1, 1): PCM of `bits` bits
    (format 1) or IEEE float32 (format 3)."""
    frames = np.asarray(frames, np.float64)
    n, ch = frames.shape
    if fmt == 3:
        data = frames.astype('<f4').tobytes()
    else:
        ints = np.clip(np.round(frames * 2 ** (bits - 1)),
                       -2 ** (bits - 1), 2 ** (bits - 1) - 1).astype('<i4')
        data = (ints.astype('<i2').tobytes() if bits == 16 else
                ints.tobytes() if bits == 32 else
                ints.view(np.uint8).reshape(-1, 4)[:, :3].tobytes())
    block = ch * bits // 8
    header = (b'RIFF' + struct.pack('<I', 36 + len(data)) + b'WAVE'
              + b'fmt ' + struct.pack('<IHHIIHH', 16, fmt, ch, sr, sr * block,
                                      block, bits)
              + b'data' + struct.pack('<I', len(data)))
    path.write_bytes(header + data)


def _signal(sr, channels, seed):
    rng = np.random.RandomState(seed)
    n = int(SECONDS * sr)
    t = np.arange(n) / sr
    y = 0.5 * np.sin(2 * np.pi * rng.uniform(100, 300) * t)[:, None] \
        + 0.3 * rng.uniform(-1, 1, (n, channels))
    return np.clip(y, -1, 1 - 2 ** -23)


@pytest.fixture(scope='module')
def dsps():
    """(the port's DSP on the CPU, the JAX package's DSP) of config.yaml."""
    from forwardtacotron_tpu.dsp.audio import DSP as JaxDSP
    from forwardtacotron_tpu.utils import native_audio as jax_native
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.dsp.audio import DSP
    assert jax_native.available()       # JAX's DSP takes its native path
    cfg = default_config()
    return DSP.from_config(cfg, device='cpu'), JaxDSP.from_config(cfg)


@pytest.mark.parametrize('channels', [1, 2])
@pytest.mark.parametrize('fmt', list(FORMATS))
@pytest.mark.parametrize('sr', [16000, 22050, 24000, 44100, 48000])
def test_load_wav_equals_jax(dsps, tmp_path, sr, fmt, channels):
    dsp, jdsp = dsps
    path = tmp_path / 'x.wav'
    write_wav(path, _signal(sr, channels, sr + channels), sr, *FORMATS[fmt])
    got, want = dsp.load_wav(path), jdsp.load_wav(path)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    assert len(got) == int(SECONDS * sr) * dsp.sample_rate // sr
    np.testing.assert_array_equal(got, want)


def test_unreadable_formats_raise_as_in_jax(dsps, tmp_path):
    """8-bit PCM and a broken header: IOError from both packages."""
    dsp, jdsp = dsps
    pcm8 = tmp_path / 'pcm8.wav'
    data = bytes(range(256)) * 8
    pcm8.write_bytes(b'RIFF' + struct.pack('<I', 36 + len(data)) + b'WAVE'
                     + b'fmt ' + struct.pack('<IHHIIHH', 16, 1, 1, 22050,
                                             22050, 1, 8)
                     + b'data' + struct.pack('<I', len(data)) + data)
    broken = tmp_path / 'broken.wav'
    broken.write_bytes(b'RIFF' + struct.pack('<I', 10) + b'WAVEjunk')
    for path in (pcm8, broken, tmp_path / 'missing.wav'):
        for d in (dsp, jdsp):
            with pytest.raises(IOError):
                d.load_wav(path)


@pytest.mark.parametrize('kind', ['inside', 'outside', 'int16'])
def test_save_wav_writes_jax_bytes(dsps, tmp_path, kind):
    """Floats round to nearest after clipping, as JAX writes them (a
    truncating writer puts ~45% of these samples 1 LSB apart); int16 is
    written as it is. The module's `save_wav` writes the same file."""
    from forwardtacotron_tpu_torch.dsp.audio import save_wav
    dsp, jdsp = dsps
    rng = np.random.RandomState(3)
    wav = {'inside': rng.uniform(-1, 1, 10000).astype(np.float32),
           'outside': rng.uniform(-1.1, 1.1, 10000).astype(np.float32),
           'int16': rng.randint(-32768, 32768, 10000).astype(np.int16)}[kind]
    dsp.save_wav(wav, tmp_path / 'port.wav')
    save_wav(wav, tmp_path / 'module.wav', dsp.sample_rate)
    jdsp.save_wav(wav, tmp_path / 'jax.wav')
    want = (tmp_path / 'jax.wav').read_bytes()
    assert (tmp_path / 'port.wav').read_bytes() == want
    assert (tmp_path / 'module.wav').read_bytes() == want
    back = dsp.load_wav(tmp_path / 'port.wav')
    if kind != 'int16':
        # half an LSB of rounding, and the reader's scale of 2^15 against
        # the writer's 2^15 - 1 at full scale
        err = np.abs(back - np.clip(wav, -1, 1)).max()
        assert err <= 0.5 / 32767 + 1 / 32768


def test_quantizers_equal_the_numpy_versions():
    from forwardtacotron_tpu_torch.dsp.audio import (encode_mu_law,
                                                     float_2_label)
    from forwardtacotron_tpu_torch.utils import native_audio
    y = np.linspace(-1, 1, 513).astype(np.float32)
    np.testing.assert_array_equal(native_audio.encode_mu_law(y, 512),
                                  encode_mu_law(y, 512).astype(np.int32))
    np.testing.assert_array_equal(native_audio.float_to_label(y, 9),
                                  float_2_label(y, 9).astype(np.int32))
    x = np.array([0.5, -2.0, 1.0], dtype=np.float32)
    assert native_audio.peak_normalize(x) == 2.0
    np.testing.assert_array_equal(x, [0.25, -1.0, 0.5])


def test_library_is_built_from_the_port_sources(tmp_path, monkeypatch):
    """The host library comes from `forwardtacotron_tpu_torch/native/`
    into the package's git-ignored `build/`; without g++, or with a
    source that does not compile, building raises."""
    from forwardtacotron_tpu_torch import native
    pkg = native.SRC_DIR.parent
    lib = native.load('audio_io')
    assert lib._name == str(native.lib_path('audio_io'))
    assert native.lib_path('audio_io').parent == pkg / 'build'
    assert native.SRC_DIR == pkg / 'native'
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(native.shutil, 'which', lambda name: None)
    with pytest.raises(RuntimeError, match='g.. not found'):
        native.build('audio_io')
    monkeypatch.undo()
    src = tmp_path / 'src'
    src.mkdir()
    (src / 'audio_io.cc').write_text('this is not C++\n')
    monkeypatch.setattr(native, 'SRC_DIR', src)
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / 'build')
    with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
        native.build('audio_io')
    assert not list((tmp_path / 'build').glob('*'))


def test_preprocess_44k_corpus_matches_jax(tmp_path, monkeypatch):
    """An LJSpeech-layout corpus at 44.1 kHz (resampled to config.yaml's
    22.05 kHz on reading) through both packages' `preprocess.main`."""
    import test_torch_preprocess as tp
    from forwardtacotron_tpu_torch.config import default_config
    sr = 44100
    corpus = tmp_path / 'corpus'
    (corpus / 'wavs').mkdir(parents=True)
    lines = []
    for i, text in enumerate(['The cat sat on the mat.', 'One two three.',
                              'Hello world!', 'She sells sea shells.']):
        _write_wav(corpus / 'wavs' / f'LJ{i:03d}.wav',
                   _harmonic(14000 + 3000 * i, seed=i, sr=sr), sr=sr)
        lines.append(f'LJ{i:03d}|{text}|{text}')
    (corpus / 'metadata.csv').write_text('\n'.join(lines) + '\n',
                                         encoding='utf-8')
    config = default_config()
    config['preprocessing']['n_val'] = 1
    ours, theirs, train, val = tp.preprocess_both(tmp_path, monkeypatch,
                                                  config, corpus)
    assert len(train) == 3 and len(val) == 1
    tp.assert_same_features(ours, theirs, train + val)
