"""The port's DSP (CPU) against the JAX package's with the same inputs.

Tolerances: the mel filterbank at 1e-6 (both compute it in numpy);
STFT and ISTFT at 1e-4 relative to the signal's scale (the STFT gate of
docs/benchmarks.md); `wav_to_mel` against tests/resources/golden_mel.npy
at the JAX test's own bounds (atol 2e-3, mean < 2e-4) and against JAX at
1e-4 of the peak before the log (after it, two float32 FFTs differ by
up to 1.1e-3 where the mel sits at the 1e-5 clip floor, the JAX
package's own distance from the float64 golden there being 1.2e-3: the
log-mel is held to the golden's bounds); NNLS at 1e-4 of the largest
value; Griffin-Lim from the same uniform draw at 1e-3 of the waveform's
peak (32 momentum iterations amplify float32 FFT rounding; measured
3.6e-4 at a peak of 0.81, printed by the test).
"""
import math
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

RES = pathlib.Path(__file__).parent / 'resources'
ROOT = pathlib.Path(__file__).parent.parent
N_FFT, HOP, WIN = 256, 64, 256


def _signal(n=4000, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 22050.0
    y = 0.5 * np.sin(2 * math.pi * 220 * t) + 0.1 * rng.randn(n)
    return y.astype(np.float32)


@pytest.fixture
def config():
    from forwardtacotron_tpu_torch.config import default_config
    return default_config()


@pytest.mark.parametrize('sr,n_fft,n_mels,fmin,fmax', [
    (22050, 1024, 80, 0, 8000), (16000, 512, 40, 50, None)])
def test_mel_filterbank_equals_jax(sr, n_fft, n_mels, fmin, fmax):
    from forwardtacotron_tpu.dsp.stft import mel_filterbank as jfb
    from forwardtacotron_tpu_torch.dsp.stft import mel_filterbank
    ours = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    ref = jfb(sr, n_fft, n_mels, fmin, fmax)
    assert ours.shape == ref.shape == (n_mels, n_fft // 2 + 1)
    np.testing.assert_allclose(ours, ref, atol=1e-6)


@pytest.mark.parametrize('center', [True, False])
def test_stft_matches_jax(center):
    from forwardtacotron_tpu.dsp.stft import stft as jstft
    from forwardtacotron_tpu_torch.dsp.stft import stft
    y = np.stack([_signal(seed=0), _signal(seed=1)])
    ours = stft(torch.from_numpy(y), N_FFT, HOP, WIN, center=center).numpy()
    ref = np.asarray(jstft(jnp.asarray(y), N_FFT, HOP, WIN, center=center))
    assert ours.shape == ref.shape
    scale = float(np.abs(ref).max())
    assert float(np.abs(ours - ref).max()) <= 1e-4 * scale


def test_istft_matches_jax_and_round_trips():
    from forwardtacotron_tpu.dsp.stft import istft as jistft
    from forwardtacotron_tpu_torch.dsp.stft import istft, stft
    y = _signal(4096)
    spec = stft(torch.from_numpy(y), N_FFT, HOP, WIN)
    for length in (None, 4096):
        ours = istft(spec, N_FFT, HOP, WIN, length=length).numpy()
        ref = np.asarray(jistft(jnp.asarray(spec.numpy()), N_FFT, HOP, WIN,
                                length=length))
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=1e-4)
    np.testing.assert_allclose(ours, y, atol=1e-4)


def test_wav_to_mel_matches_golden_and_jax(config):
    from forwardtacotron_tpu.dsp.audio import DSP as JDSP
    from forwardtacotron_tpu_torch.dsp.audio import DSP
    dsp = DSP.from_config(config, device='cpu')
    jdsp = JDSP.from_config(config)
    wav = dsp.load_wav(RES / 'golden_speech.wav')
    np.testing.assert_array_equal(wav, jdsp.load_wav(
        RES / 'golden_speech.wav'))
    golden = np.load(RES / 'golden_mel.npy')
    mel = dsp.wav_to_mel(wav)
    assert mel.shape == golden.shape
    np.testing.assert_allclose(mel, golden, atol=2e-3)
    assert float(np.mean(np.abs(mel - golden))) < 2e-4
    ref = jdsp.wav_to_mel(wav)
    np.testing.assert_allclose(mel, ref, atol=2e-3)
    assert float(np.mean(np.abs(mel - ref))) < 2e-4
    raw = dsp.wav_to_mel(wav, normalize=False)
    raw_ref = jdsp.wav_to_mel(wav, normalize=False)
    assert float(np.abs(raw - raw_ref).max()) <= 1e-4 * float(raw_ref.max())
    # center=False on the caller's reflect padding, and the raw mel
    pad = config['dsp']['n_fft'] // 2
    padded = np.pad(wav, (pad, pad), mode='reflect')
    np.testing.assert_allclose(dsp.wav_to_mel(padded, center=False), mel,
                               atol=1e-5)
    np.testing.assert_allclose(dsp.normalize(raw), mel, atol=1e-5)
    np.testing.assert_allclose(dsp.denormalize(mel), np.maximum(raw, 1e-5),
                               rtol=1e-4)


def test_nnls_mel_inverse_matches_jax(config):
    from forwardtacotron_tpu.dsp.griffinlim import nnls_mel_inverse as jnnls
    from forwardtacotron_tpu_torch.dsp.griffinlim import nnls_mel_inverse
    from forwardtacotron_tpu_torch.dsp.stft import mel_filterbank
    basis = mel_filterbank(22050, N_FFT, 20, 0, 8000)
    mel = np.exp(np.random.RandomState(2).randn(12, 20).astype(np.float32)
                 - 3.0)
    ours = nnls_mel_inverse(torch.from_numpy(basis), torch.from_numpy(mel),
                            n_iter=50).numpy()
    ref = np.asarray(jnnls(jnp.asarray(basis), jnp.asarray(mel), n_iter=50))
    assert ours.shape == ref.shape == (12, N_FFT // 2 + 1)
    assert float(ours.min()) >= 0.0
    assert float(np.abs(ours - ref).max()) <= 1e-4 * float(np.abs(ref).max())


def test_griffinlim_matches_jax_with_the_same_draw():
    from forwardtacotron_tpu.dsp.griffinlim import griffinlim as jgl
    from forwardtacotron_tpu_torch.dsp.griffinlim import griffinlim
    from forwardtacotron_tpu_torch.dsp.stft import magnitude_stft
    mag = magnitude_stft(torch.from_numpy(_signal(3000)), N_FFT, HOP, WIN)
    key = jax.random.PRNGKey(3)
    u = np.array(jax.random.uniform(key, mag.shape))
    ref = np.asarray(jgl(jnp.asarray(mag.numpy()), key, N_FFT, HOP, WIN))
    ours = griffinlim(mag, N_FFT, HOP, WIN, uniform=torch.from_numpy(u))
    assert ours.shape == ref.shape
    err = float(np.abs(ours.numpy() - ref).max())
    print(f'griffinlim max |port - jax| {err:.3g}, peak '
          f'{float(np.abs(ref).max()):.3g}')
    assert err <= 1e-3 * float(np.abs(ref).max())


def test_dsp_griffinlim_is_seeded_and_shaped(config):
    from forwardtacotron_tpu_torch.dsp.audio import DSP
    from forwardtacotron_tpu_torch.dsp.griffinlim import (initial_phase,
                                                          mel_to_wav)
    config['dsp'].update(n_fft=N_FFT, hop_length=HOP, win_length=WIN,
                         num_mels=20)
    dsp = DSP.from_config(config, device='cpu')
    mel = dsp.wav_to_mel(_signal(6000))                  # (n_mels, T)
    a = dsp.griffinlim(mel, n_iter=4, seed=1)
    assert a.shape == ((mel.shape[1] - 1) * dsp.hop_length,)
    np.testing.assert_array_equal(a, dsp.griffinlim(mel.T, n_iter=4,
                                                    seed=1))
    assert not np.array_equal(a, dsp.griffinlim(mel, n_iter=4, seed=2))
    u = initial_phase((mel.shape[1], dsp.n_fft // 2 + 1), 1)
    b = mel_to_wav(torch.from_numpy(mel.T), torch.from_numpy(dsp.mel_basis),
                   dsp.n_fft, dsp.hop_length, dsp.win_length, n_iter=4,
                   uniform=u)
    np.testing.assert_array_equal(a, b.numpy())


def test_dsp_helpers_match_jax(config, tmp_path):
    from forwardtacotron_tpu.dsp.audio import DSP as JDSP
    from forwardtacotron_tpu_torch.dsp.audio import DSP
    dsp = DSP.from_config(config, device='cpu')
    jdsp = JDSP.from_config(config)
    y = np.concatenate([np.zeros(5000, np.float32), _signal(8000),
                        np.zeros(7000, np.float32)])
    np.testing.assert_array_equal(dsp.trim_silence(y), jdsp.trim_silence(y))
    x = np.clip(_signal(500), -1, 1)
    for bits in (9, 16):
        np.testing.assert_allclose(dsp.float_2_label(x, bits),
                                   jdsp.float_2_label(x, bits))
    np.testing.assert_allclose(dsp.encode_mu_law(x, 512),
                               jdsp.encode_mu_law(x, 512))
    labels = dsp.encode_mu_law(x, 512)
    np.testing.assert_allclose(dsp.decode_mu_law(labels, 512),
                               jdsp.decode_mu_law(labels, 512), atol=1e-6)
    np.testing.assert_allclose(
        dsp.encode_mu_law(torch.from_numpy(x), 512).numpy(), labels)
    with pytest.raises(ValueError, match='peak'):
        dsp.float_2_label(np.array([1.5]), 9)
    # save -> load round trip: int16 as it is, float scaled and clipped
    dsp.save_wav(x, tmp_path / 'f.wav')
    np.testing.assert_allclose(dsp.load_wav(tmp_path / 'f.wav'), x,
                               atol=1.0 / 16384)
    pcm = (x * 32767).astype(np.int16)
    dsp.save_wav(pcm, tmp_path / 'i.wav')
    np.testing.assert_array_equal(dsp.load_wav(tmp_path / 'i.wav'),
                                  pcm.astype(np.float32) / 32768.0)


def test_dsp_device_defaults_to_cuda(config, monkeypatch):
    from forwardtacotron_tpu_torch.dsp.audio import DSP
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        DSP.from_config(config)
