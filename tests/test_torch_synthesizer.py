"""The port's notebook `Synthesizer` against the JAX package's
(`notebook_utils/synthesize.py`) on the CPU at a tiny width: the same
`.fjax` TTS and WaveRNN checkpoints, the same official HiFi-GAN and hub
MelGAN files, the same text.

The port synthesizes in float32 here (the JAX model's CPU path); mels
agree within L1 < 1e-3 with equal lengths, the GAN wavs at
tests/test_torch_gan_vocoders.py's atol 1e-4, Griffin-Lim with JAX's
phase draw fed to the port (its magnitudes end to end, its waveform
stage at tests/test_torch_dsp.py's 1e-3 of the peak), WaveRNN (sampled,
Philox against JAX's PRNG) in shape and length. The notebook
`notebooks/synthesize_torch.ipynb` drives the port alone.
"""
import json
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

ROOT = Path(__file__).resolve().parent.parent
TEXT = 'The birch canoe slid on the smooth planks.'
TINY_FT = {
    'embed_dims': 16, 'series_embed_dims': 8,
    'durpred_conv_dims': 8, 'durpred_rnn_dims': 4, 'durpred_dropout': 0.5,
    'pitch_conv_dims': 8, 'pitch_rnn_dims': 4, 'pitch_dropout': 0.5,
    'pitch_strength': 1.0,
    'energy_conv_dims': 8, 'energy_rnn_dims': 4, 'energy_dropout': 0.5,
    'energy_strength': 1.0,
    'rnn_dims': 8, 'prenet_dims': 8, 'prenet_k': 2,
    'postnet_num_highways': 1, 'prenet_dropout': 0.5,
    'postnet_dims': 8, 'postnet_k': 2, 'prenet_num_highways': 1,
    'postnet_dropout': 0.0,
}
TINY_VOC = {'mode': 'RAW', 'upsample_factors': [4, 4], 'rnn_dims': 16,
            'fc_dims': 16, 'compute_dims': 8, 'res_out_dims': 8,
            'res_blocks': 1, 'pad': 2}
TINY_HIFI = {'resblock': '1', 'upsample_rates': [4, 4],
             'upsample_kernel_sizes': [8, 8], 'upsample_initial_channel': 16,
             'resblock_kernel_sizes': [3], 'resblock_dilation_sizes': [[1, 3]]}
HOP, N_MELS = 16, 12
GAN_ATOL = 1e-4          # tests/test_torch_gan_vocoders.py


def _config():
    from forwardtacotron_tpu.utils.files import read_config
    cfg = read_config(ROOT / 'config.yaml')
    cfg['dsp'].update(n_fft=64, win_length=64, hop_length=HOP,
                      num_mels=N_MELS)
    cfg['forward_tacotron']['model'] = dict(TINY_FT)
    cfg['vocoder']['model'] = dict(TINY_VOC)
    return cfg


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    from forwardtacotron_tpu.models.forward_tacotron import (
        ForwardTacotron as JaxFT)
    from forwardtacotron_tpu.models.wavernn import WaveRNN as JaxWaveRNN
    from forwardtacotron_tpu.utils.checkpoints import save_checkpoint
    from forwardtacotron_tpu_torch.models.hifigan import (
        HiFiGANGenerator, weight_norm_state_dict)
    from forwardtacotron_tpu_torch.models.melgan import MelGANGenerator
    d = tmp_path_factory.mktemp('synthesizer')
    cfg = _config()
    model = JaxFT.from_config(cfg)
    variables = model.init({'params': jax.random.PRNGKey(1)},
                           jnp.ones((1, 8), jnp.int32), 32,
                           method='generate', x_len=jnp.asarray([8]))
    save_checkpoint(jax.tree.map(np.asarray, variables), cfg,
                    d / 'tts.fjax', step=2000)
    voc = JaxWaveRNN.from_config(cfg)
    voc_vars = voc.init(jax.random.PRNGKey(2), jnp.zeros((1, 6 * HOP)),
                        jnp.zeros((1, 10, N_MELS)))
    save_checkpoint(jax.tree.map(np.asarray, voc_vars), cfg,
                    d / 'voc.fjax', step=5)
    torch.manual_seed(3)
    hifi = HiFiGANGenerator.from_config(TINY_HIFI, n_mels=N_MELS)
    torch.save({'generator': weight_norm_state_dict(hifi)}, d / 'g_00000001')
    (d / 'config.json').write_text(json.dumps(dict(TINY_HIFI,
                                                   num_mels=N_MELS)))
    melgan = MelGANGenerator(n_mels=N_MELS, base_channels=16,
                             upsample_rates=(8, 8, 2, 2))
    torch.save({'model_g': weight_norm_state_dict(melgan)}, d / 'm.pt')
    return d


@pytest.fixture(scope='module')
def synths(files):
    from notebook_utils.synthesize import Synthesizer as JaxSynthesizer
    from forwardtacotron_tpu_torch.notebook_utils.synthesize import (
        Synthesizer)
    kw = dict(voc_path=str(files / 'voc.fjax'),
              hifigan_path=str(files / 'g_00000001'),
              melgan_path=str(files / 'm.pt'))
    ours = Synthesizer(str(files / 'tts.fjax'), device='cpu',
                       compute_dtype=torch.float32, **kw)
    return ours, JaxSynthesizer(str(files / 'tts.fjax'), **kw)


@pytest.mark.parametrize('knobs', [{}, {'alpha': 0.8, 'pitch_scale': 1.5,
                                        'energy_scale': 0.7}],
                         ids=['default', 'knobs'])
def test_mel_matches_jax(files, knobs):
    from notebook_utils.synthesize import Synthesizer as JaxSynthesizer
    from forwardtacotron_tpu_torch.notebook_utils.synthesize import (
        Synthesizer)
    ours = Synthesizer(str(files / 'tts.fjax'), device='cpu',
                       compute_dtype=torch.float32)
    ref = JaxSynthesizer(str(files / 'tts.fjax'))
    # no generator loaded: 'hifigan' and 'melgan' return the mel
    for voc in ('hifigan', 'melgan'):
        got = ours(TEXT, voc_model=voc, **knobs)
        want = np.asarray(ref(TEXT, voc_model=voc, **knobs))
        assert got.shape == want.shape and got.shape[0] == N_MELS
        l1 = float(np.abs(got - want).mean())
        print(f'{voc} mel {got.shape}: L1 {l1:.3g}')
        assert l1 < 1e-3


@pytest.mark.parametrize('voc', ['hifigan', 'melgan'])
def test_gan_wavs_match_jax(synths, voc):
    ours, ref = synths
    got = ours(TEXT, voc_model=voc)
    want = np.asarray(ref(TEXT, voc_model=voc))
    assert got.dtype == np.float32 and got.shape == want.shape
    err = float(np.abs(got - want).max())
    print(f'{voc} wav {got.shape}: max |port - jax| {err:.3g}')
    assert err <= GAN_ATOL


def _jax_draw(shape, seed):
    return torch.from_numpy(np.array(jax.random.uniform(
        jax.random.PRNGKey(seed), tuple(shape))))


def _spectral_convergence(wav, ref):
    from forwardtacotron_tpu_torch.dsp.stft import magnitude_stft
    a, b = (magnitude_stft(torch.from_numpy(np.array(w)), 64,
                           HOP, 64).numpy() for w in (wav, ref))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_griffinlim_matches_jax_with_the_same_draw(synths, monkeypatch):
    """JAX's phase draw fed to the port. End to end, the magnitudes agree
    (spectral convergence <= 1e-3, chip_smoke's bar for Griffin-Lim card
    against CPU; measured 2.6e-4); the waveforms differ by ~2e-3 of the
    peak, because the NNLS and 32 momentum rounds amplify the mels'
    ~1e-7 difference (JAX against itself moves 3.3e-5 for a 1e-6 scale
    of its magnitude). With the same mel and the same NNLS magnitude, the
    port's Griffin-Lim stage is held at 1e-3 of the peak, as
    tests/test_torch_dsp.py holds it."""
    from forwardtacotron_tpu.dsp import griffinlim as jgl
    from forwardtacotron_tpu_torch.dsp import griffinlim as port_gl
    from forwardtacotron_tpu_torch.notebook_utils import synthesize as syn
    ours, ref = synths
    monkeypatch.setattr(port_gl, 'initial_phase', _jax_draw)
    got = ours(TEXT, voc_model='griffinlim')
    want = np.asarray(ref(TEXT, voc_model='griffinlim'))
    assert got.shape == want.shape
    sc = _spectral_convergence(got, want)
    print(f'griffinlim {got.shape}: spectral convergence {sc:.3g}, max '
          f'|port - jax| {float(np.abs(got - want).max()):.3g}, peak '
          f'{float(np.abs(want).max()):.3g}')
    assert sc <= 1e-3
    from gen_forward import synthesize as jax_synthesize
    mel = np.asarray(jax_synthesize(ref.tts_model, ref.tts_variables,
                                    ref.tokenizer(ref.cleaner(TEXT)), 1.0,
                                    1.0)[0])
    lin = jgl.nnls_mel_inverse(jnp.asarray(ref.dsp.mel_basis),
                               jnp.exp(jnp.asarray(mel.T)))

    def jax_nnls(basis, magnitude, n_iter):
        np.testing.assert_allclose(magnitude.numpy(), np.exp(mel.T),
                                   rtol=1e-6)
        assert n_iter == 200
        return torch.from_numpy(np.array(lin))
    monkeypatch.setattr(syn, 'synthesize', lambda *a, **k: mel)
    monkeypatch.setattr(port_gl, 'nnls_mel_inverse', jax_nnls)
    got = ours(TEXT, voc_model='griffinlim')
    err = float(np.abs(got - want).max())
    print(f'griffinlim, same mel and NNLS: max |port - jax| {err:.3g}')
    assert err <= 1e-3 * float(np.abs(want).max())


def test_wavernn_shape_and_length_match_jax(synths):
    ours, ref = synths
    got = ours(TEXT, voc_model='wavernn')
    want = np.asarray(ref(TEXT, voc_model='wavernn'))
    assert got.ndim == 1 and got.shape == want.shape and len(got) > 0
    assert np.all(np.isfinite(got)) and np.abs(got).max() <= 1.0


def test_checkpoints_of_the_port_and_refusals(files, tmp_path):
    """A `.pt` and a `.dcp` of the port's TTS load as the `.fjax` does
    (the same mel); a speaker outside the model's range is refused."""
    from forwardtacotron_tpu_torch.notebook_utils.synthesize import (
        Synthesizer)
    from forwardtacotron_tpu_torch.utils.checkpoints import save_directory
    from forwardtacotron_tpu_torch.weights import load_fjax, tts_state_dict
    payload = load_fjax(files / 'tts.fjax')
    port = {'model': tts_state_dict(payload['model'], payload['config'],
                                    payload['step']),
            'optim': None, 'config': payload['config'],
            'step': payload['step']}
    torch.save(port, tmp_path / 'tts.pt')
    save_directory(port, tmp_path / 'tts.dcp')
    mels = [Synthesizer(str(p), device='cpu')(TEXT, voc_model='hifigan')
            for p in (files / 'tts.fjax', tmp_path / 'tts.pt',
                      tmp_path / 'tts.dcp')]
    np.testing.assert_array_equal(mels[1], mels[0])
    np.testing.assert_array_equal(mels[2], mels[0])
    with pytest.raises(ValueError, match='speaker 1 out of range'):
        Synthesizer(str(tmp_path / 'tts.pt'), device='cpu')(TEXT, speaker=1)


def test_notebook_drives_the_port():
    nb = json.loads((ROOT / 'notebooks' / 'synthesize_torch.ipynb')
                    .read_text(encoding='utf-8'))
    assert nb['nbformat'] == 4
    code = [''.join(c['source']) for c in nb['cells']
            if c['cell_type'] == 'code']
    assert code, 'notebook has no code cells'
    for i, src in enumerate(code):
        compile(src, f'synthesize_torch.ipynb cell {i}', 'exec')
    joined = '\n'.join(code)
    assert ('from forwardtacotron_tpu_torch.notebook_utils.synthesize '
            'import Synthesizer') in joined
    assert 'griffinlim' in joined
    assert not re.search(r'\bjax\b', joined)
    raw = (ROOT / 'notebooks' / 'synthesize_torch.ipynb').read_text(
        encoding='utf-8')
    assert 'forwardtacotron_tpu.' not in raw
    assert 'notebook_utils.synthesize import' not in raw.replace(
        'forwardtacotron_tpu_torch.notebook_utils.synthesize import', '')
