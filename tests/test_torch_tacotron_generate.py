"""The teacher's free-running synthesis in the port (`Tacotron.generate`)
against the JAX package's `method='generate'` on the CPU, same weights
(through `tacotron_state_dict`), and the `gen_tacotron` CLI.

At r = 1 and r = 2, 40 steps, on a batch of two padded texts, in two
cases: a stop threshold chosen from the run so that the criterion fires
mid-run (the port reads its device flag every 8 steps, so it runs past
the stop and must zero what it ran), and one that never fires. Mel,
linear and attention at atol 1e-4 and an equal `n_valid`. The CLI runs
with griffinlim and a tiny WaveRNN on a `.pt` of the teacher.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

CFG = {'embed_dims': 16, 'encoder_dims': 128, 'decoder_dims': 256,
       'postnet_dims': 8, 'encoder_k': 2, 'lstm_dims': 16, 'postnet_k': 2,
       'num_highways': 2, 'dropout': 0.5, 'stop_threshold': -11}
NUM_CHARS, N_MELS, STEPS = 30, 6, 40
NEVER = -1e9


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """The decoder is a loop of small ops: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _text():
    rng = np.random.RandomState(0)
    x = np.zeros((2, 9), np.int64)
    x[0] = rng.randint(1, NUM_CHARS, 9)
    x[1, :5] = rng.randint(1, NUM_CHARS, 5)
    return x


@functools.lru_cache(maxsize=1)
def _variables():
    """JAX weights with random batch-norm statistics, as numpy."""
    from forwardtacotron_tpu.models.tacotron import Tacotron as JaxTaco
    model = JaxTaco(num_chars=NUM_CHARS, n_mels=N_MELS, **CFG)
    mel = np.zeros((2, 10, N_MELS), np.float32)
    variables = jax.jit(lambda k: model.init(
        {'params': k}, jnp.asarray(_text()), jnp.asarray(mel), 2,
        train=False))(jax.random.PRNGKey(3))
    rng = np.random.RandomState(5)

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else
                (rng.randn(*v.shape) * 0.1 if k == 'mean'
                 else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
                for k, v in tree.items()}
    return {'params': jax.tree.map(np.asarray, variables['params']),
            'batch_stats': fill(variables['batch_stats'])}


@functools.lru_cache(maxsize=None)
def _jax_generate(r, threshold):
    from forwardtacotron_tpu.models.tacotron import Tacotron as JaxTaco
    model = JaxTaco(num_chars=NUM_CHARS, n_mels=N_MELS,
                    **dict(CFG, stop_threshold=threshold))
    out = jax.jit(lambda v, x: model.apply(v, x, STEPS, r,
                                           method='generate'))(
        _variables(), jnp.asarray(_text()))
    return tuple(np.asarray(o) for o in out)


def _threshold(r):
    """A threshold at which the stop criterion first fires at the step of
    least frame maximum among the eligible steps of the first 24 frames
    (halfway between it and the next larger maximum)."""
    mel = _jax_generate(r, NEVER)[0]
    steps = mel.reshape(2, STEPS // r, r, N_MELS).max(axis=(0, 2, 3))
    eligible = [t for t in range(STEPS // r) if (t + 1) * r > 10
                and (t + 1) * r <= 24]
    peaks = sorted(steps[eligible])
    return float((peaks[0] + peaks[1]) / 2)


def _port_model(threshold):
    from forwardtacotron_tpu_torch.models.tacotron import Tacotron
    from forwardtacotron_tpu_torch.weights import tacotron_state_dict
    model = Tacotron(num_chars=NUM_CHARS, n_mels=N_MELS, **CFG)
    model.load_state_dict(tacotron_state_dict(
        _variables(), dict(CFG, stop_threshold=threshold)), strict=True)
    return model


@pytest.mark.parametrize('stops', [True, False])
@pytest.mark.parametrize('r', [1, 2])
def test_generate_matches_jax(r, stops):
    threshold = _threshold(r) if stops else NEVER
    ref = _jax_generate(r, threshold)
    model = _port_model(threshold).train()    # generate runs in eval mode
    mel, linear, attn, n_valid = model.generate(torch.from_numpy(_text()),
                                                STEPS, r)
    assert model.training
    assert n_valid == int(ref[3])
    if stops:
        # a stop between two reads of the flag
        assert 10 < n_valid <= 24 and (n_valid // r) % 8 != 0
    else:
        assert n_valid == STEPS
    for name, got, want in (('mel', mel, ref[0]), ('linear', linear, ref[1]),
                            ('attention', attn, ref[2])):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4,
                                   err_msg=name)
    assert torch.all(mel[:, n_valid:] == 0)


TINY_VOC = {'mode': 'RAW', 'upsample_factors': [4, 4], 'rnn_dims': 16,
            'fc_dims': 16, 'compute_dims': 8, 'res_out_dims': 8,
            'res_blocks': 1, 'pad': 2}
HOP = 16


def test_gen_tacotron_cli(tmp_path, monkeypatch):
    from scipy.io import wavfile
    from forwardtacotron_tpu_torch import gen_tacotron
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.utils.checkpoints import save_checkpoint
    cfg = default_config()
    cfg['dsp'].update(n_fft=64, win_length=64, hop_length=HOP,
                      num_mels=N_MELS)
    cfg['tacotron']['model'] = dict(CFG, stop_threshold=NEVER)
    cfg['vocoder']['model'] = dict(TINY_VOC)
    torch.manual_seed(0)
    model = gen_tacotron.Tacotron.from_config(cfg)
    save_checkpoint(model, None, cfg, tmp_path / 'taco.pt', step=2000)
    monkeypatch.chdir(tmp_path)
    base = ['--checkpoint', str(tmp_path / 'taco.pt'), '--device', 'cpu',
            '--steps', '24', '-i', 'The birch canoe slid.']
    out = gen_tacotron.main(base + ['griffinlim'])
    assert [p.name for p in out] == ['1_tacotron_2k_griffinlim.wav']
    sr, wav = wavfile.read(out[0])
    assert sr == cfg['dsp']['sample_rate'] and wav.dtype == np.int16
    assert len(wav) == 23 * HOP
    out = gen_tacotron.main(base + ['wavernn', '--target', '64',
                                    '--overlap', '16'])
    assert [p.name for p in out] == ['1_tacotron_2k_wavernn.wav']
    _, wav = wavfile.read(out[0])
    assert len(wav) == 23 * HOP and np.abs(wav).max() > 0
    out = gen_tacotron.main(base + ['hifigan'])
    mel = np.load(out[0])
    ids = gen_tacotron.text_to_ids('The birch canoe slid.', cfg)
    np.testing.assert_array_equal(
        mel[0], gen_tacotron.synthesize(model.eval(), ids, 24))
    with pytest.raises(SystemExit):
        gen_tacotron.main(base + ['--speaker', '1', 'griffinlim'])
