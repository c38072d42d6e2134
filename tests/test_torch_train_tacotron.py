"""The port's data path end to end on the CPU, through the CLIs' `main`
at a tiny width: `preprocess` on a seeded LJSpeech-layout corpus ->
`train_tacotron` (a few steps at r=2 and r=1, then alignment) ->
`--force_align` -> `--extract_pitch` -> `--force_gta` -> the port's
`train_forward` for one step on what the port alone wrote; and the
refusals by name. Each artifact is checked for its shape and its
invariants (durations summing to mel_len, attention scores in [0, 1]);
the values are held to the JAX package in tests/test_torch_align.py,
tests/test_torch_preprocess.py and tests/test_torch_tacotron.py.
"""
import wave

import numpy as np
import pytest
import torch

SR = 22050
TEXTS = ['Printing, in the only sense with which we are concerned.',
         'The cat sat on the mat.', 'She sells sea shells.',
         'One two three four five six.', 'A quick brown fox.',
         'Hello there, general.']
TACO = {'embed_dims': 16, 'encoder_dims': 128, 'decoder_dims': 256,
        'postnet_dims': 8, 'encoder_k': 2, 'lstm_dims': 32, 'postnet_k': 2,
        'num_highways': 1, 'dropout': 0.5, 'stop_threshold': -11}
FORWARD = {
    'embed_dims': 16, 'series_embed_dims': 8,
    'durpred_conv_dims': 8, 'durpred_rnn_dims': 4, 'durpred_dropout': 0.5,
    'pitch_conv_dims': 8, 'pitch_rnn_dims': 4, 'pitch_dropout': 0.5,
    'pitch_strength': 1.0,
    'energy_conv_dims': 8, 'energy_rnn_dims': 4, 'energy_dropout': 0.5,
    'energy_strength': 1.0,
    'rnn_dims': 12, 'prenet_dims': 8, 'prenet_k': 2, 'prenet_dropout': 0.5,
    'prenet_num_highways': 1, 'postnet_dims': 8, 'postnet_k': 2,
    'postnet_num_highways': 1, 'postnet_dropout': 0.0,
}


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """The teacher's decoder is a loop of many small ops: with one
    intra-op thread a test worker runs it faster and leaves the other
    workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_corpus(root):
    """Five-harmonic wavs of 0.3-0.5 s with an F0 glide, silence at both
    ends, and a metadata.csv line each."""
    rng = np.random.RandomState(0)
    (root / 'wavs').mkdir(parents=True)
    lines = []
    for i, text in enumerate(TEXTS):
        n = int(SR * rng.uniform(0.3, 0.5))
        f0 = 120 + 40 * np.sin(2 * np.pi * 1.5 * np.arange(n) / SR)
        phase = 2 * np.pi * np.cumsum(f0) / SR
        y = sum(0.3 / k * np.sin(k * phase) for k in range(1, 6))
        y = np.concatenate([np.zeros(3000), y, np.zeros(3000)])
        pcm = np.clip(np.round(y * 32767), -32768, 32767).astype('<i2')
        with wave.open(str(root / 'wavs' / f'u{i}.wav'), 'wb') as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SR)
            w.writeframes(pcm.tobytes())
        lines.append(f'u{i}|{text}|{text}')
    (root / 'metadata.csv').write_text('\n'.join(lines) + '\n')


def _config(tmp_path):
    import yaml
    from forwardtacotron_tpu_torch.config import default_config
    cfg = default_config()
    cfg['data_path'] = str(tmp_path / 'data')
    cfg['preprocessing']['n_val'] = 2
    cfg['tacotron']['model'] = dict(TACO)
    cfg['tacotron']['training']['schedule'] = ['2, 1e-3, 2, 4',
                                               '1, 1e-3, 3, 2']
    cfg['forward_tacotron']['model'] = dict(FORWARD)
    training = cfg['forward_tacotron']['training']
    training['schedule'] = ['1e-3, 1, 2']
    training['filter_attention'] = False      # an untrained teacher's
    path = tmp_path / 'config.yaml'
    path.write_text(yaml.safe_dump(cfg))
    return cfg, str(path)


def test_data_path_end_to_end(tmp_path, monkeypatch):
    from forwardtacotron_tpu_torch import (preprocess, train_forward,
                                           train_tacotron)
    from forwardtacotron_tpu_torch.utils.checkpoints import load_checkpoint
    from forwardtacotron_tpu_torch.utils.files import unpickle_binary
    from forwardtacotron_tpu_torch.utils.paths import Paths
    monkeypatch.setenv('FTT_BASE', str(tmp_path))
    _write_corpus(tmp_path / 'corpus')
    cfg, cfg_path = _config(tmp_path)
    cli = ['--config', cfg_path, '--device', 'cpu']

    train, val = preprocess.main(['--path', str(tmp_path / 'corpus'),
                                  '--num_workers', '2'] + cli)
    assert len(train) == 4 and len(val) == 2
    paths = Paths(cfg['data_path'], cfg['tts_model_id'])
    items = dict(train + val)

    assert train_tacotron.main(cli) == 3          # trains, then aligns
    ckpt = load_checkpoint(paths.taco_checkpoints / 'latest_model.pt')
    assert ckpt['step'] == 3 and int(ckpt['model']['decoder.r']) == 1
    scores = unpickle_binary(paths.data / 'att_score_dict.pkl')
    assert set(scores) == set(items)
    first = {}
    for item, frames in items.items():
        assert all(0.0 <= s <= 1.0 for s in scores[item])
        dur = np.load(paths.alg / f'{item}.npy')
        assert dur.dtype == np.int32 and dur.sum() == frames
        pitch = np.load(paths.phon_pitch / f'{item}.npy')
        energy = np.load(paths.phon_energy / f'{item}.npy')
        assert pitch.shape == energy.shape == dur.shape
        assert np.isfinite(pitch).all() and (energy > 0).any()
        first[item] = dur

    assert train_tacotron.main(cli + ['--force_align']) == 3
    for item, dur in first.items():         # the same teacher, the same
        np.testing.assert_array_equal(np.load(paths.alg / f'{item}.npy'),
                                      dur)
    assert train_tacotron.main(cli + ['--extract_pitch']) is None
    assert train_tacotron.main(cli + ['--force_gta']) == 3
    for item, frames in items.items():
        gta = np.load(paths.gta / f'{item}.npy')
        assert gta.shape == (80, frames) and np.isfinite(gta).all()

    assert train_forward.main(cli) == 1
    assert load_checkpoint(paths.forward_checkpoints
                           / 'latest_model.pt')['step'] == 1


def test_train_tacotron_refusals(tmp_path, monkeypatch):
    import yaml
    from forwardtacotron_tpu_torch import train_tacotron
    monkeypatch.setenv('FTT_BASE', str(tmp_path))
    cfg, cfg_path = _config(tmp_path)
    cli = ['--config', cfg_path, '--device', 'cpu']
    for flag in ('--force_align', '--force_gta'):
        with pytest.raises(SystemExit, match='train the teacher first'):
            train_tacotron.main(cli + [flag])
    # the options the JAX teacher ignores, and an unknown precision
    for key, value, error in (
            ('ema_decay', 0.999, 'training.ema_decay.*no such option'),
            ('precision', 'fp16', 'Unknown training precision')):
        bad = dict(cfg, tacotron=dict(cfg['tacotron'], training=dict(
            cfg['tacotron']['training'], **{key: value})))
        path = tmp_path / f'{key}.yaml'
        path.write_text(yaml.safe_dump(bad))
        with pytest.raises(ValueError, match=error):
            train_tacotron.main(['--config', str(path), '--device', 'cpu'])


def test_train_tacotron_seeds_from_fjax(tmp_path, monkeypatch):
    """A JAX `latest_model.fjax` (and no `latest_model.pt`) seeds the
    teacher's weights and step, as `--force_gta` then uses them."""
    import jax
    import jax.numpy as jnp
    from forwardtacotron_tpu.models.tacotron import Tacotron as JaxTaco
    from forwardtacotron_tpu.utils.checkpoints import save_checkpoint
    from forwardtacotron_tpu_torch import train_tacotron
    from forwardtacotron_tpu_torch.weights import tacotron_state_dict
    monkeypatch.setenv('FTT_BASE', str(tmp_path))
    cfg, cfg_path = _config(tmp_path)
    jmodel = JaxTaco(n_mels=80, **TACO)
    variables = jax.tree.map(np.asarray, jax.jit(lambda k: jmodel.init(
        {'params': k}, jnp.ones((1, 4), jnp.int32), jnp.zeros((1, 4, 80)),
        1, train=False))(jax.random.PRNGKey(2)))
    ckpt = tmp_path / 'checkpoints' / f'{cfg["tts_model_id"]}.tacotron'
    ckpt.mkdir(parents=True)
    save_checkpoint(variables, cfg, ckpt / 'latest_model.fjax', step=2)
    seen = {}

    def gta(model, train_set, val_set, save_path, r=1):
        seen.update({k: v.clone() for k, v in model.state_dict().items()})
    monkeypatch.setattr(train_tacotron, 'create_gta_features', gta)
    monkeypatch.setattr(train_tacotron, 'get_tts_datasets',
                        lambda *a, **k: (None, None))
    assert train_tacotron.main(['--config', cfg_path, '--device', 'cpu',
                                '--force_gta']) == 2
    want = tacotron_state_dict(variables, TACO, 2)
    assert set(seen) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(seen[k].numpy(), v.numpy(), err_msg=k)
