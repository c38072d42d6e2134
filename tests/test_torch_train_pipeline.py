"""The port's training pipeline on the CPU at a tiny size: its data layer
against the JAX package's (epoch plans and batches bit-equal), and its
trainer end to end: checkpoints that the JAX package's
`load_tts_checkpoint` converts with matching teacher-forced outputs
(atol 1e-4), that the port's `gen_forward` serves, and an interrupted
run that resumes to the same weights as an uninterrupted one (dropout 0,
so the runs are deterministic; atol 1e-6).
"""
import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

TINY_MODEL = {
    'embed_dims': 16, 'series_embed_dims': 8,
    'durpred_conv_dims': 8, 'durpred_rnn_dims': 4, 'durpred_dropout': 0.0,
    'pitch_conv_dims': 8, 'pitch_rnn_dims': 4, 'pitch_dropout': 0.0,
    'pitch_strength': 1.0,
    'energy_conv_dims': 8, 'energy_rnn_dims': 4, 'energy_dropout': 0.0,
    'energy_strength': 1.0,
    'rnn_dims': 12, 'prenet_dims': 8, 'prenet_k': 2, 'prenet_dropout': 0.0,
    'prenet_num_highways': 1, 'postnet_dims': 8, 'postnet_k': 2,
    'postnet_num_highways': 1, 'postnet_dropout': 0.0,
}
N_MELS = 80


def _make_dataset(data_dir, n_items=10, n_val=2):
    """Items of 4-8 phonemes, 1-3 frames each (tests/test_forward_trainer.py
    writes the same layout)."""
    from forwardtacotron_tpu_torch.utils.files import pickle_binary
    rng = np.random.RandomState(0)
    for d in ('mel', 'alg', 'phon_pitch', 'phon_energy'):
        (data_dir / d).mkdir(parents=True, exist_ok=True)
    index, text_dict, att = [], {}, {}
    for i in range(n_items):
        x_len = rng.randint(4, 9)
        dur = rng.randint(1, 4, size=x_len)
        mel_len = int(dur.sum())
        np.save(data_dir / 'mel' / f'{i}.npy',
                rng.randn(N_MELS, mel_len).astype(np.float32))
        np.save(data_dir / 'alg' / f'{i}.npy', dur.astype(np.int32))
        np.save(data_dir / 'phon_pitch' / f'{i}.npy',
                rng.randn(x_len).astype(np.float32))
        np.save(data_dir / 'phon_energy' / f'{i}.npy',
                rng.randn(x_len).astype(np.float32))
        text_dict[str(i)] = 'ðɛɹ wʌz ə kæt'[:x_len]
        index.append((str(i), mel_len))
        att[str(i)] = (1.0, 1.0) if i != 3 else (0.1, 1.0)
    pickle_binary(text_dict, data_dir / 'text_dict.pkl')
    pickle_binary(index[:-n_val], data_dir / 'train_dataset.pkl')
    pickle_binary(index[-n_val:], data_dir / 'val_dataset.pkl')
    pickle_binary(att, data_dir / 'att_score_dict.pkl')


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the trainer's small ops gain nothing from
    more, and several pytest workers with a thread per core each slowed
    these tests 15x."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    data = tmp_path_factory.mktemp('pipeline') / 'data'
    _make_dataset(data)
    return data


def test_datasets_equal_jax(dataset):
    from forwardtacotron_tpu.data import dataset as jds
    from forwardtacotron_tpu_torch.data import dataset as tds
    kw = dict(path=dataset, batch_size=3, r=1, max_mel_len=1250,
              filter_attention=True, filter_min_alignment=0.5,
              filter_min_sharpness=0.9, model_type='forward',
              mel_multiple=8)
    for ours, theirs in zip(tds.get_tts_datasets(**kw),
                            jds.get_tts_datasets(**kw)):
        assert len(ours) == len(theirs) > 0
        assert ours.buckets == theirs.buckets and ours.x_pad == theirs.x_pad
        for epoch, start in ((0, 0), (1, min(1, len(ours) - 1))):
            assert ours.epoch_plan(epoch) == theirs.epoch_plan(epoch)
            got = list(ours.batches(epoch, start))
            want = list(theirs.batches(epoch, start))
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                assert set(a) == set(b)
                for k in a:
                    if isinstance(a[k], np.ndarray):
                        assert a[k].dtype == b[k].dtype, k
                        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                    else:
                        assert a[k] == b[k], k


def _config(data):
    from forwardtacotron_tpu_torch.config import default_config
    cfg = default_config()
    cfg['data_path'] = str(data)
    cfg['forward_tacotron']['model'] = dict(TINY_MODEL)
    training = cfg['forward_tacotron']['training']
    training['schedule'] = ['1e-3, 6, 4']
    training['checkpoint_every'] = 1000
    return cfg


def _trainer(cfg, base):
    from forwardtacotron_tpu_torch.train.forward_trainer import (
        ForwardTrainer)
    from forwardtacotron_tpu_torch.utils.paths import Paths
    paths = Paths(cfg['data_path'], 'test_tts', base=base)
    return ForwardTrainer(paths, cfg, device='cpu'), paths


def _new_model(cfg):
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    torch.manual_seed(0)
    return ForwardTacotron.from_config(cfg)


def test_trainer_checkpoints_resume_and_serve(dataset, tmp_path):
    from forwardtacotron_tpu.utils.checkpoints import load_tts_checkpoint
    from forwardtacotron_tpu_torch import gen_forward
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.forward_trainer import (
        batch_to_device)
    from forwardtacotron_tpu_torch.utils.checkpoints import (load_checkpoint,
                                                             restore)
    cfg = _config(dataset)

    # uninterrupted: 6 steps (two per epoch, an evaluation after each)
    trainer, paths = _trainer(cfg, tmp_path / 'full')
    full = _new_model(cfg)
    before = copy.deepcopy(full.state_dict())
    assert trainer.train(full) == 6
    latest = paths.forward_checkpoints / 'latest_model.pt'
    payload = load_checkpoint(latest)
    assert payload['step'] == 6 and payload['optim'] is not None
    assert payload['config']['forward_tacotron']['model'] == TINY_MODEL
    assert any(not torch.equal(before[k], v)
               for k, v in full.state_dict().items() if k != 'step')

    # interrupted after 3 steps (mid-epoch), resumed from latest_model.pt
    trainer, paths = _trainer(cfg, tmp_path / 'resumed')
    part = _new_model(cfg)
    assert trainer.train(part, max_steps_override=3) == 3
    resumed = _new_model(cfg)
    optimizer = tc.make_optimizer(resumed)
    step = restore(resumed, optimizer, load_checkpoint(
        paths.forward_checkpoints / 'latest_model.pt'))
    assert step == 3
    assert trainer.train(resumed, optimizer, step) == 6
    for k, v in full.state_dict().items():
        np.testing.assert_allclose(resumed.state_dict()[k].numpy(),
                                   v.numpy(), atol=1e-6, err_msg=k)

    # the JAX package converts the checkpoint: same teacher-forced outputs
    jmodel, variables, jcfg, jstep = load_tts_checkpoint(latest)
    assert jstep == 6
    batch = next(iter(trainer_val_set(cfg)))
    ref = jmodel.apply(variables, {k: jnp.asarray(
        v.astype(np.int32) if v.dtype == np.int64 else v)
        for k, v in batch.items() if isinstance(v, np.ndarray)},
        train=False)
    with torch.no_grad():
        out = full.eval()(batch_to_device(batch, 'cpu'))
    for k in ('mel', 'mel_post', 'dur', 'pitch', 'energy'):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-4, err_msg=k)

    # and the port's gen_forward serves it
    model, gcfg, gstep = gen_forward.load_tts(str(latest), cfg, 'cpu')
    assert gstep == 6 and not model.training
    mel = gen_forward.synthesize(model, [5, 9, 12, 7], mel_multiple=16,
                                 compute_dtype=torch.float32)
    assert mel.shape[0] == N_MELS and np.isfinite(mel).all()


def trainer_val_set(cfg):
    from forwardtacotron_tpu_torch.data.dataset import get_tts_datasets
    return get_tts_datasets(cfg['data_path'], batch_size=4, r=1,
                            max_mel_len=None, filter_attention=False)[1]


def test_trainer_rejects_unported_options(dataset, tmp_path):
    """The student runs every option of the JAX student's step and
    refuses an unknown precision, as the JAX package does."""
    for key, value in (('precision', 'bf16'), ('ema_decay', 0.999),
                       ('grad_accum', 2), ('remat', True)):
        cfg = _config(dataset)
        cfg['forward_tacotron']['training'][key] = value
        _trainer(cfg, tmp_path)
    cfg = _config(dataset)
    cfg['forward_tacotron']['training']['precision'] = 'fp16'
    with pytest.raises(ValueError, match='Unknown training precision'):
        _trainer(cfg, tmp_path)


def test_train_forward_cli_rejects_gta(dataset, tmp_path, monkeypatch):
    """`--force_gta` writes the mels of a trained student: without a
    student checkpoint it exits and writes none."""
    from forwardtacotron_tpu_torch import train_forward
    monkeypatch.setenv('FTT_BASE', str(tmp_path))
    with pytest.raises(SystemExit, match='train the model first'):
        train_forward.main(['--force_gta'] + _cli_config(dataset, tmp_path,
                                                          6)[1])
    assert not any((dataset / 'gta').glob('*.npy'))


def _cli_config(data, base, total_steps):
    """A YAML config for `train_forward.main` at the tiny width, its
    checkpoints under `base` (through FTT_BASE)."""
    import yaml
    cfg = _config(data)
    cfg['tts_model_id'] = 'cli_tts'
    cfg['forward_tacotron']['training']['schedule'] = [
        f'1e-3, {total_steps}, 4']
    path = base / f'config_{total_steps}.yaml'
    base.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(cfg))
    return cfg, ['--config', str(path), '--device', 'cpu']


def test_train_forward_cli_resumes_from_latest(dataset, tmp_path,
                                               monkeypatch, capsys):
    """The CLI run twice: to step 3, then with a longer schedule it
    restores latest_model.pt and its optimizer at step 3 and reaches the
    weights of an uninterrupted CLI run to step 6 (atol 1e-6)."""
    from forwardtacotron_tpu_torch import train_forward
    from forwardtacotron_tpu_torch.utils.checkpoints import load_checkpoint

    def latest(base):
        return load_checkpoint(base / 'checkpoints' / 'cli_tts.forward'
                               / 'latest_model.pt')

    full = tmp_path / 'full'
    monkeypatch.setenv('FTT_BASE', str(full))
    assert train_forward.main(_cli_config(dataset, full, 6)[1]) == 6

    resumed = tmp_path / 'resumed'
    monkeypatch.setenv('FTT_BASE', str(resumed))
    assert train_forward.main(_cli_config(dataset, resumed, 3)[1]) == 3
    assert latest(resumed)['step'] == 3
    capsys.readouterr()
    assert train_forward.main(_cli_config(dataset, resumed, 6)[1]) == 6
    assert 'Restored model and optimizer with step 3' in \
        capsys.readouterr().out
    want, got = latest(full), latest(resumed)
    assert got['step'] == 6
    for k, v in want['model'].items():
        np.testing.assert_allclose(got['model'][k].numpy(), v.numpy(),
                                   atol=1e-6, err_msg=k)


def test_train_forward_cli_seeds_raw_weights_from_fjax(dataset, tmp_path,
                                                       monkeypatch):
    """A JAX `latest_model.fjax` with EMA weights seeds the CLI's model
    with its raw parameters and step (as the JAX trainer resumes), and
    training starts there with a fresh optimizer."""
    from forwardtacotron_tpu.utils.checkpoints import (init_tts_model,
                                                       save_checkpoint)
    from forwardtacotron_tpu_torch import train_forward
    from forwardtacotron_tpu_torch.train.forward_trainer import (
        ForwardTrainer)
    from forwardtacotron_tpu_torch.weights import forward_tacotron_state_dict
    cfg, argv = _cli_config(dataset, tmp_path, 6)
    batch = next(iter(trainer_val_set(cfg)))
    jmodel = init_tts_model(cfg)
    variables = jax.tree.map(np.asarray, jmodel.init(
        {'params': jax.random.PRNGKey(1)},
        {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
         for k, v in batch.items() if isinstance(v, np.ndarray)},
        train=False))
    ema = jax.tree.map(lambda a: a + 1.0, variables['params'])
    ck = tmp_path / 'checkpoints' / 'cli_tts.forward'
    ck.mkdir(parents=True)
    save_checkpoint(dict(variables, ema_params=ema), cfg,
                    ck / 'latest_model.fjax', step=2)

    seen = {}

    def train(self, model, optimizer, step, seed):
        seen['model'] = {k: v.clone() for k, v in model.state_dict().items()}
        seen['optim'] = optimizer.state_dict()['state']
        return step

    monkeypatch.setattr(ForwardTrainer, 'train', train)
    monkeypatch.setenv('FTT_BASE', str(tmp_path))
    assert train_forward.main(argv) == 2
    want = forward_tacotron_state_dict(
        variables, cfg['forward_tacotron']['model'], 2)
    assert set(seen['model']) == set(want) and seen['optim'] == {}
    for k, v in want.items():
        np.testing.assert_array_equal(seen['model'][k].numpy(),
                                      np.asarray(v), err_msg=k)
