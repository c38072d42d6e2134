"""Checkpoints of the trainers' options on the CPU at a tiny size: a
student trained with EMA weights writes them under 'model' (served by the
port's `gen_forward.load_tts`, through which `TTSServer` loads too, and by
the JAX package's `load_tts_checkpoint`) and its raw weights under
'raw_model' (resumed from); a resumed run continues the raw weights, the EMA and Adam exactly;
a JAX `.fjax` seeds the EMA as the JAX `train_forward.py` does;
`--force_gta` writes the raw weights' mels; and `AsyncCheckpointWriter`
writes what a synchronous save writes, in order, after a snapshot, and
reports a failure.

Tolerances: EMA weights through the JAX package's converter at atol 1e-7
(a copy); the resumed run equal to the uninterrupted one (the same
arithmetic in the same order); GTA mels at atol 1e-6.
"""
import copy
import shutil
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import yaml

from test_torch_train_pipeline import (_cli_config, _config, _new_model,
                                       _trainer, dataset, one_thread,
                                       trainer_val_set)

EMA_DECAY = 0.9
__all__ = ['dataset', 'one_thread']     # fixtures, used below


def _ema_config(data, **options):
    cfg = _config(data)
    cfg['forward_tacotron']['training'].update(ema_decay=EMA_DECAY,
                                               **options)
    return cfg


def _opt_state(optimizer):
    return {i: {k: v.clone() for k, v in s.items()}
            for i, s in optimizer.state_dict()['state'].items()}


def test_ema_checkpoint_resumes_and_serves(dataset, tmp_path):
    from forwardtacotron_tpu.utils.checkpoints import load_tts_checkpoint
    from forwardtacotron_tpu_torch import gen_forward
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.utils.checkpoints import (load_checkpoint,
                                                             restore)
    from forwardtacotron_tpu_torch.weights import forward_tacotron_state_dict
    cfg = _ema_config(dataset)

    trainer, paths = _trainer(cfg, tmp_path / 'full')
    full = _new_model(cfg)
    full_opt = tc.make_optimizer(full)
    assert trainer.train(full, full_opt) == 6
    full_ema = trainer.ema
    latest = paths.forward_checkpoints / 'latest_model.pt'
    payload = load_checkpoint(latest)
    raw = payload['raw_model']
    for k, v in full.state_dict().items():
        assert torch.equal(raw[k], v), k
        want = full_ema.params.get(k, v)
        assert torch.equal(payload['model'][k], want), k
    assert any(not torch.equal(full_ema.params[k], p.detach())
               for k, p in full.named_parameters())
    # the top-k files and the step files serve the EMA weights too
    kept = list(paths.forward_top_k.glob('*.pt'))
    assert kept and all('raw_model' in load_checkpoint(p) for p in kept)

    # interrupted after 3 steps, resumed: raw weights, EMA and Adam state
    # continue exactly
    trainer, paths2 = _trainer(cfg, tmp_path / 'resumed')
    assert trainer.train(_new_model(cfg), max_steps_override=3) == 3
    resumed = _new_model(cfg)
    optimizer = tc.make_optimizer(resumed)
    trainer2, _ = _trainer(cfg, tmp_path / 'resumed')
    trainer2.ema = tc.make_ema(resumed, cfg['forward_tacotron']['training'])
    step = restore(resumed, optimizer, load_checkpoint(
        paths2.forward_checkpoints / 'latest_model.pt'), trainer2.ema)
    assert step == 3
    assert trainer2.train(resumed, optimizer, step) == 6
    for k, v in full.state_dict().items():
        assert torch.equal(resumed.state_dict()[k], v), k
    for k, v in full_ema.params.items():
        assert torch.equal(trainer2.ema.params[k], v), k
    want_opt, got_opt = _opt_state(full_opt), _opt_state(optimizer)
    assert want_opt.keys() == got_opt.keys()
    for i in want_opt:
        for k in ('step', 'exp_avg', 'exp_avg_sq'):
            assert torch.equal(got_opt[i][k], want_opt[i][k]), (i, k)

    # served weights are the EMA ones: the JAX package's loader and the
    # port's gen_forward (TTSServer loads through it)
    _, variables, _, jstep = load_tts_checkpoint(latest)
    assert jstep == 6
    converted = forward_tacotron_state_dict(
        jax.tree.map(np.asarray, variables),
        cfg['forward_tacotron']['model'])
    for k, v in full_ema.params.items():
        np.testing.assert_allclose(converted[k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-7, err_msg=k)
    served, _, gstep = gen_forward.load_tts(str(latest), cfg, 'cpu')
    assert gstep == 6
    for k, v in full_ema.params.items():
        assert torch.equal(served.state_dict()[k], v), k


def test_fjax_seeds_the_ema(dataset, tmp_path, monkeypatch):
    """A JAX `latest_model.fjax` seeds the CLI's EMA from its
    `ema_params`, or from the raw parameters where it has none; with
    `ema_decay` 0 the stored EMA is dropped (the JAX package's
    `train_forward.py:100-119`)."""
    from forwardtacotron_tpu.utils.checkpoints import (init_tts_model,
                                                       save_checkpoint)
    from forwardtacotron_tpu_torch import train_forward
    from forwardtacotron_tpu_torch.train.forward_trainer import (
        ForwardTrainer)
    from forwardtacotron_tpu_torch.weights import forward_tacotron_state_dict
    cfg, argv = _cli_config(dataset, tmp_path, 6)
    batch = next(iter(trainer_val_set(cfg)))
    variables = jax.tree.map(np.asarray, init_tts_model(cfg).init(
        {'params': jax.random.PRNGKey(1)},
        {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
         for k, v in batch.items() if isinstance(v, np.ndarray)},
        train=False))
    ema = jax.tree.map(lambda a: a + 1.0, variables['params'])
    model_cfg = cfg['forward_tacotron']['model']
    seen = {}

    def train(self, model, optimizer, step, seed):
        seen['model'] = {k: v.clone() for k, v in model.state_dict().items()}
        seen['ema'] = None if self.ema is None else dict(self.ema.params)
        return step

    monkeypatch.setattr(ForwardTrainer, 'train', train)
    monkeypatch.setenv('FTT_BASE', str(tmp_path))
    ck = tmp_path / 'checkpoints' / 'cli_tts.forward'
    ck.mkdir(parents=True)
    raw_sd = forward_tacotron_state_dict(variables, model_cfg, 2)
    ema_sd = forward_tacotron_state_dict(dict(variables, params=ema),
                                         model_cfg, 2)
    for stored, decay, want in ((ema, EMA_DECAY, ema_sd),
                                (None, EMA_DECAY, raw_sd),
                                (ema, 0.0, None)):
        save_checkpoint(variables if stored is None
                        else dict(variables, ema_params=stored), cfg,
                        ck / 'latest_model.fjax', step=2)
        run_cfg = dict(cfg, forward_tacotron=dict(
            cfg['forward_tacotron'], training=dict(
                cfg['forward_tacotron']['training'], ema_decay=decay)))
        path = tmp_path / 'run.yaml'
        path.write_text(yaml.safe_dump(run_cfg))
        assert train_forward.main(['--config', str(path), '--device',
                                   'cpu']) == 2
        for k, v in raw_sd.items():
            assert torch.equal(seen['model'][k], v), k
        if want is None:
            assert seen['ema'] is None
            continue
        assert seen['ema'].keys() == {k for k, _ in
                                      _new_model(cfg).named_parameters()}
        for k, v in seen['ema'].items():
            assert torch.equal(v, want[k]), k


def test_force_gta_uses_the_raw_weights(dataset, tmp_path, monkeypatch):
    """`--force_gta` with a checkpoint that keeps EMA weights writes the
    teacher-forced mels of the raw weights (the JAX package's
    `create_gta_features` applies `state.variables`), not the EMA's."""
    from forwardtacotron_tpu_torch import train_forward
    from forwardtacotron_tpu_torch.data.dataset import get_tts_datasets
    from forwardtacotron_tpu_torch.train.forward_trainer import (
        batch_to_device)
    from forwardtacotron_tpu_torch.utils.checkpoints import load_checkpoint
    data = tmp_path / 'data'
    shutil.copytree(dataset, data)           # the GTA mels go to data/gta
    cfg = _ema_config(data)
    cfg['tts_model_id'] = 'cli_tts'
    cfg['forward_tacotron']['training']['schedule'] = ['1e-2, 4, 4']
    path = tmp_path / 'ema.yaml'
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.setenv('FTT_BASE', str(tmp_path))
    argv = ['--config', str(path), '--device', 'cpu']
    assert train_forward.main(argv) == 4
    payload = load_checkpoint(tmp_path / 'checkpoints' / 'cli_tts.forward'
                              / 'latest_model.pt')
    train_forward.main(argv + ['--force_gta'])
    train_set, val_set = get_tts_datasets(data, 8, 1, max_mel_len=None,
                                          filter_attention=False,
                                          model_type='forward')
    outs = {}
    for key in ('raw_model', 'model'):
        model = _new_model(cfg)
        model.load_state_dict(payload[key])
        model.eval()
        outs[key] = {}
        for batch in (b for s in (train_set, val_set) for b in s):
            with torch.no_grad():
                mel = model(batch_to_device(batch, 'cpu'))['mel_post']
            for j in range(batch.get('n_real', mel.shape[0])):
                n = int(batch['mel_len'][j])
                outs[key][batch['item_id'][j]] = mel[j, :n].numpy().T
    assert len(outs['model']) == 10
    differ = 0
    for item, want in outs['raw_model'].items():
        got = np.load(data / 'gta' / f'{item}.npy')
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=item)
        differ += not np.allclose(got, outs['model'][item], atol=1e-4)
    assert differ > 0


# ------------------------------------------------- the background writer

def _payload(seed):
    g = torch.Generator().manual_seed(seed)
    return {'model': {'w': torch.randn(5, 3, generator=g),
                      'step': torch.tensor([seed])},
            'optim': {'state': {0: {'exp_avg': torch.randn(4, generator=g)}},
                      'param_groups': [{'lr': 1e-3, 'params': [0]}]},
            'config': {'a': [1, 2]}, 'step': seed}


def _equal(a, b):
    if torch.is_tensor(a):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_async_writer_equals_a_synchronous_save(tmp_path):
    """The file equals `save_payload`'s of the same payload, and holds the
    values at the time of `save()`: the step's in-place update after it
    does not reach the file."""
    from forwardtacotron_tpu_torch.utils.async_ckpt import (
        AsyncCheckpointWriter)
    from forwardtacotron_tpu_torch.utils.checkpoints import (load_checkpoint,
                                                             save_payload)
    payload = _payload(3)
    want = copy.deepcopy(payload)
    save_payload(payload, tmp_path / 'sync.pt')
    writer = AsyncCheckpointWriter()
    writer.save(payload, tmp_path / 'async.pt')
    payload['model']['w'].add_(1.0)          # the next step, in place
    payload['optim']['state'][0]['exp_avg'].mul_(0.0)
    writer.close()
    sync, got = (load_checkpoint(tmp_path / n) for n in ('sync.pt',
                                                          'async.pt'))
    assert _equal(got, sync) and _equal(got, want)


def test_async_writer_order_failure_and_on_complete(tmp_path):
    """Saves land in the order asked for, one in flight; `on_complete`
    runs on the writer thread after the rename (the file there, no
    temporary left); a failed save skips it and re-raises at `wait()`."""
    from forwardtacotron_tpu_torch.utils.async_ckpt import (
        AsyncCheckpointWriter)
    from forwardtacotron_tpu_torch.utils.checkpoints import load_checkpoint
    writer = AsyncCheckpointWriter()
    seen = []
    path = tmp_path / 'latest_model.pt'

    def done(step):
        def on_complete():
            seen.append((step, threading.current_thread().name,
                         path.exists(), load_checkpoint(path)['step'],
                         path.with_suffix('.pt.tmp').exists()))
        return on_complete
    for step in range(1, 6):
        writer.save(_payload(step), path, on_complete=done(step))
    writer.wait()
    assert [s[0] for s in seen] == [1, 2, 3, 4, 5]
    assert all(s[1].startswith('ckpt-writer') and s[2] and s[3] == s[0]
               and not s[4] for s in seen)
    assert load_checkpoint(path)['step'] == 5

    bad = tmp_path / 'missing' / 'x.pt'
    writer.save(_payload(6), bad, on_complete=done(6))
    with pytest.raises((RuntimeError, OSError), match='not exist|No such'):
        writer.wait()
    assert len(seen) == 5 and not bad.exists()
    writer.wait()                            # the failure is reported once
    writer.close()


def test_trainer_runs_every_option_together(dataset, tmp_path):
    """`ForwardTrainer.train` with bf16, grad_accum 2, remat and EMA at
    once: the steps run, every parameter moves to finite values, and the
    file holds the raw weights under 'raw_model' and the EMA ones under
    'model'."""
    from forwardtacotron_tpu_torch.utils.checkpoints import load_checkpoint
    cfg = _ema_config(dataset, precision='bf16', grad_accum=2, remat=True)
    trainer, paths = _trainer(cfg, tmp_path)
    model = _new_model(cfg)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    assert trainer.train(model, max_steps_override=2) == 2
    for k, p in model.named_parameters():
        assert torch.isfinite(p).all() and not torch.equal(p, before[k]), k
        assert p.dtype == torch.float32, k
    payload = load_checkpoint(paths.forward_checkpoints / 'latest_model.pt')
    assert payload['step'] == 2
    for k, v in model.state_dict().items():
        assert torch.equal(payload['raw_model'][k], v), k
        assert torch.equal(payload['model'][k],
                           trainer.ema.params.get(k, v)), k
