"""The port's Tacotron teacher on the CPU against the JAX package, same
weights (through `tacotron_state_dict`) and same seeded inputs.

Tolerances: the teacher-forced eval forward (mel, linear, attention) at
atol 1e-4, the bar of docs/benchmarks.md, at r in {1, 2, 5} on a ragged
batch (padded text and mel); the state_dict key for key and bit for bit;
a resumed TacoTrainer run against an uninterrupted one at atol 1e-6 (the
same arithmetic in the same order, dropout and zoneout drawn from the
same seeded generators). Train mode is held to itself: zoneout keeps the
old state at a rate of 0.1 and dropout drops at 0.5, each within 0.01 on
1e5 draws (4.7 and 3.2 standard deviations).
"""
import copy
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

CFG = {'embed_dims': 16, 'encoder_dims': 128, 'decoder_dims': 256,
       'postnet_dims': 8, 'encoder_k': 2, 'lstm_dims': 32, 'postnet_k': 3,
       'num_highways': 1, 'dropout': 0.5, 'stop_threshold': -11}
NUM_CHARS, N_MELS = 30, 6


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """The teacher's decoder is a loop of many small ops: with one
    intra-op thread a test worker runs it faster and leaves the other
    workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0, x_lens=(9, 6, 4), mel_lens=(20, 14, 9), tm=20):
    """Text zero-padded and mel padded with -11.5129, as collate_tts."""
    rng = np.random.RandomState(seed)
    B, tx = len(x_lens), max(x_lens)
    x = np.zeros((B, tx), np.int64)
    mel = np.full((B, tm, N_MELS), -11.5129, np.float32)
    for i, (n, m) in enumerate(zip(x_lens, mel_lens)):
        x[i, :n] = rng.randint(1, NUM_CHARS, n)
        mel[i, :m] = rng.randn(m, N_MELS) * 2 - 5
    return x, mel


@functools.lru_cache(maxsize=1)
def _variables():
    """JAX weights with random batch-norm statistics, as numpy."""
    from forwardtacotron_tpu.models.tacotron import Tacotron as JaxTaco
    x, mel = _batch()
    model = JaxTaco(num_chars=NUM_CHARS, n_mels=N_MELS, **CFG)
    variables = jax.jit(lambda k: model.init(
        {'params': k}, jnp.asarray(x), jnp.asarray(mel), 5, train=False))(
            jax.random.PRNGKey(0))
    rng = np.random.RandomState(5)

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else
                (rng.randn(*v.shape) * 0.1 if k == 'mean'
                 else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
                for k, v in tree.items()}
    return {'params': jax.tree.map(np.asarray, variables['params']),
            'batch_stats': fill(variables['batch_stats'])}


def _jax_model():
    from forwardtacotron_tpu.models.tacotron import Tacotron as JaxTaco
    return JaxTaco(num_chars=NUM_CHARS, n_mels=N_MELS, **CFG)


def _port_model():
    from forwardtacotron_tpu_torch.models.tacotron import Tacotron
    from forwardtacotron_tpu_torch.weights import tacotron_state_dict
    model = Tacotron(num_chars=NUM_CHARS, n_mels=N_MELS, **CFG)
    model.load_state_dict(tacotron_state_dict(_variables(), CFG),
                          strict=True)
    return model


@pytest.mark.parametrize('r', [1, 2, 5])
def test_teacher_forced_eval_matches_jax(r):
    x, mel = _batch(r)
    ref = jax.jit(lambda v, a, b: _jax_model().apply(
        v, a, b, r, train=False))(_variables(), jnp.asarray(x),
                                  jnp.asarray(mel))
    with torch.no_grad():
        out = _port_model().eval()(torch.from_numpy(x),
                                   torch.from_numpy(mel), r)
    assert out[2].shape == (3, 20 // r, x.shape[1])
    for name, got, want in zip(('mel', 'linear', 'attention'), out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, err_msg=f'{name} r={r}')


def test_tacotron_state_dict_equals_torch_export():
    from forwardtacotron_tpu.models.torch_export import export_tacotron
    from forwardtacotron_tpu_torch.models.tacotron import Tacotron
    from forwardtacotron_tpu_torch.weights import tacotron_state_dict
    sd = tacotron_state_dict(_variables(), CFG, step=42, r=5)
    ref = export_tacotron(_variables(), CFG, step=42, r=5)
    assert set(sd) == set(ref)
    for k in ref:
        assert sd[k].dtype == ref[k].dtype and torch.equal(sd[k], ref[k]), k
    model = Tacotron(num_chars=NUM_CHARS, n_mels=N_MELS, **CFG)
    assert set(model.state_dict()) == set(ref)
    model.load_state_dict(sd, strict=True)
    assert int(model.decoder.r) == 5 and int(model.step) == 42
    # a single-speaker teacher has no speaker parameter (the
    # multi-speaker ones: tests/test_torch_multispeaker.py)
    assert not any('speaker' in k for k in sd)


def test_port_checkpoint_converts_to_the_same_jax_outputs(tmp_path):
    """A `.pt` the port writes, read back by the JAX package's
    `torch_compat.convert_tacotron`, gives the port's outputs."""
    from forwardtacotron_tpu.models.torch_compat import convert_tacotron
    from forwardtacotron_tpu_torch.utils.checkpoints import (load_checkpoint,
                                                             save_checkpoint)
    model = _port_model()
    with torch.no_grad():
        for p in model.parameters():        # weights of the port's own
            p.add_(0.01 * torch.randn_like(p))
    path = tmp_path / 'latest_model.pt'
    save_checkpoint(model, None, {'tacotron': {'model': CFG}}, path, step=7)
    variables, step = convert_tacotron(load_checkpoint(path)['model'], CFG)
    assert step == 7
    x, mel = _batch(3)
    ref = jax.jit(lambda v, a, b: _jax_model().apply(
        v, a, b, 2, train=False))(variables, jnp.asarray(x), jnp.asarray(mel))
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x), torch.from_numpy(mel), 2)
    for name, got, want in zip(('mel', 'linear', 'attention'), out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, err_msg=name)


def test_train_mode_draws_from_the_generator():
    from forwardtacotron_tpu_torch.models.layers import dropout
    from forwardtacotron_tpu_torch.models.tacotron import Decoder
    gen = torch.Generator().manual_seed(0)
    kept_old = Decoder._zoneout(_port_model().decoder, torch.zeros(100, 1000),
                                torch.ones(100, 1000), gen)
    assert abs(float((kept_old == 0).float().mean()) - 0.1) < 0.01
    dropped = dropout(torch.ones(100, 1000), 0.5, gen)
    assert abs(float((dropped == 0).float().mean()) - 0.5) < 0.01
    assert set(dropped.unique().tolist()) == {0.0, 2.0}

    model = _port_model().train()
    x, mel = (torch.from_numpy(a) for a in _batch(4))
    with pytest.raises(ValueError, match='generator'):
        model(x, mel, 2)

    def run(seed):
        m = copy.deepcopy(model)
        out = m(x, mel, 2, torch.Generator().manual_seed(seed))
        (out[0].abs().mean() + out[1].abs().mean()).backward()
        return out, m
    (a, m), (b, _), (c, _) = run(1), run(1), run(2)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert not torch.equal(a[0], c[0])
    with torch.no_grad():
        ev = copy.deepcopy(model).eval()(x, mel, 2)
    assert not torch.allclose(a[0], ev[0])
    grads = {k: p.grad for k, p in m.named_parameters()}
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in grads.values())
    assert float(grads['encoder.cbhg.rnn.weight_hh_l0'].abs().sum()) > 0


def _write_dataset(data, n_items=10, n_val=2, seed=0):
    """Items of 4-9 phonemes and 8-25 frames (mel, text, split)."""
    from forwardtacotron_tpu_torch.text.symbols import phonemes
    from forwardtacotron_tpu_torch.utils.files import pickle_binary
    rng = np.random.RandomState(seed)
    (data / 'mel').mkdir(parents=True, exist_ok=True)
    index, text_dict = [], {}
    for i in range(n_items):
        n, frames = rng.randint(4, 10), rng.randint(8, 26)
        np.save(data / 'mel' / f'{i}.npy',
                (rng.randn(80, frames) - 4).astype(np.float32))
        text_dict[str(i)] = ''.join(rng.choice(phonemes[1:], n))
        index.append((str(i), frames))
    pickle_binary(text_dict, data / 'text_dict.pkl')
    pickle_binary(index[:-n_val], data / 'train_dataset.pkl')
    pickle_binary(index[-n_val:], data / 'val_dataset.pkl')


class _Scalars:
    def __init__(self):
        self.values = []

    def add_scalar(self, tag, value, step):
        self.values.append((tag, float(value), int(step)))


def _trainer(data, base, writer=None):
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.train.taco_trainer import TacoTrainer
    from forwardtacotron_tpu_torch.utils.paths import Paths
    cfg = default_config()
    cfg['data_path'] = str(data)
    cfg['tacotron']['model'] = dict(CFG)
    cfg['tacotron']['training']['schedule'] = ['2, 2e-3, 4, 3',
                                               '1, 2e-3, 8, 4']
    paths = Paths(cfg['data_path'], 'taco_test', base=base)
    return TacoTrainer(paths, cfg, device='cpu', writer=writer), paths


def _new_teacher():
    from forwardtacotron_tpu_torch.models.tacotron import Tacotron
    torch.manual_seed(0)
    return Tacotron(n_mels=80, **CFG)


def test_taco_trainer_learns_and_resumes_exactly(tmp_path):
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.utils.checkpoints import (load_checkpoint,
                                                             restore)
    data = tmp_path / 'data'
    _write_dataset(data)
    writer = _Scalars()
    trainer, paths = _trainer(data, tmp_path / 'full', writer)
    full = _new_teacher()
    assert trainer.train(full) == 8
    losses = [v for tag, v, _ in writer.values if tag == 'Loss/train']
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert any(tag == 'Attention_Score/val' for tag, _, _ in writer.values)
    payload = load_checkpoint(paths.taco_checkpoints / 'latest_model.pt')
    assert payload['step'] == 8 and payload['optim'] is not None
    assert int(payload['model']['decoder.r']) == 1

    # interrupted in the second session (r=1), mid-epoch, then resumed
    trainer, paths = _trainer(data, tmp_path / 'resumed')
    part = _new_teacher()
    assert trainer.train(part, max_steps_override=6) == 6
    resumed = _new_teacher()
    optimizer = tc.make_optimizer(resumed)
    step = restore(resumed, optimizer, load_checkpoint(
        paths.taco_checkpoints / 'latest_model.pt'))
    assert step == 6
    assert trainer.train(resumed, optimizer, step) == 8
    for k, v in full.state_dict().items():
        np.testing.assert_allclose(resumed.state_dict()[k].numpy(),
                                   v.numpy(), atol=1e-6, err_msg=k)


def test_taco_trainer_refuses_unported_options(tmp_path):
    """The teacher runs the options of the JAX teacher's step (precision,
    grad_accum, remat) and refuses by name the one that step ignores
    (ema_decay), and an unknown precision as the JAX package does."""
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.train.taco_trainer import TacoTrainer
    from forwardtacotron_tpu_torch.utils.paths import Paths
    for key, value, error in (
            ('precision', 'bf16', None), ('grad_accum', 2, None),
            ('remat', True, None),
            ('ema_decay', 0.999,
             'ema_decay.*JAX tacotron trainer has no such option'),
            ('precision', 'fp16', 'Unknown training precision')):
        cfg = default_config()
        cfg['tacotron']['training'][key] = value

        def make():
            return TacoTrainer(Paths(str(tmp_path / 'data'), 't',
                                     base=tmp_path), cfg, device='cpu')
        if error is None:
            make()
        else:
            with pytest.raises(ValueError, match=error):
                make()
