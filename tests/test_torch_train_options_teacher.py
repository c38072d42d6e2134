"""The teacher's options on the CPU against the JAX package at a tiny
width, at the tolerances of tests/test_torch_train_options.py (its module
docstring, the c-relative form of the bf16 comparison too):
grad_accum, remat with its explicit generator live, bf16, and the
trainer with every option it honours.

The JAX teacher's dropout (prenets and CBHGs, 0.5) and zoneout (0.1) have
no rate in its config, so where the JAX step is the reference both
frameworks draw "keep everything" (`keep_all`): dropout then still scales
by 1 / (1 - p), zoneout keeps nothing of the old state, and the two steps
compute the same function. Where the port is held to itself (remat), its
generator draws live masks.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_tacotron as taco
from test_torch_train_options import (CLIP, LR, _adam_grads,
                                      _check_c_relative, _one_thread,
                                      _params_of, _rel)

__all__ = ['_one_thread']       # the autouse fixture


@pytest.fixture
def keep_all(monkeypatch):
    """Every dropout keeps and no zoneout fires, in both frameworks:
    bernoulli(p) is p >= 0.5 (keep 0.5 for dropout, zoneout 0.1 never),
    and the port's uniform draws are 1."""
    monkeypatch.setattr(jax.random, 'bernoulli',
                        lambda key, p=0.5, shape=None: jnp.full(shape,
                                                                p >= 0.5))

    def rand(*size, generator=None, device=None, **kw):
        shape = size[0] if len(size) == 1 and not isinstance(size[0], int) \
            else size
        return torch.ones(shape, device=device)
    monkeypatch.setattr(torch, 'rand', rand)



# ------------------------------------------------------------- the teacher

R = 2
TACO_X_LENS, TACO_MEL_LENS = (9, 6, 4, 7), (20, 14, 9, 16)


def _taco_sd(params, stats):
    from forwardtacotron_tpu_torch.weights import tacotron_state_dict
    return tacotron_state_dict({'params': params, 'batch_stats': stats},
                               taco.CFG)


def _taco_jax(train_cfg, x, mel):
    """JAX's `build_taco_train_step` from the shared weights: (gradients,
    state_dict after, metrics, attention)."""
    from forwardtacotron_tpu.train import common as jtc
    from forwardtacotron_tpu.train.taco_trainer import build_taco_train_step
    variables = taco._variables()
    optimizer = jtc.make_optimizer(CLIP, lr=LR)
    state = jtc.TrainState(params=variables['params'],
                           batch_stats=variables['batch_stats'],
                           opt_state=optimizer.init(variables['params']),
                           step=jnp.asarray(0, jnp.int32))
    step = build_taco_train_step(taco._jax_model(), optimizer, R, train_cfg)
    new_state, (metrics, att) = step(state, {'x': jnp.asarray(x),
                                             'mel': jnp.asarray(mel)},
                                     jax.random.PRNGKey(0))
    names = _params_of(taco._port_model())
    grads = _adam_grads(new_state.opt_state, lambda p: _taco_sd(
        p, variables['batch_stats']), names)
    after = {k: v.numpy() for k, v in _taco_sd(
        new_state.params, new_state.batch_stats).items()}
    return grads, after, {k: float(v) for k, v in metrics.items()}, \
        np.asarray(att)


def _taco_port(train_cfg, x, mel, seed=0):
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.taco_trainer import taco_train_step
    model = taco._port_model()
    opt = tc.make_optimizer(model, lr=LR)
    metrics, att = taco_train_step(
        model, opt, {'x': torch.from_numpy(x), 'mel': torch.from_numpy(mel)},
        R, torch.Generator().manual_seed(seed), dict(train_cfg,
                                                     clip_grad_norm=CLIP))
    grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    after = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    return grads, after, {k: float(v) for k, v in metrics.items()}, \
        att.numpy()


def test_teacher_grad_accum_matches_jax(keep_all):
    """grad_accum 2 on a batch of 4 at r=2: the averaged gradient, the
    running statistics moved per micro-batch, the metrics averaged and
    the attention re-assembled to the full batch, against JAX's step."""
    x, mel = taco._batch(3, TACO_X_LENS, TACO_MEL_LENS)
    grads, after, metrics, att = _taco_port({'grad_accum': 2}, x, mel)
    want = _taco_jax({'grad_accum': 2}, x, mel)
    for k in ('loss', 'm1_loss', 'm2_loss'):
        np.testing.assert_allclose(metrics[k], want[2][k], rtol=1e-5,
                                   err_msg=k)
    assert att.shape == want[3].shape == (4, 10, 9)
    np.testing.assert_allclose(att, want[3], atol=1e-5)
    for k, g in want[0].items():
        np.testing.assert_allclose(grads[k], g, rtol=5e-4, atol=5e-5,
                                   err_msg=k)
    for k, v in want[1].items():
        if k.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(after[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_teacher_remat_replays_its_generator():
    """remat against the port without it, the generator's dropout and
    zoneout live: the recompute draws the same masks from the generator
    (restored for it) and moves no running statistic a second time."""
    x, mel = taco._batch(4, TACO_X_LENS, TACO_MEL_LENS)
    g0, a0, m0, att0 = _taco_port({}, x, mel, seed=7)
    g1, a1, m1, att1 = _taco_port({'remat': True}, x, mel, seed=7)
    for k in a0:
        if 'running' in k or k.endswith('num_batches_tracked'):
            assert np.array_equal(a0[k], a1[k]), k
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    assert np.array_equal(att0, att1) and m0 == m1
    g2 = _taco_port({}, x, mel, seed=8)[0]
    assert _rel(g2, g0) > 1e-3          # the masks are live


def test_teacher_bf16_matches_jax_bf16(keep_all):
    x, mel = taco._batch(5, TACO_X_LENS[:3], TACO_MEL_LENS[:3])
    bf16 = {'precision': 'bf16'}
    port = _taco_port(bf16, x, mel)
    ref16, ref32 = _taco_jax(bf16, x, mel), _taco_jax({}, x, mel)
    _check_c_relative(port[0], ref16[0], ref32[0], 'teacher gradients')
    assert np.isfinite(port[2]['loss']) and port[3].dtype == np.float32
    np.testing.assert_allclose(port[2]['loss'], ref16[2]['loss'], rtol=2e-2)


def test_teacher_trainer_runs_its_options(tmp_path):
    """`TacoTrainer.train` with bf16, grad_accum 2 and remat together:
    the steps run with finite losses and the checkpoint is written."""
    from forwardtacotron_tpu_torch.utils.checkpoints import load_checkpoint
    data = tmp_path / 'data'
    taco._write_dataset(data)
    writer = taco._Scalars()
    trainer, paths = taco._trainer(data, tmp_path, writer)
    trainer.train_cfg.update(precision='bf16', grad_accum=2, remat=True,
                             schedule=['2, 2e-3, 2, 4'])
    model = taco._new_teacher()
    assert trainer.train(model) == 2
    losses = [v for tag, v, _ in writer.values if tag == 'Loss/train']
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert load_checkpoint(paths.taco_checkpoints
                           / 'latest_model.pt')['step'] == 2
