"""WaveRNN's options on the CPU against the JAX package at a tiny width,
at the tolerances of tests/test_torch_train_options.py (its module
docstring, the c-relative form of the bf16 comparison too): remat and
bf16, RAW and MOL; and the options each trainer refuses because its JAX
counterpart has no such option.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import test_torch_voc_train as voc
from test_torch_train_options import (CLIP, LR, _adam_grads,
                                      _check_c_relative, _one_thread,
                                      _params_of)

__all__ = ['_one_thread']       # the autouse fixture


def _voc_jax(mode, train_cfg, x, mel, y):
    from forwardtacotron_tpu.train import common as jtc
    from forwardtacotron_tpu.train.voc_trainer import build_voc_train_step
    jmodel, variables, tmodel = voc._models(mode)
    optimizer = jtc.make_optimizer(CLIP, lr=LR)
    state = jtc.TrainState(params=variables['params'],
                           batch_stats=variables['batch_stats'],
                           opt_state=optimizer.init(variables['params']),
                           step=jnp.asarray(0, jnp.int32))
    step = build_voc_train_step(jmodel, optimizer, mode, train_cfg)
    new_state, metrics = step(state, {'x': jnp.asarray(x),
                                      'mel': jnp.asarray(mel),
                                      'y': jnp.asarray(y)})
    grads = _adam_grads(new_state.opt_state, lambda p: voc._state_dict(
        {'params': p, 'batch_stats': variables['batch_stats']}, mode),
        _params_of(tmodel))
    after = {k: v.numpy() for k, v in voc._state_dict(
        new_state.variables, mode).items()}
    return grads, after, float(metrics['loss'])


def _voc_port(mode, x, mel, y, half=None, remat=False):
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.voc_trainer import voc_train_step
    model = voc._models(mode)[2]
    metrics = voc_train_step(model, tc.make_optimizer(model, lr=LR), {
        'x': torch.from_numpy(x), 'mel': torch.from_numpy(mel),
        'y': torch.from_numpy(y)}, mode, CLIP, half, remat)
    grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    after = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    return grads, after, float(metrics['loss'])


@pytest.mark.parametrize('mode', ['RAW', 'MOL'])
def test_wavernn_remat_matches_jax_and_itself(mode):
    """remat against JAX's remat step (loss rtol 1e-5, gradients rtol
    5e-4 / atol 5e-5, running statistics rtol 1e-5 / atol 1e-6) and
    against the port without it (running statistics exactly equal,
    gradients atol 1e-6)."""
    x, mel, y = voc._inputs(mode, 3)
    g1, a1, l1 = _voc_port(mode, x, mel, y, remat=True)
    want = _voc_jax(mode, {'remat': True}, x, mel, y)
    np.testing.assert_allclose(l1, want[2], rtol=1e-5)
    for k, g in want[0].items():
        np.testing.assert_allclose(g1[k], g, rtol=5e-4, atol=5e-5, err_msg=k)
    g0, a0, l0 = _voc_port(mode, x, mel, y)
    for k in a0:
        if 'running' in k or k.endswith('num_batches_tracked'):
            assert np.array_equal(a0[k], a1[k]), k
            if 'running' in k:
                np.testing.assert_allclose(a1[k], want[1][k], rtol=1e-5,
                                           atol=1e-6, err_msg=k)
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    assert l0 == l1


@pytest.mark.parametrize('mode', ['RAW', 'MOL'])
def test_wavernn_bf16_matches_jax_bf16(mode):
    """bf16: parameters, x and mel cast, the float32 logits' loss; held in
    the c-relative form against JAX's bf16 step."""
    x, mel, y = voc._inputs(mode, 4)
    port = _voc_port(mode, x, mel, y, half=torch.bfloat16)
    ref16 = _voc_jax(mode, {'precision': 'bf16'}, x, mel, y)
    ref32 = _voc_jax(mode, {}, x, mel, y)
    _check_c_relative(port[0], ref16[0], ref32[0], f'WaveRNN {mode}')
    assert np.isfinite(port[2])
    np.testing.assert_allclose(port[2], ref16[2], rtol=2e-2)
    for k, v in port[1].items():
        if 'running' in k:
            assert v.dtype == np.float32, k


# ---------------------------------------------- options a trainer refuses

@pytest.mark.parametrize('trainer,key,value', [
    ('tacotron', 'ema_decay', 0.999),
    ('wavernn', 'ema_decay', 0.999), ('wavernn', 'grad_accum', 2),
    ('gan', 'ema_decay', 0.999), ('gan', 'grad_accum', 2),
    ('gan', 'remat', True)])
def test_options_the_jax_trainer_lacks_are_refused(trainer, key, value):
    """Each trainer refuses, by name, an option its JAX counterpart does
    not run, and accepts the ones it does (and the float32 defaults)."""
    from forwardtacotron_tpu_torch.train import common as tc
    with pytest.raises(ValueError,
                       match=f'training.{key}.*JAX {trainer} trainer has '
                             'no such option'):
        tc.check_supported({key: value}, trainer)
    for option in tc.HONOURED[trainer]:
        tc.check_supported({option: {'precision': 'bf16', 'ema_decay': 0.9,
                                     'grad_accum': 2,
                                     'remat': True}[option]}, trainer)
    tc.check_supported({key: {'ema_decay': 0.0, 'grad_accum': 1,
                              'remat': False}[key]}, trainer)
