"""The student's rematerialisation and bf16 mixed precision on the CPU
against the JAX package at a tiny width, at the tolerances of
tests/test_torch_train_options.py (its module docstring): remat against
JAX's remat step and against the port without it, dropout live; bf16 in
the c-relative form against JAX's bf16 step.
"""
import numpy as np
import pytest
import torch

from test_torch_forward_train import (NO_DROPOUT, TINY, TRAIN_CFG, _batch,
                                      _models)
from test_torch_train_options import (BF16_APART, C_BF16, _check_f32,
                                      _jax_step, _one_thread, _port_step,
                                      _rel)

__all__ = ['_one_thread']       # the autouse fixture


def test_student_remat_matches_jax_and_itself():
    """remat against JAX's remat step (float32 tolerances), and against
    the port without remat with dropout and zoneout live: the recompute
    draws the same dropout masks (the global RNG) and leaves the running
    statistics where the forward put them."""
    cfg = dict(TRAIN_CFG, remat=True)
    b = _batch(4)
    before = _models(NO_DROPOUT)[2].state_dict()
    _check_f32(_port_step(NO_DROPOUT, cfg, b),
               _jax_step(NO_DROPOUT, cfg, b), before)

    live = dict(TRAIN_CFG, pitch_zoneout=0.3, energy_zoneout=0.3)
    runs = []
    for remat in (False, True):
        torch.manual_seed(123)
        runs.append(_port_step(TINY, dict(live, remat=remat), b))
    (g0, a0, m0, _), (g1, a1, m1, _) = runs
    for k in a0:
        if k.endswith(('running_mean', 'running_var', 'num_batches_tracked')):
            assert np.array_equal(a0[k], a1[k]), k
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    assert m0 == pytest.approx(m1, rel=1e-6)
    # dropout is live: another seed draws other masks
    torch.manual_seed(321)
    other = _port_step(TINY, live, b)
    assert abs(other[2]['loss'] - m0['loss']) > 1e-4


def test_student_bf16_matches_jax_bf16():
    """precision bf16 against JAX's bf16 step, in the c-relative form of
    the module docstring; the losses are float32 and finite."""
    b = _batch(5)
    bf16 = dict(TRAIN_CFG, precision='bf16')
    port = _port_step(NO_DROPOUT, bf16, b)
    ref16 = _jax_step(NO_DROPOUT, bf16, b)
    ref32 = _jax_step(NO_DROPOUT, TRAIN_CFG, b)
    initial = {k: v.numpy() for k, v in
               _models(NO_DROPOUT)[2].state_dict().items()}
    names = list(ref16[0])

    def updates(after):
        return {k: np.asarray(after[k]) - initial[k] for k in names}
    d_grad = _rel(port[0], ref16[0])
    d_grad_ref = _rel(ref32[0], ref16[0])
    up16 = updates({k: v.numpy() for k, v in ref16[1].items()})
    d_up = _rel(updates(port[1]), up16)
    d_up_ref = _rel(updates({k: v.numpy() for k, v in ref32[1].items()}),
                    up16)
    print(f'bf16 student: grads {d_grad:.3g} vs {d_grad_ref:.3g}, '
          f'updates {d_up:.3g} vs {d_up_ref:.3g}')
    assert d_grad_ref > 0 and d_up_ref > 0
    assert d_grad <= C_BF16 * d_grad_ref
    assert d_up <= C_BF16 * d_up_ref
    # the bf16 step is not the float32 one, and its metrics are float32
    assert _rel(port[0], ref32[0]) >= BF16_APART * d_grad_ref
    assert np.isfinite(port[2]['loss'])
    for k in ('loss', 'mel_loss'):
        np.testing.assert_allclose(port[2][k], ref16[2][k], rtol=2e-2,
                                   err_msg=k)
    # BatchNorm statistics stay float32
    for k, v in port[1].items():
        if k.endswith(('running_mean', 'running_var')):
            assert v.dtype == np.float32, k
