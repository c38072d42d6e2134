"""The port's trainable BiRNN (`ops/rnn.py:BiRNNTrain`, the plain versions
of kernels #2 and #3 on the CPU) against the JAX package: jax.value_and_grad
through its scan ops, and through its `birnn_train` custom_vjp with the
Pallas kernel pair run in interpret mode, as tests/test_pallas_birnn.py
runs it; and against torch autograd through the plain inference
recurrence.

Tolerances are the JAX package's kernel-vs-scan bar
(tests/test_pallas_birnn.py:121-127): values rtol 2e-5 / atol 1e-5,
gradients rtol 2e-4 / atol 2e-5.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

KEYS = ('w_ih', 'w_hh', 'b_ih', 'b_hh')


def _rand(rng, *shape, scale=0.3):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _case(seed, cell, B, T, D, H, lens):
    rng = np.random.RandomState(seed)
    g = 4 if cell == 'lstm' else 3
    dirs = [{'w_ih': _rand(rng, g * H, D), 'w_hh': _rand(rng, g * H, H),
             'b_ih': _rand(rng, g * H), 'b_hh': _rand(rng, g * H)}
            for _ in range(2)]
    x = _rand(rng, B, T, D)
    full = np.full(B, T) if lens is None else np.asarray(lens)
    valid = (np.arange(T)[None, :, None] < full[:, None, None])
    w_read = _rand(rng, B, T, 2 * H, scale=1.0) * valid
    return dirs, x, w_read


def _torch_value_and_grads(cell, dirs, x, w_read, lens):
    from forwardtacotron_tpu_torch.ops import rnn as trnn
    pf, pb = ({k: torch.tensor(d[k], requires_grad=True) for k in KEYS}
              for d in dirs)
    xt = torch.tensor(x, requires_grad=True)
    lengths = None if lens is None else torch.tensor(lens)
    y = trnn.birnn(cell, pf, pb, xt, lengths=lengths)
    assert _reaches(y.grad_fn, 'BiRNNTrain')
    loss = torch.sum(y * torch.from_numpy(w_read))
    loss.backward()
    grads = [{k: p[k].grad.numpy() for k in KEYS} for p in (pf, pb)]
    return float(loss.detach()), grads, xt.grad.numpy()


def _reaches(fn, name, seen=None):
    seen = set() if seen is None else seen
    if fn is None or fn in seen:
        return False
    seen.add(fn)
    return name in type(fn).__name__ or any(
        _reaches(nxt, name, seen) for nxt, _ in fn.next_functions)


def _assert_close(loss, grads, dx, ref_loss, ref_grads, ref_dx):
    np.testing.assert_allclose(loss, ref_loss, rtol=2e-5, atol=1e-5)
    for d in range(2):
        for k in KEYS:
            np.testing.assert_allclose(grads[d][k], ref_grads[d][k],
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f'dir {d} {k}')
    np.testing.assert_allclose(dx, ref_dx, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize('cell', ['gru', 'lstm'])
@pytest.mark.parametrize('B,lens', [(3, None), (10, (13, 7, 1, 13, 2, 9, 11,
                                                     4, 13, 6))])
def test_train_grads_match_jax_scan(cell, B, lens):
    """y and every gradient against jax.value_and_grad of bigru/bilstm
    (B=3 takes the JAX fused-direction scan, B=10 its direction scans)."""
    from forwardtacotron_tpu.ops import rnn as jrnn
    T, D, H = 13, 10, 16
    dirs, x, w_read = _case(B + len(cell), cell, B, T, D, H, lens)
    jfn = jrnn.bilstm if cell == 'lstm' else jrnn.bigru
    jl = None if lens is None else jnp.asarray(lens)

    def loss_fn(pf, pb, xj):
        return jnp.sum(jfn(pf, pb, xj, lengths=jl) * w_read)

    to_j = [{k: jnp.asarray(d[k]) for k in KEYS} for d in dirs]
    ref, (gf, gb, gx) = jax.value_and_grad(loss_fn, argnums=(0, 1, 2))(
        *to_j, jnp.asarray(x))
    got = _torch_value_and_grads(cell, dirs, x, w_read, lens)
    _assert_close(*got, float(ref),
                  [jax.tree.map(np.asarray, g) for g in (gf, gb)],
                  np.asarray(gx))


@pytest.fixture
def pallas_interpret(monkeypatch):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    import forwardtacotron_tpu.kernels.birnn as birnn
    monkeypatch.setattr(birnn.pl, 'pallas_call',
                        functools.partial(pl.pallas_call,
                                          interpret=pltpu.InterpretParams()))


@pytest.mark.parametrize('cell,lens', [('gru', (21, 12)), ('lstm', None)])
def test_train_grads_match_jax_kernel_pair(pallas_interpret, cell, lens):
    """Against the JAX package's `birnn_train` (its Pallas forward/backward
    kernel pair, interpret mode): the same stash layout and gradient
    formulas."""
    from forwardtacotron_tpu.kernels.birnn import birnn_train
    B, T, D, H = 2, 21, 8, 128
    dirs, x, w_read = _case(5, cell, B, T, D, H, lens)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)

    def loss_fn(w, xj):
        y = birnn_train(cell, *(jnp.stack([w[0][k], w[1][k]]) for k in KEYS),
                        xj, jl)
        return jnp.sum(y * w_read)

    to_j = [{k: jnp.asarray(d[k]) for k in KEYS} for d in dirs]
    ref, (gw, gx) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
        to_j, jnp.asarray(x))
    got = _torch_value_and_grads(cell, dirs, x, w_read, lens)
    _assert_close(*got, float(ref),
                  [jax.tree.map(np.asarray, g) for g in gw], np.asarray(gx))


@pytest.mark.parametrize('cell,S', [('gru', 2), ('gru', 6), ('lstm', 2)])
def test_function_matches_autograd_through_plain_recurrence(cell, S):
    """BiRNNTrain's stash-based backward against torch autograd through
    `birnn_recurrence`, at the recurrence's own boundary."""
    from forwardtacotron_tpu_torch.ops.rnn import (BiRNNTrain,
                                                   birnn_recurrence, n_gates)
    rng = np.random.RandomState(S)
    T, B, H = 11, 3, 8
    GH = n_gates(cell) * H
    gi = torch.tensor(_rand(rng, T, B, S, GH, scale=1.0), requires_grad=True)
    w = torch.tensor(_rand(rng, S, GH, H), requires_grad=True)
    b = torch.tensor(_rand(rng, S, GH) if cell == 'gru'
                     else np.zeros((S, GH), np.float32),
                     requires_grad=cell == 'gru')
    lengths = torch.tensor([11, 6, 1], dtype=torch.int32)
    dy = torch.from_numpy(_rand(rng, T, B, S, H, scale=1.0))
    inputs = [gi, w] + ([b] if cell == 'gru' else [])
    y = BiRNNTrain.apply(cell, gi, w, b, lengths, torch.float32)
    grads = torch.autograd.grad(y, inputs, dy)
    y_ref = birnn_recurrence(cell, gi, w, b, lengths, torch.float32)
    refs = torch.autograd.grad(y_ref, inputs, dy)
    torch.testing.assert_close(y, y_ref, rtol=2e-5, atol=1e-5)
    for got, ref in zip(grads, refs):
        torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-5)


def test_no_grad_calls_take_the_inference_recurrence():
    """Without autograd the recurrence is the inference one (kernel #1 on
    the card): no BiRNNTrain node, no stash."""
    from forwardtacotron_tpu_torch.ops import rnn as trnn
    dirs, x, _ = _case(0, 'gru', 2, 5, 4, 3, None)
    pf, pb = ({k: torch.tensor(d[k], requires_grad=True) for k in KEYS}
              for d in dirs)
    with torch.no_grad():
        y = trnn.bigru(pf, pb, torch.from_numpy(x))
    assert y.grad_fn is None
    y = trnn.bigru(pf, pb, torch.from_numpy(x))
    assert _reaches(y.grad_fn, 'BiRNNTrain')
