"""The port's bidirectional RNN ops (CPU plain path of the BiRNN kernel)
against the JAX package's scan ops and, in bfloat16, against its Pallas
kernel run in interpret mode, as tests/test_pallas_birnn.py runs it.

float32 at atol 1e-5 (the JAX package's kernel-vs-scan bar).
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch


def _rand(rng, *shape):
    return (rng.randn(*shape) * 0.3).astype(np.float32)


def _dir_params(rng, gates, H, D):
    return {'w_ih': _rand(rng, gates * H, D), 'w_hh': _rand(rng, gates * H, H),
            'b_ih': _rand(rng, gates * H), 'b_hh': _rand(rng, gates * H)}


def _jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _torch(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


@pytest.mark.parametrize('cell', ['lstm', 'gru'])
@pytest.mark.parametrize('B,lens', [(1, None), (3, (17, 9, 1)),
                                    (10, tuple(range(17, 7, -1)))])
def test_birnn_matches_jax(cell, B, lens):
    from forwardtacotron_tpu.ops import rnn as jrnn
    from forwardtacotron_tpu_torch.ops import rnn as trnn
    rng = np.random.RandomState(B + len(cell))
    T, D, H = 17, 12, 16
    gates = 4 if cell == 'lstm' else 3
    pf, pb = _dir_params(rng, gates, H, D), _dir_params(rng, gates, H, D)
    x = _rand(rng, B, T, D)
    jl = None if lens is None else jnp.asarray(lens)
    tl = None if lens is None else torch.tensor(lens)
    jfn = jrnn.bilstm if cell == 'lstm' else jrnn.bigru
    tfn = trnn.bilstm if cell == 'lstm' else trnn.bigru
    ref = jfn(_jax(pf), _jax(pb), jnp.asarray(x), lengths=jl, pad_value=-3.0)
    out = tfn(_torch(pf), _torch(pb), torch.from_numpy(x), lengths=tl,
              pad_value=-3.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def _grouped_weights(rng, h_groups, D, pad_fn, to):
    H = max(h_groups)
    out = {}
    for key in ('w_ih', 'w_hh', 'b_ih', 'b_hh'):
        dirs = []
        for _ in range(2):
            ws = []
            for hg in h_groups:
                shape = {'w_ih': (3 * hg, D), 'w_hh': (3 * hg, hg),
                         'b_ih': (3 * hg,), 'b_hh': (3 * hg,)}[key]
                w = pad_fn(to(_rand(rng, *shape)), hg, H)
                if key == 'w_hh' and hg != H:
                    w = to(np.pad(np.asarray(w), ((0, 0), (0, H - hg))))
                ws.append(np.asarray(w))
            dirs.append(np.stack(ws))
        out[key] = np.stack(dirs)
    return out


def test_grouped_bigru_matches_jax():
    """Three groups of H 64/128/64, gate blocks zero-padded to 128."""
    from forwardtacotron_tpu.ops import rnn as jrnn
    from forwardtacotron_tpu_torch.ops import rnn as trnn
    D, T, B = 24, 19, 2
    w = _grouped_weights(np.random.RandomState(7), (64, 128, 64), D,
                         jrnn.pad_gru_gates, jnp.asarray)
    w_t = _grouped_weights(np.random.RandomState(7), (64, 128, 64), D,
                           trnn.pad_gru_gates, torch.from_numpy)
    for k in w:
        np.testing.assert_array_equal(w[k], w_t[k])
    x = _rand(np.random.RandomState(8), B, T, 3, D)
    lens = (19, 11)
    ref = jrnn.grouped_bigru(*(jnp.asarray(w[k]) for k in
                               ('w_ih', 'w_hh', 'b_ih', 'b_hh')),
                             jnp.asarray(x), lengths=jnp.asarray(lens))
    out = trnn.grouped_bigru(*(torch.from_numpy(w[k]) for k in
                               ('w_ih', 'w_hh', 'b_ih', 'b_hh')),
                             torch.from_numpy(x), lengths=torch.tensor(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.fixture
def pallas_interpret(monkeypatch):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    import forwardtacotron_tpu.kernels.birnn as birnn
    monkeypatch.setattr(birnn.pl, 'pallas_call',
                        functools.partial(pl.pallas_call,
                                          interpret=pltpu.InterpretParams()))


@pytest.mark.parametrize('cell', ['lstm', 'gru'])
def test_bf16_plain_matches_pallas_kernel(pallas_interpret, cell):
    """The plain version's bfloat16 mode rounds gi, W_hh and h where the
    TPU kernel does, so both give the same values up to summation order
    (and the rare bf16 rounding flip that order causes)."""
    from forwardtacotron_tpu.kernels.birnn import birnn_pallas
    from forwardtacotron_tpu_torch.ops.rnn import grouped_birnn
    rng = np.random.RandomState(11)
    B, T, G, D, H = 2, 21, 1, 32, 128
    gates = 4 if cell == 'lstm' else 3
    w = [_rand(rng, 2, G, gates * H, D), _rand(rng, 2, G, gates * H, H) / 4,
         _rand(rng, 2, G, gates * H), _rand(rng, 2, G, gates * H)]
    x = _rand(rng, B, T, G, D)
    lens = (21, 13)
    ref = birnn_pallas(cell, *(jnp.asarray(a) for a in w), jnp.asarray(x),
                       lengths=jnp.asarray(lens), compute_dtype=jnp.bfloat16)
    out = grouped_birnn(cell, *(torch.from_numpy(a) for a in w),
                        torch.from_numpy(x), lengths=torch.tensor(lens),
                        compute_dtype=torch.bfloat16)
    err = np.abs(out.numpy() - np.asarray(ref))
    assert err.max() < 2e-2 and np.mean(err) < 1e-4, (err.max(), err.mean())


def test_length_regulate_matches_jax():
    from forwardtacotron_tpu.ops.length_regulator import (
        length_regulate as jlr)
    from forwardtacotron_tpu_torch.ops.length_regulator import length_regulate
    rng = np.random.RandomState(2)
    x = _rand(rng, 3, 7, 5)
    dur = rng.uniform(-1.0, 3.5, (3, 7)).astype(np.float32)
    dur[2] = 0.0
    ref, ref_len = jlr(jnp.asarray(x), jnp.asarray(dur), max_t=16)
    out, out_len = length_regulate(torch.from_numpy(x), torch.from_numpy(dur),
                                   16)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref_len))
