"""The port's ForwardTacotron (CPU, float32 plain path) against the JAX
package's model with the same weights and inputs.

Tolerances follow docs/benchmarks.md: padded-bucket generate mel at
atol 1e-4 with mean-abs < 1e-3 and exactly equal `mel_len`; series at
atol 1e-5.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

TINY = {
    'embed_dims': 16, 'series_embed_dims': 8,
    'durpred_conv_dims': 12, 'durpred_rnn_dims': 4, 'durpred_dropout': 0.5,
    'pitch_conv_dims': 12, 'pitch_rnn_dims': 6, 'pitch_dropout': 0.5,
    'pitch_strength': 1.0,
    'energy_conv_dims': 12, 'energy_rnn_dims': 3, 'energy_dropout': 0.5,
    'energy_strength': 0.7,
    'rnn_dims': 12, 'prenet_dims': 8, 'prenet_k': 3, 'prenet_dropout': 0.5,
    'prenet_num_highways': 2, 'postnet_dims': 8, 'postnet_k': 2,
    'postnet_num_highways': 1, 'postnet_dropout': 0.0,
}
NUM_CHARS, N_MELS = 40, 6
F32 = torch.float32


def _randomize_batch_stats(variables, rng):
    def fill(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            elif k == 'mean':
                out[k] = jnp.asarray(rng.randn(*v.shape).astype(np.float32)
                                     * 0.1)
            else:
                out[k] = jnp.asarray(rng.uniform(0.5, 1.5, v.shape)
                                     .astype(np.float32))
        return out
    return {'params': variables['params'],
            'batch_stats': fill(variables['batch_stats'])}


@pytest.fixture(scope='module')
def models():
    from forwardtacotron_tpu.models.forward_tacotron import (
        ForwardTacotron as JaxFT)
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.weights import forward_tacotron_state_dict
    jmodel = JaxFT(num_chars=NUM_CHARS, n_mels=N_MELS, **TINY)
    x0 = jnp.ones((1, 8), jnp.int32)
    variables = jax.jit(lambda k: jmodel.init(
        {'params': k}, x0, 32, method='generate',
        x_len=jnp.asarray([8])))(jax.random.PRNGKey(0))
    variables = _randomize_batch_stats(variables, np.random.RandomState(5))
    variables = jax.tree.map(np.asarray, variables)
    tmodel = ForwardTacotron(num_chars=NUM_CHARS, n_mels=N_MELS, **TINY)
    tmodel.load_state_dict(forward_tacotron_state_dict(variables, TINY),
                           strict=True)
    return jmodel, variables, tmodel


def _batch(seed, lens, tx=12):
    rng = np.random.RandomState(seed)
    x = np.zeros((len(lens), tx), dtype=np.int64)
    for i, n in enumerate(lens):
        x[i, :n] = rng.randint(1, NUM_CHARS, n)
    return x, np.asarray(lens)


def test_predict_series_matches_jax(models):
    jmodel, variables, tmodel = models
    x, lens = _batch(0, [12, 7])
    kw = dict(alpha=1.3, pitch_scale=0.8, energy_scale=1.2)
    ref = jmodel.apply(variables, jnp.asarray(x), method='predict_series',
                       x_len=jnp.asarray(lens), **kw)
    out = tmodel.predict_series(torch.from_numpy(x),
                                x_len=torch.from_numpy(lens),
                                compute_dtype=F32, **kw)
    for k in ('dur', 'pitch', 'energy'):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, err_msg=k)


def test_generate_from_series_matches_jax(models):
    jmodel, variables, tmodel = models
    x, lens = _batch(1, [12, 5])
    rng = np.random.RandomState(2)
    dur = rng.uniform(0.0, 4.0, x.shape).astype(np.float32)
    pitch = rng.randn(*x.shape).astype(np.float32)
    energy = rng.randn(*x.shape).astype(np.float32)
    max_t = 64
    ref = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(dur),
                       jnp.asarray(pitch), jnp.asarray(energy), max_t,
                       method='generate_from_series',
                       x_len=jnp.asarray(lens), fast=False)
    out = tmodel.generate_from_series(
        torch.from_numpy(x), torch.from_numpy(dur), torch.from_numpy(pitch),
        torch.from_numpy(energy), max_t, x_len=torch.from_numpy(lens),
        compute_dtype=F32)
    np.testing.assert_array_equal(out['mel_len'].numpy(),
                                  np.asarray(ref['mel_len']))
    for k in ('mel', 'mel_post'):
        for i, n in enumerate(out['mel_len'].tolist()):
            a = out[k][i, :n].numpy()
            b = np.asarray(ref[k])[i, :n]
            np.testing.assert_allclose(a, b, atol=1e-4, err_msg=k)
            assert np.mean(np.abs(a - b)) < 1e-3


@pytest.mark.parametrize('scale', [1.0, -1.0])
def test_generate_matches_jax(models, scale):
    """End-to-end generate. scale=-1 negates the duration head so every
    predicted duration is <= 0 and `_dur_floor` replaces them by 2."""
    jmodel, variables, tmodel = models
    if scale < 0:
        params = jax.tree.map(lambda a: a, variables['params'])
        lin = dict(params['dur_pred']['lin'])
        lin['kernel'] = -np.abs(lin['kernel'])
        lin['bias'] = -np.abs(lin['bias']) - 5.0
        params['dur_pred'] = dict(params['dur_pred'], lin=lin)
        variables = dict(variables, params=params)
        from forwardtacotron_tpu_torch.models.forward_tacotron import (
            ForwardTacotron)
        from forwardtacotron_tpu_torch.weights import (
            forward_tacotron_state_dict)
        tmodel = ForwardTacotron(num_chars=NUM_CHARS, n_mels=N_MELS, **TINY)
        tmodel.load_state_dict(forward_tacotron_state_dict(variables, TINY))
    x, lens = _batch(3, [11, 6])
    max_t = 48
    ref = jmodel.apply(variables, jnp.asarray(x), max_t, method='generate',
                       x_len=jnp.asarray(lens), fast=False)
    out = tmodel.generate(torch.from_numpy(x), max_t,
                          x_len=torch.from_numpy(lens), compute_dtype=F32)
    if scale < 0:
        assert np.all(out['dur'].numpy() == 2.0)
    np.testing.assert_allclose(out['dur'].numpy(), np.asarray(ref['dur']),
                               atol=1e-5)
    np.testing.assert_array_equal(out['mel_len'].numpy(),
                                  np.asarray(ref['mel_len']))
    for i, n in enumerate(out['mel_len'].tolist()):
        n = min(n, max_t)
        np.testing.assert_allclose(out['mel_post'][i, :n].numpy(),
                                   np.asarray(ref['mel_post'])[i, :n],
                                   atol=1e-4)
