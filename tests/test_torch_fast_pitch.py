"""The port's FastPitch on the CPU against the JAX package's model, same
weights (through `fast_pitch_state_dict`) and same seeded inputs.

Tolerances: the state_dict equal key for key and value for value to the
JAX package's `export_fast_pitch`; the teacher-forced forward (mel,
mel_post, dur, pitch, energy) at atol 1e-4 in eval mode and, with every
dropout at 0, in train mode, with the loss's gradients against
`jax.grad` at atol 1e-4; the series at atol 1e-5; padded-bucket
`generate` with a mel mean absolute error below 1e-3 and equal
`mel_len`; a padded bucket against an exact-length run of the port at
atol 1e-5; the batch-wide duration floor as JAX applies it.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

TINY_CFG = {
    'durpred_dropout': 0.5, 'durpred_d_model': 8, 'durpred_n_heads': 2,
    'durpred_layers': 1, 'durpred_d_fft': 8,
    'pitch_dropout': 0.5, 'pitch_d_model': 8, 'pitch_n_heads': 2,
    'pitch_layers': 1, 'pitch_d_fft': 8,
    'energy_dropout': 0.5, 'energy_d_model': 8, 'energy_n_heads': 2,
    'energy_layers': 1, 'energy_d_fft': 8,
    'pitch_strength': 1.0, 'energy_strength': 1.0,
    'd_model': 16, 'conv1_kernel': 9, 'conv2_kernel': 1,
    'prenet_layers': 2, 'prenet_heads': 2, 'prenet_fft': 16,
    'prenet_dropout': 0.1,
    'postnet_layers': 2, 'postnet_heads': 2, 'postnet_fft': 16,
    'postnet_dropout': 0.1,
}
NO_DROPOUT = {k: (0.0 if k.endswith('dropout') else v)
              for k, v in TINY_CFG.items()}
NUM_CHARS, N_MELS = 50, 6
TRAIN_CFG = {'dur_loss_factor': 0.1, 'pitch_loss_factor': 0.1,
             'energy_loss_factor': 0.1}


def _batch(seed=1):
    """Two items: the second's tokens padded, mel lengths 8 and 6 in a
    10-frame mel."""
    rng = np.random.RandomState(seed)
    x = rng.randint(1, NUM_CHARS, size=(2, 6))
    x[1, 4:] = 0
    dur = np.array([[2, 1, 2, 1, 1, 1], [2, 2, 1, 1, 0, 0]], np.float32)
    mel_len = dur.sum(axis=1).astype(np.int64)
    return {'x': x.astype(np.int64), 'x_len': np.array([6, 4]),
            'mel': (rng.randn(2, 10, N_MELS) * 2 - 5).astype(np.float32),
            'mel_len': mel_len, 'dur': dur,
            'pitch': rng.randn(2, 6).astype(np.float32),
            'energy': rng.randn(2, 6).astype(np.float32)}


def _jax_batch(b):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _variables(cfg_name='tiny'):
    from forwardtacotron_tpu.models.fast_pitch import FastPitch as JaxFP
    cfg = TINY_CFG if cfg_name == 'tiny' else NO_DROPOUT
    jmodel = JaxFP(num_chars=NUM_CHARS, n_mels=N_MELS, **cfg)
    variables = jax.jit(lambda k: jmodel.init(
        {'params': k}, _jax_batch(_batch()), train=False))(
            jax.random.PRNGKey(0))
    # non-trivial layer norms and position scales
    rng = np.random.RandomState(7)

    def fill(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v, path + (k,))
            elif k == 'scale' or k == 'pos_scale':
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == 'bias' and path[-1].startswith('norm'):
                out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return {'params': fill(variables['params'])}


def _jax_model(cfg=TINY_CFG):
    from forwardtacotron_tpu.models.fast_pitch import FastPitch as JaxFP
    return JaxFP(num_chars=NUM_CHARS, n_mels=N_MELS, **cfg)


def _port_model(cfg=TINY_CFG, variables=None):
    from forwardtacotron_tpu_torch.models.fast_pitch import FastPitch
    from forwardtacotron_tpu_torch.weights import fast_pitch_state_dict
    model = FastPitch(num_chars=NUM_CHARS, n_mels=N_MELS, **cfg)
    variables = variables or _variables('tiny' if cfg is TINY_CFG else 'nd')
    model.load_state_dict(fast_pitch_state_dict(variables, cfg),
                          strict=True)
    return model


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_state_dict_equals_export_fast_pitch():
    from forwardtacotron_tpu.models.torch_export import export_fast_pitch
    from forwardtacotron_tpu_torch.weights import fast_pitch_state_dict
    variables = _variables()
    sd = fast_pitch_state_dict(variables, TINY_CFG, step=17)
    ref = export_fast_pitch(variables, TINY_CFG, step=17)
    assert set(sd) == set(ref)
    for k in ref:
        assert sd[k].dtype == ref[k].dtype and sd[k].shape == ref[k].shape \
            and torch.equal(sd[k], ref[k]), k
    assert sd['prenet.pos_encoder.pe'].shape == (5000, 1, 16)
    _port_model()        # loads strictly
    # a single-speaker model has no speaker parameter (the multi-speaker
    # ones: tests/test_torch_multispeaker.py)
    assert not any('speaker' in k or 'spk' in k for k in sd)


def _assert_outputs(out, ref, atol):
    for k in ('mel', 'mel_post', 'dur', 'pitch', 'energy'):
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(ref[k]), atol=atol,
                                   err_msg=k)


def test_teacher_forced_eval_matches_jax():
    b = _batch()
    ref = _jax_model().apply(_variables(), _jax_batch(b), train=False)
    model = _port_model().eval()
    with torch.no_grad():
        out = model(_torch_batch(b))
    _assert_outputs(out, ref, 1e-4)
    # frames at or past the batch's longest mel hold the padding value,
    # and the two mels are one tensor
    assert out['mel'] is out['mel_post']
    assert np.all(out['mel'][:, 8:].numpy() == np.float32(-11.5129))


def test_teacher_forced_train_and_grads_match_jax():
    """Train mode with every dropout at 0 (a generator is still given), and
    the gradients of the trainers' loss against jax.grad."""
    from forwardtacotron_tpu.train.common import forward_loss as jax_loss
    from forwardtacotron_tpu_torch.train.common import forward_loss
    b = _batch(3)
    jb = _jax_batch(b)
    jmodel, variables = _jax_model(NO_DROPOUT), _variables('nd')

    def loss_fn(params):
        pred = jmodel.apply({'params': params}, jb, train=True,
                            rngs={'dropout': jax.random.PRNGKey(1)})
        return jax_loss(pred, jb, jb['pitch'], jb['energy'], TRAIN_CFG)[0], \
            pred
    (jloss, ref), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree.map(jnp.asarray,
                                             variables['params']))

    model = _port_model(NO_DROPOUT).train()
    tb = _torch_batch(b)
    out = model(tb, torch.Generator().manual_seed(0))
    _assert_outputs(out, ref, 1e-4)
    loss, _ = forward_loss(out, tb, tb['pitch'], tb['energy'], TRAIN_CFG)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               atol=1e-4)
    loss.backward()
    from forwardtacotron_tpu_torch.weights import fast_pitch_state_dict
    ref_grads = fast_pitch_state_dict({'params': jax.tree.map(
        np.asarray, jgrads)}, NO_DROPOUT)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(),
                                   atol=1e-4, err_msg=name)
    with pytest.raises(ValueError, match='generator'):
        model(tb)


def _tokens(lens, tx, seed):
    rng = np.random.RandomState(seed)
    x = np.zeros((len(lens), tx), np.int64)
    for i, n in enumerate(lens):
        x[i, :n] = rng.randint(1, NUM_CHARS, n)
    return x, np.asarray(lens)


def test_predict_series_matches_jax():
    x, lens = _tokens([12, 7], 16, 0)
    kw = dict(alpha=1.3, pitch_scale=0.8, energy_scale=1.2)
    ref = _jax_model().apply(_variables(), jnp.asarray(x),
                             method='predict_series',
                             x_len=jnp.asarray(lens), **kw)
    out = _port_model().predict_series(torch.from_numpy(x),
                                       x_len=torch.from_numpy(lens), **kw)
    for k in ('dur', 'pitch', 'energy'):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match='float32'):
        _port_model().predict_series(torch.from_numpy(x),
                                     compute_dtype=torch.bfloat16)


def _durations_variables(bias, gain=1.0):
    """The weights with the duration head's bias set to `bias` and its
    kernel scaled by `gain`."""
    variables = _variables()
    params = dict(variables['params'])
    pred = dict(params['dur_pred'])
    pred['lin'] = dict(pred['lin'], bias=np.full((1,), bias, np.float32),
                       kernel=pred['lin']['kernel'] * np.float32(gain))
    params['dur_pred'] = pred
    return {'params': params}


def test_generate_padded_bucket_matches_jax():
    """A padded 16-token bucket and a 64-frame mel bucket; the durations
    lifted so that every token lasts a few frames."""
    variables = _durations_variables(2.5)
    x, lens = _tokens([12, 5], 16, 4)
    ref = _jax_model().apply(variables, jnp.asarray(x), 64,
                             method='generate', x_len=jnp.asarray(lens))
    out = _port_model(variables=variables).generate(
        torch.from_numpy(x), 64, x_len=torch.from_numpy(lens))
    np.testing.assert_array_equal(out['mel_len'].numpy(),
                                  np.asarray(ref['mel_len']))
    for i, n in enumerate(out['mel_len'].tolist()):
        assert 0 < n <= 64
        for k in ('mel', 'mel_post'):
            a, b = out[k][i, :n].numpy(), np.asarray(ref[k])[i, :n]
            assert np.mean(np.abs(a - b)) < 1e-3, k
            np.testing.assert_allclose(a, b, atol=1e-4, err_msg=k)


def test_padded_bucket_equals_exact_length_run():
    variables = _durations_variables(2.5)
    model = _port_model(variables=variables)
    x, lens = _tokens([9], 16, 5)
    dur = torch.full((1, 16), 3.0)
    pitch = torch.from_numpy(np.random.RandomState(6).randn(1, 16)
                             .astype(np.float32))
    padded = model.generate_from_series(torch.from_numpy(x), dur, pitch,
                                        pitch * 0.5, 64,
                                        x_len=torch.from_numpy(lens))
    exact = model.generate_from_series(torch.from_numpy(x[:, :9]),
                                       dur[:, :9], pitch[:, :9],
                                       pitch[:, :9] * 0.5, 27)
    assert int(padded['mel_len'][0]) == int(exact['mel_len'][0]) == 27
    np.testing.assert_allclose(padded['mel'][0, :27].numpy(),
                               exact['mel'][0].numpy(), atol=1e-5)
    series = model.predict_series(torch.from_numpy(x),
                                  x_len=torch.from_numpy(lens))
    alone = model.predict_series(torch.from_numpy(x[:, :9]))
    for k in ('dur', 'pitch', 'energy'):
        np.testing.assert_allclose(series[k][0, :9].numpy(),
                                   alone[k][0].numpy(), atol=1e-5)


def test_duration_floor_is_batch_wide_as_in_jax():
    """Biases of the duration head at which one row's truncated sum is
    <= 0 while the batch's is > 0 (no floor anywhere), and at which one
    row's is > 0 while the batch's is <= 0 (every duration 2), each
    against JAX."""
    x, lens = _tokens([10, 6], 12, 8)
    xt, lt = torch.from_numpy(x), torch.from_numpy(lens)
    gain = 8.0
    model = _port_model(variables=_durations_variables(0.0, gain))
    with torch.no_grad():
        raw0 = model.dur_pred(xt, torch.arange(12)[None] >= lt[:, None],
                              masked=True).numpy()
    cases = {}
    for bias in np.linspace(-8.0, 8.0, 641, dtype=np.float32):
        rows = [int(np.sum(np.trunc(raw0[i, :n] + bias)))
                for i, n in enumerate(lens)]
        if min(rows) <= 0 < sum(rows):
            cases.setdefault('row_floor_only', float(bias))
        if max(rows) > 0 >= sum(rows):
            cases.setdefault('batch_floor', float(bias))
    assert set(cases) == {'row_floor_only', 'batch_floor'}, cases
    for name, bias in cases.items():
        variables = _durations_variables(bias, gain)
        ref = _jax_model().apply(variables, jnp.asarray(x),
                                 method='predict_series',
                                 x_len=jnp.asarray(lens))
        out = _port_model(variables=variables).predict_series(xt,
                                                              x_len=lt)
        np.testing.assert_allclose(out['dur'].numpy(),
                                   np.asarray(ref['dur']), atol=1e-5)
        floored = bool(torch.all(out['dur'] == 2.0))
        assert floored == (name == 'batch_floor'), name
