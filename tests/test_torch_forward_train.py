"""The port's ForwardTacotron training path on the CPU against the JAX
package, same weights and inputs: the teacher-forced forward in eval and
train mode (with the batch-norm running statistics it updates), one full
train step (loss, clipped gradients, parameters after Adam) against
`train/common.py:build_forward_train_step`, and the masked L1 loss and
length-regulator gradients.

Tolerances: outputs atol 1e-4 (the teacher-forced bar of
docs/benchmarks.md); running statistics atol 1e-5; gradients rtol 5e-4 /
atol 5e-5 (tests/test_pallas_birnn.py:185); parameters after one Adam
step atol 1e-6 where |g| > 1e-4 (the update lr * g / (|g| + eps) is then
lr * sign(g), which a gradient within its tolerance cannot change), and
within 2 lr elsewhere (a gradient near zero may take either sign within
its tolerance); losses rtol 1e-5.
"""
import functools

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
NO_DROPOUT = {k: (0.0 if k.endswith('dropout') else v)
              for k, v in TINY.items()}
NUM_CHARS, N_MELS = 40, 6
TRAIN_CFG = {'dur_loss_factor': 0.1, 'pitch_loss_factor': 0.1,
             'energy_loss_factor': 0.1, 'pitch_zoneout': 0.0,
             'energy_zoneout': 0.0, 'clip_grad_norm': 0.05}
OUT_KEYS = ('mel', 'mel_post', 'dur', 'pitch', 'energy')


def _batch(seed=0, x_lens=(10, 7, 4), tx=12, tm=40):
    rng = np.random.RandomState(seed)
    B = len(x_lens)
    x = np.zeros((B, tx), np.int64)
    dur = np.zeros((B, tx), np.float32)
    for i, n in enumerate(x_lens):
        x[i, :n] = rng.randint(1, NUM_CHARS, n)
        dur[i, :n] = rng.randint(0, 5, n)
    mel_len = dur.sum(1).astype(np.int64)
    assert mel_len.max() < tm
    mel = rng.randn(B, tm, N_MELS).astype(np.float32)
    mel[np.arange(tm)[None, :] >= mel_len[:, None]] = -11.5129
    return {'x': x, 'x_len': np.asarray(x_lens, np.int64), 'mel': mel,
            'mel_len': mel_len, 'dur': dur,
            'pitch': rng.randn(B, tx).astype(np.float32),
            'energy': rng.randn(B, tx).astype(np.float32)}


def _jax_batch(b):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in b.items()}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@functools.lru_cache(maxsize=1)
def _variables():
    """JAX weights (dropout rates do not change them) with random running
    statistics, as numpy."""
    from forwardtacotron_tpu.models.forward_tacotron import (
        ForwardTacotron as JaxFT)
    jmodel = JaxFT(num_chars=NUM_CHARS, n_mels=N_MELS, **TINY)
    variables = jax.jit(lambda k: jmodel.init(
        {'params': k}, _jax_batch(_batch()), train=False))(
            jax.random.PRNGKey(0))
    rng = np.random.RandomState(5)

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else
                (rng.randn(*v.shape) * 0.1 if k == 'mean'
                 else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
                for k, v in tree.items()}
    return {'params': jax.tree.map(np.asarray, variables['params']),
            'batch_stats': fill(variables['batch_stats'])}


def _models(cfg):
    """(JAX model, its variables, the port's model with the same
    weights); the port's model is new at every call."""
    from forwardtacotron_tpu.models.forward_tacotron import (
        ForwardTacotron as JaxFT)
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.weights import forward_tacotron_state_dict
    jmodel = JaxFT(num_chars=NUM_CHARS, n_mels=N_MELS, **cfg)
    variables = _variables()
    tmodel = ForwardTacotron(num_chars=NUM_CHARS, n_mels=N_MELS, **cfg)
    tmodel.load_state_dict(forward_tacotron_state_dict(variables, cfg),
                           strict=True)
    return jmodel, variables, tmodel


def _state_dict_of(variables, cfg):
    from forwardtacotron_tpu_torch.weights import forward_tacotron_state_dict
    return forward_tacotron_state_dict(jax.tree.map(np.asarray, variables),
                                       cfg)


def test_teacher_forced_eval_matches_jax():
    jmodel, variables, tmodel = _models(TINY)
    b = _batch(1)
    ref = jax.jit(lambda v, bb: jmodel.apply(v, bb, train=False))(
        variables, _jax_batch(b))
    with torch.no_grad():
        out = tmodel.eval()(_torch_batch(b))
    for k in OUT_KEYS:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-4, err_msg=k)


def test_train_mode_forward_and_bn_stats_match_jax():
    """Batch statistics normalize the batch and move the running
    statistics by momentum 0.1 with the biased variance, as flax does."""
    jmodel, variables, tmodel = _models(NO_DROPOUT)
    b = _batch(2)
    ref, mutated = jax.jit(lambda v, bb: jmodel.apply(
        v, bb, train=True, mutable=['batch_stats'],
        rngs={'dropout': jax.random.PRNGKey(1)}))(variables, _jax_batch(b))
    out = tmodel.train()(_torch_batch(b))
    for k in OUT_KEYS:
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(ref[k]), atol=1e-4, err_msg=k)
    want = _state_dict_of({'params': variables['params'],
                           'batch_stats': mutated['batch_stats']}, NO_DROPOUT)
    got = tmodel.state_dict()
    stats = [k for k in want if k.endswith(('running_mean', 'running_var'))]
    assert len(stats) > 20
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=1e-5, err_msg=k)


def _adam_mu(state):
    if hasattr(state, 'mu'):
        return state.mu
    if isinstance(state, tuple):
        for s in state:
            mu = _adam_mu(s)
            if mu is not None:
                return mu
    return None


def test_train_step_matches_jax():
    """One step with dropout and zoneout 0 and a clip that engages: the
    JAX step is optax's clip_by_global_norm + adam, whose first moment
    after one step is 0.1 * the clipped gradient."""
    from forwardtacotron_tpu.train import common as jtc
    from forwardtacotron_tpu_torch.train import common as tc
    jmodel, variables, tmodel = _models(NO_DROPOUT)
    b = _batch(3)
    lr = 1e-3
    optimizer = jtc.make_optimizer(TRAIN_CFG['clip_grad_norm'], lr=lr)
    state = jtc.TrainState(params=variables['params'],
                           batch_stats=variables['batch_stats'],
                           opt_state=optimizer.init(variables['params']),
                           step=jnp.asarray(0, jnp.int32))
    step = jax.jit(jtc.build_forward_train_step(jmodel, optimizer,
                                                TRAIN_CFG))
    new_state, ref = step(state, _jax_batch(b), jax.random.PRNGKey(0))

    topt = tc.make_optimizer(tmodel, lr=lr)
    metrics = tc.train_step(tmodel, topt, _torch_batch(b),
                            torch.Generator().manual_seed(0), TRAIN_CFG)
    for k in ('loss', 'mel_loss', 'dur_loss', 'pitch_loss', 'energy_loss',
              'grad_norm'):
        np.testing.assert_allclose(float(metrics[k]), float(ref[k]),
                                   rtol=1e-5, err_msg=k)
    assert float(metrics['grad_norm']) > TRAIN_CFG['clip_grad_norm']

    clipped = jax.tree.map(lambda m: np.asarray(m) / 0.1,
                           _adam_mu(new_state.opt_state))
    want_grads = _state_dict_of({'params': clipped,
                                 'batch_stats': variables['batch_stats']},
                                NO_DROPOUT)
    want_params = _state_dict_of(new_state.variables, NO_DROPOUT)
    got_params = tmodel.state_dict()
    named = dict(tmodel.named_parameters())
    assert len(named) > 50
    for k, p in named.items():
        g = want_grads[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=5e-4, atol=5e-5,
                                   err_msg=k)
        delta = np.abs(got_params[k].numpy() - want_params[k].numpy())
        assert delta.max() <= 2 * lr + 1e-6, k
        assert np.all(delta[np.abs(g) > 1e-4] <= 1e-6), k
    for k in want_params:
        if k.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(got_params[k].numpy(),
                                       want_params[k].numpy(), atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize('shape', [(3, 9, 4), (3, 9)])
def test_masked_l1_matches_jax(shape):
    from forwardtacotron_tpu.ops.masking import masked_l1 as jl1
    from forwardtacotron_tpu_torch.ops.masking import masked_l1
    rng = np.random.RandomState(len(shape))
    x = rng.randn(*shape).astype(np.float32)
    target = rng.randn(*shape).astype(np.float32)
    lens = np.asarray([9, 4, 0])
    ref, ref_grad = jax.value_and_grad(jl1)(jnp.asarray(x),
                                            jnp.asarray(target),
                                            jnp.asarray(lens))
    xt = torch.tensor(x, requires_grad=True)
    out = masked_l1(xt, torch.from_numpy(target), torch.from_numpy(lens))
    out.backward()
    np.testing.assert_allclose(float(out.detach()), float(ref), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_grad),
                               rtol=1e-6, atol=1e-9)


def test_length_regulator_gradient_matches_jax():
    """The gather's scatter-add backward equals the JAX one-hot matmul."""
    from forwardtacotron_tpu.ops.length_regulator import (
        length_regulate as jlr)
    from forwardtacotron_tpu_torch.ops.length_regulator import length_regulate
    rng = np.random.RandomState(4)
    x = rng.randn(3, 7, 5).astype(np.float32)
    dur = rng.uniform(-1.0, 3.5, (3, 7)).astype(np.float32)
    dur[2] = 0.0
    w = rng.randn(3, 16, 5).astype(np.float32)
    ref = jax.grad(lambda a: jnp.sum(jlr(a, jnp.asarray(dur), max_t=16)[0]
                                     * w))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out, _ = length_regulate(xt, torch.from_numpy(dur), 16)
    torch.sum(out * torch.from_numpy(w)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
