"""The trainers' options on the CPU against the JAX package at a tiny
width: gradient accumulation and EMA weights in the student's step here,
its rematerialisation and bf16 mixed precision in
tests/test_torch_train_options_remat_bf16.py, the teacher's, WaveRNN's
and the GAN's steps and the options each trainer refuses in
tests/test_torch_train_options_{teacher,wavernn,gan}.py; the helpers and
tolerances they share are here. Same weights through the weight bridge,
the same numpy-seeded batches, and dropout and zoneout 0 wherever the
JAX step is the reference.

Tolerances:
- float32 options against JAX: losses and metrics rtol 1e-5; gradients
  rtol 5e-4 / atol 5e-5 (tests/test_torch_forward_train.py); parameters
  after one Adam step within 1e-5 where |g| > 1e-4 (the update is then
  lr * sign(g)) and within 2 lr elsewhere; running statistics rtol 1e-5
  / atol 1e-6 (the postnet's batch statistics inherit the forward's
  float32 differences, up to 2e-6 relative measured; 1e-6 absolute on
  variances up to ~9 would ask for more than float32 sums give).
- EMA: the port's EMA after each step equals JAX's `ema_update` of the
  port's own parameters at atol 1e-7 (the same rounding), and
  `evaluate()` equals an evaluation with the EMA weights put in by hand
  at rtol 1e-6.
- remat against the port without it, dropout live: running statistics
  exactly equal, gradients atol 1e-6.
- bf16 against JAX's bf16 step: the relative L2 distance (all parameters
  together) of the port's clipped gradients and of its parameter updates
  from JAX's bf16 ones is at most C_BF16 times the distance of JAX's own
  float32 step from its bf16 one, on the same input. The two bf16 steps
  are not the same arithmetic: the port keeps the recurrent state in
  float32 (the kernels' design), JAX's CPU path keeps it in bfloat16.
"""
import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_forward_train import (NO_DROPOUT, TRAIN_CFG, _adam_mu,
                                      _batch, _jax_batch, _models,
                                      _state_dict_of, _torch_batch)

# the ratio (port bf16 from JAX bf16) / (JAX f32 from JAX bf16) measured
# on these inputs: student gradients 0.69, updates 0.87; teacher 0.65;
# WaveRNN RAW 1.09, MOL 0.95; discriminators 0.78, generator 1.41 (tests/
# test_torch_train_options_{teacher,wavernn,gan}.py). 2 bounds them all
# with room for another machine's rounding
C_BF16 = 2.0
# the bf16 gradients' distance from a float32 step on the same inputs, as
# a share of JAX's own bf16-f32 distance, is at least this: measured 0.51
# (student) to 1.11 against JAX's float32 step, 1.30 for the generator
# against the port's own; 3e-5 at most for a port that ignores
# `precision` (every step in float32), so a tenth tells them apart
BF16_APART = 0.1
LR = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _rel(a, b):
    """||a - b|| / ||b|| over every key of two state_dict-like maps."""
    num = sum(float(np.sum((np.asarray(a[k], np.float64)
                            - np.asarray(b[k], np.float64)) ** 2))
              for k in b)
    den = sum(float(np.sum(np.asarray(b[k], np.float64) ** 2)) for k in b)
    return (num / den) ** 0.5


CLIP = 0.05


def _params_of(model):
    return [k for k, _ in model.named_parameters()]


def _adam_grads(opt_state, to_sd, names, scale=0.1):
    """The clipped gradient of a first optax step, from its first
    moment, as a port state_dict of the parameters."""
    sd = to_sd(jax.tree.map(lambda m: np.asarray(m) / scale,
                            _adam_mu(opt_state)))
    return {k: sd[k].numpy() for k in names}


def _check_c_relative(port_grads, ref16, ref32, what, port32=None):
    """The c-relative form; and the port's bf16 step is not a float32
    one: it lies at least BF16_APART x d_ref from a float32 result on the
    same inputs, `port32` (the port's own float32 step) where given, else
    JAX's float32 step."""
    d, d_ref = _rel(port_grads, ref16), _rel(ref32, ref16)
    d32 = _rel(port_grads, ref32 if port32 is None else port32)
    print(f'bf16 {what}: {d:.3g} vs {d_ref:.3g}; from float32 {d32:.3g}')
    assert 0 < d_ref and d <= C_BF16 * d_ref, what
    assert d32 >= BF16_APART * d_ref, what


def _jax_step(cfg, train_cfg, batch, n_steps=1):
    """JAX's `build_forward_train_step` from the shared weights: (clipped
    gradients of the last step, parameters, state_dict after, metrics),
    the first two as port state_dict maps of the parameters."""
    from forwardtacotron_tpu.train import common as jtc
    jmodel, variables, tmodel = _models(cfg)
    optimizer = jtc.make_optimizer(train_cfg['clip_grad_norm'], lr=LR)
    ema = float(train_cfg.get('ema_decay', 0) or 0) > 0
    state = jtc.TrainState(params=variables['params'],
                           batch_stats=variables['batch_stats'],
                           opt_state=optimizer.init(variables['params']),
                           step=jnp.asarray(0, jnp.int32),
                           ema_params=jax.tree.map(jnp.array,
                                                   variables['params'])
                           if ema else None)
    step = jax.jit(jtc.build_forward_train_step(jmodel, optimizer,
                                                train_cfg))
    for i in range(n_steps):
        state, metrics = step(state, _jax_batch(batch),
                              jax.random.PRNGKey(i))
    names = [k for k, _ in tmodel.named_parameters()]
    grads = _state_dict_of({'params': jax.tree.map(
        lambda m: np.asarray(m) / 0.1, _adam_mu(state.opt_state)),
        'batch_stats': variables['batch_stats']}, cfg)
    after = _state_dict_of(state.variables, cfg)
    return ({k: grads[k].numpy() for k in names}, after,
            {k: float(v) for k, v in metrics.items()}, state)


def _port_step(cfg, train_cfg, batch, model=None):
    """The port's `train_step` from the shared weights (or `model`):
    (clipped gradients, state_dict after, metrics, model)."""
    from forwardtacotron_tpu_torch.train import common as tc
    tmodel = _models(cfg)[2] if model is None else model
    topt = tc.make_optimizer(tmodel, lr=LR)
    metrics = tc.train_step(tmodel, topt, _torch_batch(batch),
                            torch.Generator().manual_seed(0), train_cfg)
    grads = {k: p.grad.numpy().copy() for k, p in tmodel.named_parameters()}
    after = {k: v.numpy().copy() for k, v in tmodel.state_dict().items()}
    return grads, after, {k: float(v) for k, v in metrics.items()}, tmodel


def _check_f32(port, ref, before):
    """Port against JAX in float32: metrics, gradients, parameters after
    Adam, running statistics (the module docstring's tolerances)."""
    grads, after, metrics, _ = port
    want_grads, want_after, want_metrics, _ = ref
    for k in ('loss', 'mel_loss', 'dur_loss', 'pitch_loss', 'energy_loss',
              'grad_norm'):
        np.testing.assert_allclose(metrics[k], want_metrics[k], rtol=1e-5,
                                   err_msg=k)
    for k, g in want_grads.items():
        np.testing.assert_allclose(grads[k], g, rtol=5e-4, atol=5e-5,
                                   err_msg=k)
        delta = np.abs(after[k] - want_after[k].numpy())
        assert delta.max() <= 2 * LR + 1e-6, k
        assert np.all(delta[np.abs(g) > 1e-4] <= 1e-5), k
    stats = [k for k in want_after
             if k.endswith(('running_mean', 'running_var'))]
    assert len(stats) > 20
    for k in stats:
        np.testing.assert_allclose(after[k], want_after[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        assert not np.array_equal(after[k], before[k].numpy()), k


def test_student_grad_accum_matches_jax():
    """grad_accum 2 on a batch of 4: two micro-batches of 2 at the batch's
    padded length, the gradient averaged, the running statistics moved
    twice in order, the metrics averaged."""
    cfg = dict(TRAIN_CFG, grad_accum=2)
    b = _batch(6, x_lens=(10, 7, 4, 9))
    before = _models(NO_DROPOUT)[2].state_dict()
    port = _port_step(NO_DROPOUT, cfg, b)
    _check_f32(port, _jax_step(NO_DROPOUT, cfg, b), before)
    # not the same as one step on the whole batch
    whole = _port_step(NO_DROPOUT, TRAIN_CFG, b)
    assert abs(whole[2]['loss'] - port[2]['loss']) > 1e-4


def test_student_ema_follows_jax_formula():
    """ema_decay 0.9 over 3 steps: the EMA starts as a copy of the
    parameters and after each step is JAX's `ema_update` of the new
    parameters; the trainer's `evaluate()` scores the EMA weights with the
    live buffers; a one-step EMA equals JAX's step's."""
    from forwardtacotron_tpu.train import common as jtc
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.forward_trainer import (
        ForwardTrainer)
    cfg = dict(TRAIN_CFG, ema_decay=0.9)
    model = _models(NO_DROPOUT)[2]
    ema = tc.make_ema(model, cfg)
    assert all(torch.equal(ema.params[k], p) and ema.params[k] is not p
               for k, p in model.named_parameters())
    opt = tc.make_optimizer(model, lr=LR)
    # copies: jnp.asarray may alias a numpy view of a tensor that the
    # step then updates in place
    want = {k: jnp.asarray(v.numpy().copy()) for k, v in ema.params.items()}
    for i in range(3):
        tc.train_step(model, opt, _torch_batch(_batch(10 + i)),
                      torch.Generator().manual_seed(i), cfg, ema)
        want = jtc.ema_update(want, {k: jnp.asarray(p.detach().numpy().copy())
                                     for k, p in model.named_parameters()},
                              0.9)
        for k, v in want.items():
            np.testing.assert_allclose(ema.params[k].numpy(), np.asarray(v),
                                       rtol=0, atol=1e-7, err_msg=k)
    assert max(float((ema.params[k] - p.detach()).abs().max())
               for k, p in model.named_parameters()) > 1e-4

    trainer = ForwardTrainer.__new__(ForwardTrainer)
    trainer.device, trainer.train_cfg, trainer.ema = 'cpu', cfg, ema
    val = [_batch(20), _batch(21)]
    got = trainer.evaluate(model, val)
    by_hand = copy.deepcopy(model)
    by_hand.load_state_dict({**model.state_dict(), **ema.params})
    trainer.ema = None
    want_eval = trainer.evaluate(by_hand, val)
    assert got.keys() == want_eval.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want_eval[k], rtol=1e-6,
                                   err_msg=k)
    assert abs(trainer.evaluate(model, val)['mel_loss']
               - got['mel_loss']) > 1e-6

    # one step against JAX's step with its EMA
    b = _batch(3)
    port_model = _models(NO_DROPOUT)[2]
    port_ema = tc.make_ema(port_model, cfg)
    tc.train_step(port_model, tc.make_optimizer(port_model, lr=LR),
                  _torch_batch(b), torch.Generator().manual_seed(0), cfg,
                  port_ema)
    state = _jax_step(NO_DROPOUT, cfg, b)[3]
    want_ema = _state_dict_of({'params': state.ema_params,
                               'batch_stats': state.batch_stats}, NO_DROPOUT)
    for k, v in port_ema.params.items():
        np.testing.assert_allclose(v.numpy(), want_ema[k].numpy(),
                                   atol=2 * 0.1 * LR + 1e-6, err_msg=k)
