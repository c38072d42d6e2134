"""The port's WaveRNN training path on the CPU at a tiny width against the
JAX package, same weights and inputs: the teacher-forced logits in eval
and train mode with the batch-norm statistics they move, RAW and MOL;
the MOL loss; the one-stream GRU against `jax.lax.scan`'s with its
gradients; one full train step (loss, clipped gradients, parameters after
Adam); the vocoder batches; the top-k tracker
(tests/test_torch_voc_train_cli.py holds the trainers and the CLIs).

Tolerances: logits atol 1e-4 (the teacher-forced bar of
docs/benchmarks.md); running statistics atol 1e-5; losses rtol 1e-5;
gradients rtol 5e-4 / atol 5e-5 and parameters after one Adam step as in
tests/test_torch_forward_train.py.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

TINY = dict(rnn_dims=32, fc_dims=32, bits=9, pad=2,
            upsample_factors=(4, 4, 4), feat_dims=20, compute_dims=8,
            res_out_dims=8, res_blocks=2, hop_length=64, sample_rate=8000)
SEQ_LEN, HOP, N_MELS = 256, 64, 20
MEL_WIN = SEQ_LEN // HOP + 2 * TINY['pad']


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain recurrences are loops of small ops: one intra-op thread
    keeps several test workers from slowing each other down."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _randomize_batch_stats(tree, rng):
    return {k: _randomize_batch_stats(v, rng) if isinstance(v, dict) else
            (rng.randn(*v.shape) * 0.1 if k == 'mean'
             else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
            for k, v in tree.items()}


def _inputs(mode, seed, batch=3):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (batch, SEQ_LEN)).astype(np.float32)
    mel = rng.randn(batch, MEL_WIN, N_MELS).astype(np.float32)
    if mode == 'RAW':
        y = rng.randint(0, 2 ** TINY['bits'], (batch, SEQ_LEN))
    else:
        y = rng.uniform(-1, 1, (batch, SEQ_LEN)).astype(np.float32)
        y[0, :4] = [-1.0, 1.0, 0.9995, -0.9995]         # the CDF's ends
    return x, mel, y


@functools.lru_cache(maxsize=2)
def _variables(mode):
    from forwardtacotron_tpu.models.wavernn import WaveRNN as JaxWaveRNN
    x, mel, _ = _inputs(mode, 0)
    variables = jax.jit(JaxWaveRNN(mode=mode, **TINY).init)(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mel))
    return {'params': jax.tree.map(np.asarray, variables['params']),
            'batch_stats': _randomize_batch_stats(
                variables['batch_stats'], np.random.RandomState(7))}


def _state_dict(variables, mode):
    from forwardtacotron_tpu_torch.weights import wavernn_state_dict
    return wavernn_state_dict(jax.tree.map(np.asarray, variables),
                              dict(TINY, mode=mode))


def _models(mode):
    from forwardtacotron_tpu.models.wavernn import WaveRNN as JaxWaveRNN
    from forwardtacotron_tpu_torch.models.wavernn import WaveRNN
    variables = _variables(mode)
    tmodel = WaveRNN(mode=mode, **TINY)
    tmodel.load_state_dict(_state_dict(variables, mode), strict=True)
    return JaxWaveRNN(mode=mode, **TINY), variables, tmodel


@pytest.mark.parametrize('mode', ['RAW', 'MOL'])
def test_teacher_forced_logits_and_bn_stats_match_jax(mode):
    jmodel, variables, tmodel = _models(mode)
    x, mel, _ = _inputs(mode, 1)
    ref = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False))(
        variables, jnp.asarray(x), jnp.asarray(mel))
    with torch.no_grad():
        out = tmodel.eval()(torch.from_numpy(x), torch.from_numpy(mel))
    assert out.shape == (3, SEQ_LEN, tmodel.n_classes)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)

    ref, mutated = jax.jit(lambda v, a, b: jmodel.apply(
        v, a, b, train=True, mutable=['batch_stats']))(
            variables, jnp.asarray(x), jnp.asarray(mel))
    out = tmodel.train()(torch.from_numpy(x), torch.from_numpy(mel))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-4)
    want = _state_dict({'params': variables['params'],
                        'batch_stats': mutated['batch_stats']}, mode)
    got = tmodel.state_dict()
    stats = [k for k in want if k.endswith(('running_mean', 'running_var'))]
    assert len(stats) == 2 * (1 + 2 * TINY['res_blocks'])
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=1e-5, err_msg=k)


def test_mol_loss_matches_jax():
    from forwardtacotron_tpu.ops.mol import (
        discretized_mix_logistic_loss as jloss)
    from forwardtacotron_tpu_torch.ops.mol import (
        discretized_mix_logistic_loss)
    rng = np.random.RandomState(3)
    y_hat = (rng.randn(2, 50, 30) * 2).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 50)).astype(np.float32)
    y[0, :3] = [-1.0, 1.0, 0.0]
    y_hat[1, :5, 20:] = -40.0              # log scales at the clip
    ref, ref_grad = jax.value_and_grad(jloss)(jnp.asarray(y_hat),
                                              jnp.asarray(y))
    yt = torch.tensor(y_hat, requires_grad=True)
    out = discretized_mix_logistic_loss(yt, torch.from_numpy(y))
    out.backward()
    np.testing.assert_allclose(float(out.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(ref_grad),
                               rtol=5e-4, atol=5e-5)
    per_sample = discretized_mix_logistic_loss(
        yt.detach(), torch.from_numpy(y), reduce=False)
    np.testing.assert_allclose(
        per_sample.numpy(),
        np.asarray(jloss(jnp.asarray(y_hat), jnp.asarray(y), reduce=False)),
        rtol=1e-5, atol=1e-6)


def test_one_stream_gru_matches_lax_scan():
    """`ops/rnn.py:gru` (one stream of the BiRNN kernels' plain versions,
    under autograd `BiRNNTrain`) against the JAX package's scan GRU:
    outputs and the gradients of x and of every weight."""
    from forwardtacotron_tpu.ops import rnn as jrnn
    from forwardtacotron_tpu_torch.ops import rnn as trnn
    rng = np.random.RandomState(4)
    B, T, D, H = 3, 40, 10, 16
    params = {'w_ih': rng.uniform(-.25, .25, (3 * H, D)),
              'w_hh': rng.uniform(-.25, .25, (3 * H, H)),
              'b_ih': rng.uniform(-.25, .25, (3 * H,)),
              'b_hh': rng.uniform(-.25, .25, (3 * H,))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.randn(B, T, D).astype(np.float32)
    w = rng.randn(B, T, H).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jrnn.gru(p, xx) * w)
    ref = jrnn.gru(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    gp, gx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xt = torch.tensor(x, requires_grad=True)
    with torch.no_grad():
        np.testing.assert_allclose(trnn.gru(tp, xt).numpy(), np.asarray(ref),
                                   atol=1e-5)
    y = trnn.gru(tp, xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    torch.sum(y * torch.from_numpy(w)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=5e-4,
                               atol=5e-5)
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(gp[k]),
                                   rtol=5e-4, atol=5e-5, err_msg=k)


def _adam_mu(state):
    if hasattr(state, 'mu'):
        return state.mu
    if isinstance(state, tuple):
        for s in state:
            mu = _adam_mu(s)
            if mu is not None:
                return mu
    return None


@pytest.mark.parametrize('mode', ['RAW', 'MOL'])
def test_voc_train_step_matches_jax(mode):
    """One step with a clip that engages against the JAX package's
    `build_voc_train_step` (optax's clip_by_global_norm + adam, whose first
    moment after one step is 0.1 * the clipped gradient)."""
    from forwardtacotron_tpu.train import common as jtc
    from forwardtacotron_tpu.train.voc_trainer import build_voc_train_step
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.voc_trainer import voc_train_step
    jmodel, variables, tmodel = _models(mode)
    x, mel, y = _inputs(mode, 2)
    lr, clip = 1e-3, 0.05
    optimizer = jtc.make_optimizer(clip, lr=lr)
    state = jtc.TrainState(params=variables['params'],
                           batch_stats=variables['batch_stats'],
                           opt_state=optimizer.init(variables['params']),
                           step=jnp.asarray(0, jnp.int32))
    step = build_voc_train_step(jmodel, optimizer, mode)
    new_state, ref = step(state, {'x': jnp.asarray(x),
                                  'mel': jnp.asarray(mel),
                                  'y': jnp.asarray(y)})
    topt = tc.make_optimizer(tmodel, lr=lr)
    metrics = voc_train_step(tmodel, topt, {
        'x': torch.from_numpy(x), 'mel': torch.from_numpy(mel),
        'y': torch.from_numpy(y)}, mode, clip)
    np.testing.assert_allclose(float(metrics['loss']), float(ref['loss']),
                               rtol=1e-5)
    assert float(metrics['grad_norm']) > clip

    clipped = jax.tree.map(lambda m: np.asarray(m) / 0.1,
                           _adam_mu(new_state.opt_state))
    want_grads = _state_dict({'params': clipped,
                              'batch_stats': variables['batch_stats']}, mode)
    want_params = _state_dict(new_state.variables, mode)
    got_params = tmodel.state_dict()
    named = dict(tmodel.named_parameters())
    assert len(named) > 30
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


# ----------------------------------------------------------- data and files

def _make_voc_dataset(data, mode='RAW', n_items=8, n_val=2, seed=0):
    """Items of 20-40 mel frames with quant labels of frames * HOP samples
    (RAW 9-bit or MOL 16-bit), plus the student's durations, pitch and
    energy and the text, so the same dataset trains both."""
    from forwardtacotron_tpu_torch.utils.files import pickle_binary
    rng = np.random.RandomState(seed)
    for d in ('mel', 'quant', 'alg', 'phon_pitch', 'phon_energy'):
        (data / d).mkdir(parents=True, exist_ok=True)
    bits = 16 if mode == 'MOL' else TINY['bits']
    index, text_dict, att = [], {}, {}
    for i in range(n_items):
        x_len = int(rng.randint(6, 11))
        dur = rng.multinomial(int(rng.randint(20, 41)) - x_len,
                              np.full(x_len, 1.0 / x_len)) + 1
        frames = int(dur.sum())
        np.save(data / 'mel' / f'{i}.npy',
                (rng.randn(N_MELS, frames) - 3).astype(np.float32))
        np.save(data / 'quant' / f'{i}.npy',
                rng.randint(0, 2 ** bits, frames * HOP).astype(np.int64))
        np.save(data / 'alg' / f'{i}.npy', dur.astype(np.int32))
        np.save(data / 'phon_pitch' / f'{i}.npy',
                rng.randn(x_len).astype(np.float32))
        np.save(data / 'phon_energy' / f'{i}.npy',
                rng.randn(x_len).astype(np.float32))
        text_dict[str(i)] = 'ðɛɹ wʌz ə kæt'[:x_len]
        index.append((str(i), frames))
        att[str(i)] = (1.0, 1.0)
    pickle_binary(text_dict, data / 'text_dict.pkl')
    pickle_binary(index[:-n_val], data / 'train_dataset.pkl')
    pickle_binary(index[-n_val:], data / 'val_dataset.pkl')
    pickle_binary(att, data / 'att_score_dict.pkl')
    return data


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize('mode', ['RAW', 'MOL'])
def test_voc_batches_equal_jax(tmp_path, mode):
    """The same files, seed and epochs give the JAX package's crops, crop
    for crop: the train batcher from an epoch's start and mid-epoch (the
    per-batch reseeding), the fixed-seed val batches and the samples."""
    from forwardtacotron_tpu.data import dataset as jds
    from forwardtacotron_tpu_torch.data import dataset as tds
    data = _make_voc_dataset(tmp_path / 'data', mode, n_items=12, n_val=4)
    kw = dict(path=data, batch_size=2, train_gta=False, max_mel_len=38,
              hop_length=HOP, voc_pad=TINY['pad'], voc_seq_len=SEQ_LEN,
              voc_mode=mode, bits=TINY['bits'], num_gen_samples=2)
    (train, val, samples) = tds.get_vocoder_datasets(**kw)
    (jtrain, jval, jsamples) = jds.get_vocoder_datasets(**kw)
    assert len(train) == len(jtrain) > 1
    for epoch, start in ((0, 0), (1, 1), (2, 0)):
        assert train.epoch_plan(epoch) == jtrain.epoch_plan(epoch)
        _assert_batches_equal(list(train.batches(epoch, start)),
                              list(jtrain.batches(epoch, start)))
    _assert_batches_equal(val, jval)
    assert [s['item_id'] for s in samples] == \
        [s['item_id'] for s in jsamples]


def test_top_k_tracker_matches_jax(tmp_path):
    """Keep, prune, index and resume: the port's tracker and the JAX
    package's, offered the same scores and steps (a replayed step among
    them), keep the same entries and files; a new tracker resumes from
    the index."""
    from forwardtacotron_tpu.train.common import TopKTracker as JTopK
    from forwardtacotron_tpu_torch.train.common import TopKTracker
    from forwardtacotron_tpu_torch.utils.files import unpickle_binary
    ours_dir, jax_dir = tmp_path / 'ours', tmp_path / 'jax'
    ours_dir.mkdir()
    jax_dir.mkdir()
    offers = [(0.5, 10), (0.3, 20), (0.7, 30), (0.3, 20), (0.2, 40),
              (0.9, 50), (0.25, 60)]

    def run(offers, ours_k, jax_k):
        kept = []
        for score, step in offers:
            kept.append((ours_k.update(score, step, lambda p, on_disk: (
                p.write_bytes(b'x'), on_disk())),
                         jax_k.update(score, {'params': {}}, {}, None,
                                      step)))
        return kept

    kept = run(offers[:4], TopKTracker(ours_dir, 3, 'forward'),
               JTopK(jax_dir, 3, 'forward'))
    # a resumed run reads the index and continues the leaderboard
    kept += run(offers[4:], TopKTracker(ours_dir, 3, 'forward'),
                JTopK(jax_dir, 3, 'forward'))
    assert [a for a, _ in kept] == [b for _, b in kept]

    def stems(entries):
        return [(s, st, n.rsplit('.', 1)[0]) for s, st, n in entries]
    ours = unpickle_binary(ours_dir / 'top_k.pkl')
    theirs = unpickle_binary(jax_dir / 'top_k.pkl')
    assert stems(ours) == stems(theirs)
    assert [e[1] for e in ours] == [40, 60, 20]
    assert sorted(p.name for p in ours_dir.glob('*.pt')) == \
        sorted(e[2] for e in ours)
    assert sorted(p.stem for p in jax_dir.glob('*.fjax')) == \
        sorted(p.stem for p in ours_dir.glob('*.pt'))
    assert not TopKTracker(ours_dir, 0, 'forward').update(
        0.0, 70, lambda p, on_disk: pytest.fail('k = 0 saves nothing'))


# ----------------------------------------------------- the student's files
