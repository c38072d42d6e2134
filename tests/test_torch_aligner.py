"""The port's teacher-free aligner on the CPU against the JAX package.

The same weights (through `aligner_state_dict`) and seeded inputs with
ragged `x_len` / `mel_len`: the log attention at atol 1e-5; the
forward-sum loss and its gradient (in the log attention and in every
parameter) against `jax.grad` at atol 1e-5; the Viterbi durations equal
to JAX's as integers on random and on planted paths, each summing to its
mel_len. Then the port alone: the loss against a brute-force sum over
every monotonic path, a learned synthetic alignment, and
`train_aligner` end to end on a synthetic corpus (seeded from a JAX
`.fjax`, trained, resumed, `--force_align`) followed by two steps of
`train_forward` on what it wrote.
"""
import functools
import itertools
import wave

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

CFG = dict(vocab_size=12, n_mels=8, embed_dims=16, conv_dims=16,
           key_dims=8, n_text_convs=2, n_mel_convs=1, dropout=0.1,
           prior_width=4.0)
X_LEN = np.array([9, 5, 3, 7])
MEL_LEN = np.array([30, 17, 9, 24])


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """The dynamic programs are loops of small ops: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = np.zeros((4, 9), np.int64)
    for b, n in enumerate(X_LEN):
        x[b, :n] = rng.randint(1, CFG['vocab_size'], n)
    mel = rng.randn(4, 30, CFG['n_mels']).astype(np.float32)
    return x, mel


@functools.lru_cache(maxsize=1)
def _models():
    """(JAX model, numpy variables with non-trivial layer norms, the port's
    model loaded strictly from them)."""
    from forwardtacotron_tpu.align.aligner import Aligner as JaxAligner
    from forwardtacotron_tpu_torch.align.aligner import Aligner
    from forwardtacotron_tpu_torch.weights import aligner_state_dict
    jmodel = JaxAligner(**CFG)
    x, mel = _inputs()
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(mel), jnp.asarray(X_LEN),
                            jnp.asarray(MEL_LEN))
    rng = np.random.RandomState(3)

    def fill(tree, name=''):
        return {k: fill(v, k) if isinstance(v, dict) else
                (rng.uniform(0.5, 1.5, v.shape) if k == 'scale' else
                 rng.randn(*v.shape) * 0.1 if name.startswith('LayerNorm')
                 else np.asarray(v)).astype(np.float32)
                for k, v in tree.items()}
    variables = {'params': fill(variables['params'])}
    model = Aligner(**CFG)
    model.load_state_dict(aligner_state_dict(variables, step=5), strict=True)
    return jmodel, variables, model.eval()


def _jax_log_att(logits, x_len):
    n_mask = jnp.arange(logits.shape[2])[None, None, :] \
        < jnp.asarray(x_len)[:, None, None]
    return jax.nn.log_softmax(jnp.where(n_mask, jnp.asarray(logits), -1e9),
                              axis=-1)


def test_log_att_matches_jax():
    jmodel, variables, model = _models()
    x, mel = _inputs(1)
    ref = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(mel),
                       jnp.asarray(X_LEN), jnp.asarray(MEL_LEN))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(mel),
                    torch.from_numpy(X_LEN))
    valid = np.arange(9)[None, None, :] < X_LEN[:, None, None]
    np.testing.assert_allclose(np.where(valid, out.numpy(), 0),
                               np.where(valid, np.asarray(ref), 0),
                               atol=1e-5)
    assert (out.numpy()[~np.broadcast_to(valid, out.shape)] < -1e8).all()
    assert int(model.step) == 5


def test_forward_sum_loss_and_gradients_match_jax():
    from forwardtacotron_tpu.align.aligner import (
        forward_sum_loss as jax_loss)
    from forwardtacotron_tpu_torch.align.aligner import forward_sum_loss
    rng = np.random.RandomState(2)
    logits = rng.randn(4, 30, 9).astype(np.float32) * 2
    la_j = _jax_log_att(logits, X_LEN)
    loss_j, grad_j = jax.value_and_grad(
        lambda la: jax_loss(la, jnp.asarray(X_LEN), jnp.asarray(MEL_LEN)))(
            la_j)
    la = torch.tensor(np.asarray(la_j), requires_grad=True)
    loss = forward_sum_loss(la, torch.from_numpy(X_LEN),
                            torch.from_numpy(MEL_LEN))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), atol=1e-5)
    np.testing.assert_allclose(la.grad.numpy(), np.asarray(grad_j),
                               atol=1e-5)
    # frames at or past mel_len take no gradient
    past = np.arange(30)[None, :] >= MEL_LEN[:, None]
    assert np.abs(la.grad.numpy()[past]).max() == 0

    # through the whole model, every parameter
    jmodel, variables, model = _models()
    x, mel = _inputs(4)

    def jloss(params):
        return jax_loss(jmodel.apply({'params': params}, jnp.asarray(x),
                                     jnp.asarray(mel), jnp.asarray(X_LEN),
                                     jnp.asarray(MEL_LEN)),
                        jnp.asarray(X_LEN), jnp.asarray(MEL_LEN))
    loss_j, grads_j = jax.value_and_grad(jloss)(variables['params'])
    from forwardtacotron_tpu_torch.weights import aligner_state_dict
    model.zero_grad()
    loss = forward_sum_loss(model(torch.from_numpy(x), torch.from_numpy(mel),
                                  torch.from_numpy(X_LEN)),
                            torch.from_numpy(X_LEN),
                            torch.from_numpy(MEL_LEN))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               atol=1e-5)
    want = aligner_state_dict({'params': jax.tree.map(np.asarray,
                                                      grads_j)})
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=name)


def _monotonic_paths(T, N):
    for steps in itertools.product([0, 1], repeat=T - 1):
        path = np.cumsum((0,) + steps)
        if path[-1] == N - 1:
            yield path


def test_forward_sum_matches_brute_force():
    from forwardtacotron_tpu_torch.align.aligner import forward_sum_loss
    rng = np.random.RandomState(0)
    T, N = 6, 3
    la = torch.log_softmax(torch.from_numpy(rng.randn(1, T, N)
                                            .astype(np.float32)), -1)
    loss = forward_sum_loss(la, torch.tensor([N]), torch.tensor([T]))
    a = la[0].numpy()
    scores = [sum(a[t, n] for t, n in enumerate(p))
              for p in _monotonic_paths(T, N)]
    np.testing.assert_allclose(float(loss), -np.logaddexp.reduce(scores) / T,
                               rtol=1e-5)


def test_viterbi_matches_jax_random_and_planted():
    from forwardtacotron_tpu.align.aligner import (
        viterbi_durations as jax_viterbi)
    from forwardtacotron_tpu_torch.align.aligner import viterbi_durations
    rng = np.random.RandomState(3)
    for trial in range(3):
        logits = rng.randn(4, 30, 9).astype(np.float32) * (1 + trial)
        la = _jax_log_att(logits, X_LEN)
        want = np.asarray(jax_viterbi(la, jnp.asarray(X_LEN),
                                      jnp.asarray(MEL_LEN)))
        got = viterbi_durations(torch.tensor(np.asarray(la)),
                                torch.from_numpy(X_LEN),
                                torch.from_numpy(MEL_LEN)).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got.sum(1), MEL_LEN)
        assert all(got[b, X_LEN[b]:].sum() == 0 for b in range(4))
    true = np.array([[4, 6, 5, 5, 4], [10, 2, 8, 2, 2], [1, 1, 1, 1, 20]])
    logits = rng.randn(3, 24, 5).astype(np.float32) * 0.1
    for b in range(3):
        frames = np.repeat(np.arange(5), true[b])
        logits[b, np.arange(24), frames] += 8.0
    la = torch.log_softmax(torch.from_numpy(logits), -1)
    got = viterbi_durations(la, torch.tensor([5] * 3),
                            torch.tensor([24] * 3)).numpy()
    np.testing.assert_array_equal(got, true)
    np.testing.assert_array_equal(
        got, np.asarray(jax_viterbi(jnp.asarray(la.numpy()),
                                    jnp.asarray([5] * 3),
                                    jnp.asarray([24] * 3))))


def _synthetic_batch(rng, B, N, T, M, vocab, sig):
    """mel frames are their phoneme's signature vector plus noise, so the
    true alignment is known (the JAX package's test_aligner.py)."""
    x = rng.randint(1, vocab, (B, N))
    durs = rng.randint(2, 7, (B, N))
    for b in range(B):
        durs[b, -1] += T - durs[b].sum()
        while durs[b, -1] <= 0:
            durs[b, np.argmax(durs[b, :-1])] -= 1
            durs[b, -1] += 1
    mel = np.stack([sig[np.repeat(x[b], durs[b])] for b in range(B)])
    mel = mel + rng.randn(B, T, M) * 0.1
    return x, mel.astype(np.float32), durs


def test_aligner_learns_synthetic_alignment():
    """Fresh batches of one phoneme inventory each step; the held-out
    alignment within one frame almost everywhere."""
    from forwardtacotron_tpu_torch.align.aligner import (
        Aligner, align_extract, forward_sum_loss)
    rng = np.random.RandomState(0)
    B, N, T, M, vocab = 16, 6, 30, 16, 12
    sig = rng.randn(vocab, M).astype(np.float32)
    x_len, mel_len = torch.full((B,), N), torch.full((B,), T)
    torch.manual_seed(0)
    model = Aligner(vocab_size=vocab, n_mels=M, embed_dims=32,
                    conv_dims=32, key_dims=16, n_text_convs=2,
                    n_mel_convs=1, dropout=0.0, prior_width=6.0).train()
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    first = None
    for _ in range(150):
        x, mel, _ = _synthetic_batch(rng, B, N, T, M, vocab, sig)
        loss = forward_sum_loss(model(torch.from_numpy(x),
                                      torch.from_numpy(mel), x_len),
                                x_len, mel_len)
        opt.zero_grad()
        loss.backward()
        opt.step()
        first = float(loss) if first is None else first
    assert float(loss) < first
    x, mel, true = _synthetic_batch(np.random.RandomState(123), B, N, T, M,
                                    vocab, sig)
    durs, att = align_extract(model, torch.from_numpy(x),
                              torch.from_numpy(mel), x_len, mel_len)
    assert model.training and att.shape == (B, T, N)
    durs = durs.numpy()
    assert (durs.sum(1) == T).all()

    def frames(d):
        return np.repeat(np.arange(len(d)), d)
    tol1 = np.mean([(np.abs(frames(durs[b]) - frames(true[b])) <= 1).mean()
                    for b in range(B)])
    assert tol1 > 0.9, tol1


def _write_corpus(root, n=6):
    """Harmonic wavs of 0.3-0.5 s with silence at both ends and an
    LJSpeech-layout metadata.csv."""
    texts = ['Printing, in the only sense.', 'The cat sat on the mat.',
             'She sells sea shells.', 'One two three four five.',
             'A quick brown fox.', 'Hello there, general.']
    rng = np.random.RandomState(0)
    (root / 'wavs').mkdir(parents=True)
    lines = []
    for i in range(n):
        m = int(22050 * rng.uniform(0.3, 0.5))
        f0 = 120 + 40 * np.sin(2 * np.pi * 1.5 * np.arange(m) / 22050)
        phase = 2 * np.pi * np.cumsum(f0) / 22050
        y = sum(0.3 / k * np.sin(k * phase) for k in range(1, 6))
        y = np.concatenate([np.zeros(2000), y, np.zeros(2000)])
        with wave.open(str(root / 'wavs' / f'a{i}.wav'), 'wb') as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(22050)
            w.writeframes(np.round(y * 32767).astype('<i2').tobytes())
        lines.append(f'a{i}|{texts[i]}|{texts[i]}')
    (root / 'metadata.csv').write_text('\n'.join(lines) + '\n')


def test_train_aligner_then_train_forward(tmp_path, monkeypatch):
    import yaml
    from forwardtacotron_tpu_torch import (preprocess, train_aligner,
                                           train_forward)
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.utils.checkpoints import load_checkpoint
    from forwardtacotron_tpu_torch.utils.files import unpickle_binary
    from forwardtacotron_tpu_torch.utils.paths import Paths
    monkeypatch.setenv('FTT_BASE', str(tmp_path))
    _write_corpus(tmp_path / 'corpus')
    cfg = default_config()
    cfg['data_path'] = str(tmp_path / 'data')
    cfg['preprocessing']['n_val'] = 2
    cfg['aligner'] = {
        'model': {'embed_dims': 16, 'conv_dims': 16, 'key_dims': 8,
                  'n_text_convs': 1, 'n_mel_convs': 1, 'dropout': 0.1,
                  'prior_width': 10.0},
        'training': {'schedule': ['1e-3, 2, 2'], 'max_mel_len': 1250,
                     'clip_grad_norm': 1.0, 'checkpoint_every': 2}}
    cfg['forward_tacotron']['model'].update(
        embed_dims=16, series_embed_dims=8, durpred_conv_dims=8,
        durpred_rnn_dims=4, pitch_conv_dims=8, pitch_rnn_dims=4,
        energy_conv_dims=8, energy_rnn_dims=4, rnn_dims=12, prenet_dims=8,
        prenet_k=2, prenet_num_highways=1, postnet_dims=8, postnet_k=2,
        postnet_num_highways=1)
    cfg['forward_tacotron']['training'].update(schedule=['1e-3, 2, 2'],
                                               filter_attention=False)
    path = tmp_path / 'config.yaml'
    path.write_text(yaml.safe_dump(cfg))
    cli = ['--config', str(path), '--device', 'cpu']
    train, val = preprocess.main(['--path', str(tmp_path / 'corpus')] + cli)
    paths = Paths(cfg['data_path'], cfg['tts_model_id'])
    items = dict(train + val)

    with pytest.raises(SystemExit):
        train_aligner.main(cli + ['--force_align'])     # nothing trained
    # a JAX checkpoint in the directory seeds the weights and the step
    from forwardtacotron_tpu.align.aligner import (
        aligner_from_config as jax_aligner)
    from forwardtacotron_tpu.utils.checkpoints import save_checkpoint
    variables = jax_aligner(cfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 5), jnp.int32),
        jnp.zeros((1, 7, 80)), jnp.asarray([5]), jnp.asarray([7]))
    save_checkpoint(variables, cfg,
                    paths.aligner_checkpoints / 'latest_model.fjax', step=1)
    assert train_aligner.main(cli + ['--force_align']) == 1
    assert train_aligner.main(cli) == 2
    ckpt = load_checkpoint(paths.aligner_checkpoints / 'latest_model.pt')
    assert ckpt['step'] == 2 and ckpt['optim'] is not None
    # a longer schedule resumes from the checkpoint's step
    cfg['aligner']['training']['schedule'] = ['1e-3, 4, 2']
    path.write_text(yaml.safe_dump(cfg))
    assert train_aligner.main(cli) == 4
    trained = load_checkpoint(paths.aligner_checkpoints / 'latest_model.pt')
    assert trained['step'] == 4 and not all(
        torch.equal(trained['model'][k], ckpt['model'][k])
        for k in ckpt['model'] if k != 'step')
    scores = unpickle_binary(paths.data / 'att_score_dict.pkl')
    assert set(scores) == set(items)
    first = {}
    for item, frames in items.items():
        dur = np.load(paths.alg / f'{item}.npy')
        assert dur.dtype == np.int32 and dur.sum() == frames
        assert (dur >= 0).all()
        pitch = np.load(paths.phon_pitch / f'{item}.npy')
        energy = np.load(paths.phon_energy / f'{item}.npy')
        assert pitch.shape == energy.shape == dur.shape
        assert np.isfinite(pitch).all() and np.isfinite(energy).all()
        first[item] = dur
    assert train_aligner.main(cli + ['--force_align']) == 4
    for item, dur in first.items():
        np.testing.assert_array_equal(np.load(paths.alg / f'{item}.npy'),
                                      dur)
    assert train_forward.main(cli) == 2
    assert load_checkpoint(paths.forward_checkpoints
                           / 'latest_model.pt')['step'] == 2
