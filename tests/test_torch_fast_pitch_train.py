"""FastPitch through the port's training, GTA and serving entry points on
the CPU at a tiny width, against the JAX package.

- `ForwardTrainer` with `tts_model: fast_pitch` trains a few steps on a
  tiny synthetic dataset (finite losses, every parameter moved, the
  steps that FTT_PROFILE_* name traced into one Chrome trace); its
  `.pt` loads in the JAX package's `load_tts_checkpoint`, where
  `generate` equals the port's at atol 1e-4.
- A JAX `.fjax` FastPitch serves through `gen_forward --device cpu
  griffinlim` and `TTSServer(device='cpu')`: three concurrent requests in
  a padded batch of four (a filler row), each request's mel equal to a
  single-utterance `synthesize` at atol 1e-5 and finite.
- `--force_gta` mels (`create_gta_features`) equal the JAX package's at
  atol 1e-4.
- The bf16 step against JAX's bf16 step in the c-relative form of
  tests/test_torch_train_options.py (C_BF16 = 2 times JAX's own float32
  to bf16 distance, for the clipped gradients and the updates).
- `serve_forward` on a FastPitch `.fjax` builds and warms up the server.
"""
import pickle
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_train_options import BF16_APART, C_BF16, LR, _adam_mu, _rel
from test_torch_train_pipeline import N_MELS, _make_dataset

TINY = {
    'durpred_dropout': 0.0, 'durpred_d_model': 8, 'durpred_n_heads': 2,
    'durpred_layers': 1, 'durpred_d_fft': 8,
    'pitch_dropout': 0.0, 'pitch_d_model': 8, 'pitch_n_heads': 2,
    'pitch_layers': 1, 'pitch_d_fft': 8,
    'energy_dropout': 0.0, 'energy_d_model': 8, 'energy_n_heads': 2,
    'energy_layers': 1, 'energy_d_fft': 8,
    'pitch_strength': 1.0, 'energy_strength': 1.0,
    'd_model': 16, 'conv1_kernel': 9, 'conv2_kernel': 1,
    'prenet_layers': 1, 'prenet_heads': 2, 'prenet_fft': 16,
    'prenet_dropout': 0.0,
    'postnet_layers': 1, 'postnet_heads': 2, 'postnet_fft': 16,
    'postnet_dropout': 0.0,
}
TRAIN_CFG = {'dur_loss_factor': 0.1, 'pitch_loss_factor': 0.1,
             'energy_loss_factor': 0.1, 'pitch_zoneout': 0.0,
             'energy_zoneout': 0.0, 'clip_grad_norm': 0.05}


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _config(data=None, **training):
    from forwardtacotron_tpu_torch.config import default_config
    cfg = default_config()
    cfg['tts_model'] = 'fast_pitch'
    cfg['fast_pitch']['model'] = dict(TINY, prenet_dropout=0.1,
                                      pitch_dropout=0.5)
    cfg['fast_pitch']['training'].update(
        schedule=['1e-3, 5, 2'], checkpoint_every=1000, **training)
    if data is not None:
        cfg['data_path'] = str(data)
    return cfg


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    data = tmp_path_factory.mktemp('fast_pitch') / 'data'
    _make_dataset(data)
    return data


def _num_chars():
    from forwardtacotron_tpu_torch.text.symbols import phonemes
    return len(phonemes)


def test_trainer_trains_fast_pitch_and_jax_loads_it(dataset, tmp_path,
                                                    monkeypatch):
    from forwardtacotron_tpu.utils.checkpoints import load_tts_checkpoint
    from forwardtacotron_tpu_torch.models.fast_pitch import FastPitch
    from forwardtacotron_tpu_torch.train.forward_trainer import (
        ForwardTrainer)
    from forwardtacotron_tpu_torch.utils.checkpoints import (init_tts_model,
                                                             load_checkpoint)
    from forwardtacotron_tpu_torch.utils.paths import Paths
    from forwardtacotron_tpu_torch.utils.profiling import StepTraceController
    cfg = _config(dataset)
    paths = Paths(cfg['data_path'], 'fp', base=tmp_path)
    trainer = ForwardTrainer(paths, cfg, device='cpu')
    assert trainer.train_cfg is cfg['fast_pitch']['training']
    torch.manual_seed(0)
    model = init_tts_model(cfg)
    assert isinstance(model, FastPitch)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    # FTT_PROFILE_DIR: steps 2 and 3 traced (utils/profiling.py)
    for key, value in (('DIR', str(tmp_path / 'trace')), ('START', '1'),
                       ('STEPS', '2')):
        monkeypatch.setenv(f'FTT_PROFILE_{key}', value)
    trainer.tracer = StepTraceController()
    scalars = []
    trainer.writer = types.SimpleNamespace(
        add_scalar=lambda tag, v, step: scalars.append((tag, v)))
    assert trainer.train(model) == 5      # an epoch (4 steps) and one
    losses = [v for tag, v in scalars if 'Loss' in tag]
    assert any(tag.endswith('/val') for tag, _ in scalars)
    assert losses and all(np.isfinite(v) for v in losses)
    for k, p in model.named_parameters():
        assert not torch.equal(p, before[k]), k
    traces = list((tmp_path / 'trace').glob('*.pt.trace.json'))
    assert len(traces) == 1 and trainer.tracer.path == traces[0]
    payload = load_checkpoint(paths.forward_checkpoints / 'latest_model.pt')
    assert payload['step'] == 5 and payload['config']['tts_model'] == \
        'fast_pitch'

    jmodel, variables, jcfg, step = load_tts_checkpoint(
        paths.forward_checkpoints / 'latest_model.pt')
    assert step == 5 and type(jmodel).__name__ == 'FastPitch'
    x = np.zeros((2, 16), np.int64)
    x[0, :11] = np.arange(1, 12)
    x[1, :6] = np.arange(20, 26)
    lens = np.array([11, 6])
    ref = jmodel.apply(variables, jnp.asarray(x), 48, method='generate',
                       x_len=jnp.asarray(lens))
    model.eval()
    out = model.generate(torch.from_numpy(x), 48,
                         x_len=torch.from_numpy(lens))
    np.testing.assert_array_equal(out['mel_len'].numpy(),
                                  np.asarray(ref['mel_len']))
    for i, n in enumerate(out['mel_len'].tolist()):
        np.testing.assert_allclose(out['mel'][i, :n].numpy(),
                                   np.asarray(ref['mel'])[i, :n], atol=1e-4)
    # the option a JAX student trainer lacks is refused by the section's
    # name
    bad = _config(dataset)
    bad['fast_pitch']['training']['precision'] = 'fp8'
    with pytest.raises(ValueError, match='precision'):
        ForwardTrainer(paths, bad, device='cpu')


@pytest.fixture(scope='module')
def jax_fast_pitch():
    """A JAX FastPitch at the tiny width with the config's alphabet and
    80 mels, initialised from a seed: (model, variables as numpy)."""
    from forwardtacotron_tpu.models.fast_pitch import FastPitch as JaxFP
    jmodel = JaxFP(num_chars=_num_chars(), n_mels=N_MELS, **TINY)
    x = jnp.ones((1, 8), jnp.int32)
    variables = jax.jit(lambda k: jmodel.init(
        {'params': k}, x, 32, method='generate', x_len=jnp.asarray([8])))(
            jax.random.PRNGKey(2))
    return jmodel, jax.tree.map(np.asarray, dict(variables))


def test_fjax_serves_through_gen_forward_and_the_server(
        jax_fast_pitch, tmp_path, monkeypatch):
    from scipy.io import wavfile
    from forwardtacotron_tpu_torch import gen_forward
    from forwardtacotron_tpu_torch.serving import TTSServer
    _, variables = jax_fast_pitch
    # durations of about two frames a token: the batch-wide floor (the
    # same in JAX) would make a batch's durations differ from one
    # utterance's where it fires for one of them
    params = dict(variables['params'])
    params['dur_pred'] = dict(params['dur_pred'], lin=dict(
        params['dur_pred']['lin'], bias=np.full((1,), 2.0, np.float32)))
    variables = dict(variables, params=params)
    cfg = _config()
    cfg['fast_pitch']['model'] = dict(TINY)
    path = tmp_path / 'fp.fjax'
    with open(path, 'wb') as f:
        pickle.dump({'model': variables, 'config': cfg, 'step': 5000}, f)
    monkeypatch.chdir(tmp_path)
    text = 'Glue the sheet to the dark blue background.'
    out = gen_forward.main(['--checkpoint', str(path), '--device', 'cpu',
                            '-i', text, 'griffinlim'])
    assert out[0].name == '1_forward_5k_alpha1.0_amp1.0_griffinlim.wav'
    model, _, _ = gen_forward.load_tts(str(path), cfg, 'cpu')
    assert type(model).__name__ == 'FastPitch'
    mel = gen_forward.synthesize(model, gen_forward.text_to_ids(text, cfg))
    assert np.isfinite(mel).all() and mel.shape[0] == N_MELS
    _, wav = wavfile.read(out[0])
    hop = cfg['dsp']['hop_length']
    assert wav.dtype == np.int16 and len(wav) == (mel.shape[1] - 1) * hop

    texts = [text, 'The birch canoe slid on the smooth planks.', 'Hi.']
    mels = []
    with TTSServer(str(path), device='cpu', max_batch=4,
                   max_wait_ms=500.0) as srv:
        assert srv.tts_dtype == torch.float32
        vocode = srv._vocode

        def recording(ms):
            mels.extend(ms)
            return vocode(ms)
        srv._vocode = recording
        futures = [srv.submit(t) for t in texts]
        wavs = [f.result(timeout=300) for f in futures]
    assert list(srv.batch_sizes) == [3]        # one batch, padded to 4
    for t, got, wav in zip(texts, mels, wavs):
        want = gen_forward.synthesize(model, gen_forward.text_to_ids(t, cfg))
        assert np.isfinite(got).all() and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert wav.dtype == np.int16 and len(wav) == \
            (want.shape[1] - 1) * hop


def test_force_gta_matches_jax(jax_fast_pitch, dataset, tmp_path):
    import train_forward as jtf
    from forwardtacotron_tpu.data.dataset import get_tts_datasets as jget
    from forwardtacotron_tpu_torch import train_forward
    from forwardtacotron_tpu_torch.data.dataset import get_tts_datasets
    from forwardtacotron_tpu_torch.models.fast_pitch import FastPitch
    from forwardtacotron_tpu_torch.weights import fast_pitch_state_dict
    jmodel, variables = jax_fast_pitch
    kw = dict(r=1, model_type='forward', filter_attention=False,
              max_mel_len=None)
    (tmp_path / 'jax').mkdir()
    (tmp_path / 'ours').mkdir()
    jtrain, jval = jget(dataset, 4, **kw)
    jtf.create_gta_features(jmodel, types.SimpleNamespace(
        variables=dict(variables, batch_stats={})), jtrain, jval,
        tmp_path / 'jax')
    model = FastPitch(num_chars=_num_chars(), n_mels=N_MELS, **TINY)
    model.load_state_dict(fast_pitch_state_dict(variables, TINY))
    train, val = get_tts_datasets(dataset, 4, **kw)
    n = train_forward.create_gta_features(model, train, val,
                                          tmp_path / 'ours')
    assert n == 10
    for i in range(10):
        got = np.load(tmp_path / 'ours' / f'{i}.npy')
        want = np.load(tmp_path / 'jax' / f'{i}.npy')
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-4, err_msg=str(i))


def _batch(seed=5):
    """Three items of 5-8 tokens and 9-16 frames, padded."""
    rng = np.random.RandomState(seed)
    x_len = np.array([8, 6, 5])
    x = np.zeros((3, 8), np.int64)
    dur = np.zeros((3, 8), np.float32)
    for i, n in enumerate(x_len):
        x[i, :n] = rng.randint(1, _num_chars(), n)
        dur[i, :n] = rng.randint(1, 3, n)
    mel_len = dur.sum(axis=1).astype(np.int64)
    mel = np.full((3, 16, N_MELS), -11.5129, np.float32)
    for i, m in enumerate(mel_len):
        mel[i, :m] = rng.randn(m, N_MELS) * 2 - 5
    return {'x': x, 'x_len': x_len, 'mel': mel, 'mel_len': mel_len,
            'dur': dur, 'pitch': rng.randn(3, 8).astype(np.float32),
            'energy': rng.randn(3, 8).astype(np.float32)}


def _jax_step(jmodel, variables, train_cfg, batch):
    """JAX's `build_forward_train_step` once: (clipped gradients as a port
    state_dict, parameters after)."""
    from forwardtacotron_tpu.train import common as jtc
    from forwardtacotron_tpu_torch.weights import fast_pitch_state_dict
    optimizer = jtc.make_optimizer(train_cfg['clip_grad_norm'], lr=LR)
    params = jax.tree.map(jnp.asarray, variables['params'])
    state = jtc.TrainState(params=params, batch_stats={},
                           opt_state=optimizer.init(params),
                           step=jnp.asarray(0, jnp.int32))
    step = jax.jit(jtc.build_forward_train_step(jmodel, optimizer,
                                                train_cfg))
    jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
          for k, v in batch.items()}
    state, _ = step(state, jb, jax.random.PRNGKey(0))

    def to_sd(tree):
        sd = fast_pitch_state_dict({'params': jax.tree.map(np.asarray,
                                                           tree)}, TINY)
        return {k: v.numpy() for k, v in sd.items()
                if not k.endswith(('pe', 'step'))}
    grads = to_sd(jax.tree.map(lambda m: m / 0.1,
                               _adam_mu(state.opt_state)))
    return grads, to_sd(state.params)


def test_bf16_step_matches_jax_bf16(jax_fast_pitch):
    from forwardtacotron_tpu_torch.models.fast_pitch import FastPitch
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.weights import fast_pitch_state_dict
    jmodel, variables = jax_fast_pitch
    b = _batch()
    bf16 = dict(TRAIN_CFG, precision='bf16')
    ref16 = _jax_step(jmodel, variables, bf16, b)
    ref32 = _jax_step(jmodel, variables, TRAIN_CFG, b)

    def port(train_cfg):
        model = FastPitch(num_chars=_num_chars(), n_mels=N_MELS, **TINY)
        model.load_state_dict(fast_pitch_state_dict(variables, TINY))
        opt = tc.make_optimizer(model, lr=LR)
        metrics = tc.train_step(model, opt, {k: torch.from_numpy(v)
                                             for k, v in b.items()},
                                torch.Generator().manual_seed(0), train_cfg)
        assert np.isfinite(float(metrics['loss']))
        return ({k: p.grad.numpy().copy()
                 for k, p in model.named_parameters()},
                {k: p.detach().numpy().copy()
                 for k, p in model.named_parameters()})
    port16, port32 = port(bf16), port(TRAIN_CFG)
    names = list(port16[0])
    initial = {k: v.numpy() for k, v in
               fast_pitch_state_dict(variables, TINY).items()}

    def updates(after):
        return {k: after[k] - initial[k] for k in names}
    # float32 steps agree, so the bf16 distances are measured from one point
    assert _rel(port32[0], {k: ref32[0][k] for k in names}) < 1e-4
    d_grad = _rel(port16[0], {k: ref16[0][k] for k in names})
    d_grad_ref = _rel({k: ref32[0][k] for k in names},
                      {k: ref16[0][k] for k in names})
    d_up = _rel(updates(port16[1]), updates(ref16[1]))
    d_up_ref = _rel(updates(ref32[1]), updates(ref16[1]))
    print(f'bf16 FastPitch: grads {d_grad:.3g} vs {d_grad_ref:.3g}, '
          f'updates {d_up:.3g} vs {d_up_ref:.3g}')
    assert d_grad_ref > 0 and d_up_ref > 0
    assert d_grad <= C_BF16 * d_grad_ref
    assert d_up <= C_BF16 * d_up_ref
    assert _rel(port16[0], port32[0]) >= BF16_APART * d_grad_ref


def test_serve_forward_builds_fast_pitch(jax_fast_pitch, tmp_path,
                                        monkeypatch):
    """`serve_forward --checkpoint fp.fjax` serves the FastPitch that the
    checkpoint's config names: the server is built on it and warms up
    before the HTTP front would start."""
    from forwardtacotron_tpu_torch import serve_forward, serving
    _, variables = jax_fast_pitch
    cfg = _config()
    cfg['fast_pitch']['model'] = dict(TINY)
    path = tmp_path / 'fp.fjax'
    with open(path, 'wb') as f:
        pickle.dump({'model': variables, 'config': cfg, 'step': 5000}, f)
    seen = {}

    class Stop(Exception):
        pass

    def http(server, host, port):
        seen.update(model=server.model, dtype=server.tts_dtype)
        server.close()
        raise Stop
    monkeypatch.setattr(serving, 'make_http_server', http)
    with pytest.raises(Stop):
        serve_forward.main(['--checkpoint', str(path), '--device', 'cpu',
                            'griffinlim'])
    assert type(seen['model']).__name__ == 'FastPitch'
    assert seen['dtype'] == torch.float32
