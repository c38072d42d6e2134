"""Multi-speaker ForwardTacotron in the port on the CPU, against the JAX
package with the same weights and seeded inputs, and the multi-speaker
entry points.

Four speakers, and each predictor's own `spk_proj` (random from JAX's
init, so the three differ). Tolerances: the teacher-forced forward at
atol 1e-4; the series (the port's fused 6-stream path against JAX's
three separate predictors) at atol 1e-5; padded-bucket `generate` with a
mel mean absolute error below 1e-3 and an equal `mel_len`. A batch of
mixed speakers equals each row run alone at atol 1e-5; `n_speakers: 1`
adds no key to any model; `gen_forward --speaker` is range-checked and a
multi-speaker `.fjax` and `.pt` both serve; `TTSServer` answers mixed
voices in one batch, each mel equal to its solo answer's at atol 1e-5.
FastPitch and the teacher: tests/test_torch_multispeaker_models.py; the
data path and the trainers: tests/test_torch_multispeaker_data.py.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from forwardtacotron_tpu_torch.text.symbols import phonemes

FT_TINY = {
    'embed_dims': 16, 'series_embed_dims': 8,
    'durpred_conv_dims': 8, 'durpred_rnn_dims': 4, 'durpred_dropout': 0.5,
    'pitch_conv_dims': 8, 'pitch_rnn_dims': 6, 'pitch_dropout': 0.5,
    'pitch_strength': 1.0,
    'energy_conv_dims': 8, 'energy_rnn_dims': 3, 'energy_dropout': 0.5,
    'energy_strength': 0.7,
    'rnn_dims': 12, 'prenet_dims': 8, 'prenet_k': 2, 'prenet_dropout': 0.5,
    'prenet_num_highways': 1, 'postnet_dims': 8, 'postnet_k': 2,
    'postnet_num_highways': 1, 'postnet_dropout': 0.0,
    'n_speakers': 4, 'speaker_embed_dims': 5,
}
FP_TINY = {
    'durpred_dropout': 0.5, 'durpred_d_model': 8, 'durpred_n_heads': 2,
    'durpred_layers': 1, 'durpred_d_fft': 8,
    'pitch_dropout': 0.5, 'pitch_d_model': 8, 'pitch_n_heads': 2,
    'pitch_layers': 1, 'pitch_d_fft': 8,
    'energy_dropout': 0.5, 'energy_d_model': 8, 'energy_n_heads': 2,
    'energy_layers': 1, 'energy_d_fft': 8,
    'pitch_strength': 1.0, 'energy_strength': 1.0,
    'd_model': 16, 'conv1_kernel': 9, 'conv2_kernel': 1,
    'prenet_layers': 1, 'prenet_heads': 2, 'prenet_fft': 16,
    'prenet_dropout': 0.1, 'postnet_layers': 1, 'postnet_heads': 2,
    'postnet_fft': 16, 'postnet_dropout': 0.1,
    'n_speakers': 3, 'speaker_embed_dims': 6,
}
TACO_TINY = {'embed_dims': 16, 'encoder_dims': 128, 'decoder_dims': 256,
             'postnet_dims': 8, 'encoder_k': 2, 'lstm_dims': 16,
             'postnet_k': 2, 'num_highways': 1, 'dropout': 0.5,
             'stop_threshold': -1e9, 'n_speakers': 3,
             'speaker_embed_dims': 7}
# the phoneme table's size, so that the ForwardTacotron weights also
# serve as a `.fjax` of `from_config` (the `ms_fjax` fixture)
NUM_CHARS, N_MELS = len(phonemes), 6
SPK = np.array([3, 1, 2], np.int64)
F32 = torch.float32


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """Small ops in loops: one intra-op thread runs them faster under the
    suite's workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _text(lens=(10, 7, 4), tx=10, seed=0):
    rng = np.random.RandomState(seed)
    x = np.zeros((len(lens), tx), np.int64)
    for i, n in enumerate(lens):
        x[i, :n] = rng.randint(1, NUM_CHARS, n)
    return x, np.asarray(lens, np.int64)


def _train_batch(seed=1):
    """Three items, durations summing to 12, 9 and 6 frames of a 14-frame
    mel, with speakers SPK."""
    rng = np.random.RandomState(seed)
    x, x_len = _text(seed=seed)
    dur = np.zeros(x.shape, np.float32)
    for i, n in enumerate(x_len):
        dur[i, :n] = rng.randint(0, 3, n)
        dur[i, 0] += [12, 9, 6][i] - dur[i].sum()
    return {'x': x, 'x_len': x_len,
            'mel': (rng.randn(3, 14, N_MELS) * 2 - 5).astype(np.float32),
            'mel_len': dur.sum(1).astype(np.int64), 'dur': dur,
            'pitch': rng.randn(*x.shape).astype(np.float32),
            'energy': rng.randn(*x.shape).astype(np.float32),
            'speaker': SPK}


def _j(b):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in b.items()}


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _random_stats(tree, rng):
    return {k: _random_stats(v, rng) if isinstance(v, dict) else
            (rng.randn(*v.shape) * 0.1 if k == 'mean'
             else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
            for k, v in tree.items()}


# ------------------------------------------------------ ForwardTacotron

@functools.lru_cache(maxsize=None)
def _ft(n_speakers=4):
    """(JAX model, numpy variables with random BN statistics, port model
    loaded strictly from them)."""
    from forwardtacotron_tpu.models.forward_tacotron import (
        ForwardTacotron as JaxFT)
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.weights import forward_tacotron_state_dict
    cfg = dict(FT_TINY, n_speakers=n_speakers)
    jmodel = JaxFT(num_chars=NUM_CHARS, n_mels=N_MELS, **cfg)
    variables = jax.jit(lambda k: jmodel.init(
        {'params': k}, _j(_train_batch())))(jax.random.PRNGKey(0))
    variables = {'params': jax.tree.map(np.asarray, variables['params']),
                 'batch_stats': _random_stats(variables['batch_stats'],
                                              np.random.RandomState(5))}
    tmodel = ForwardTacotron(num_chars=NUM_CHARS, n_mels=N_MELS, **cfg)
    tmodel.load_state_dict(forward_tacotron_state_dict(variables, cfg),
                           strict=True)
    return jmodel, variables, tmodel.eval()


def test_speaker_keys_and_single_speaker_adds_none():
    """The multi-speaker keys are named after the port's modules, and
    `n_speakers: 1` gives exactly the single-speaker key set."""
    from forwardtacotron_tpu_torch.models.fast_pitch import FastPitch
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.models.tacotron import Tacotron
    ft = ForwardTacotron(num_chars=NUM_CHARS, n_mels=N_MELS, **FT_TINY)
    keys = {k for k in ft.state_dict() if 'spk' in k or 'speaker' in k}
    assert keys == {'speaker_embedding.weight', 'speaker_proj.weight',
                    'dur_pred.spk_proj.weight', 'pitch_pred.spk_proj.weight',
                    'energy_pred.spk_proj.weight'}
    assert ft.speaker_proj.weight.shape == (2 * FT_TINY['prenet_dims'], 5)
    assert ft.pitch_pred.spk_proj.weight.shape == (8, 5)
    for build, cfg in ((ForwardTacotron, FT_TINY), (FastPitch, FP_TINY),
                       (Tacotron, TACO_TINY)):
        one = build(num_chars=NUM_CHARS, n_mels=N_MELS,
                    **dict(cfg, n_speakers=1))
        plain = {k: v for k, v in cfg.items()
                 if k not in ('n_speakers', 'speaker_embed_dims')}
        assert set(one.state_dict()) == set(build(
            num_chars=NUM_CHARS, n_mels=N_MELS, **plain).state_dict())
        assert not any('spk' in k or 'speaker' in k
                       for k in one.state_dict())


def test_forward_tacotron_forward_matches_jax():
    jmodel, variables, tmodel = _ft()
    b = _train_batch()
    ref = jmodel.apply(variables, _j(b), train=False)
    with torch.no_grad():
        out = tmodel(_t(b))
    for k in ('mel', 'mel_post', 'dur', 'pitch', 'energy'):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-4, err_msg=k)
    # the speakers condition the output
    with torch.no_grad():
        other = tmodel(_t(dict(b, speaker=np.zeros(3, np.int64))))
    assert not np.allclose(other['mel_post'].numpy(),
                           out['mel_post'].numpy(), atol=1e-3)


def test_forward_tacotron_series_and_generate_match_jax():
    jmodel, variables, tmodel = _ft()
    x, x_len = _text(seed=3)
    kw = dict(alpha=1.2, pitch_scale=0.7, energy_scale=1.4)
    jx, jl, js = (jnp.asarray(x.astype(np.int32)),
                  jnp.asarray(x_len.astype(np.int32)),
                  jnp.asarray(SPK.astype(np.int32)))
    # JAX's three separate predictors against the port's fused path
    ref = jmodel.apply(variables, jx, method='predict_series', fused=False,
                       x_len=jl, speaker=js, **kw)
    out = tmodel.predict_series(torch.from_numpy(x),
                                x_len=torch.from_numpy(x_len),
                                compute_dtype=F32,
                                speaker=torch.from_numpy(SPK), **kw)
    assert tmodel._series_fusable()
    for k in ('dur', 'pitch', 'energy'):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, err_msg=k)
    ref = jmodel.apply(variables, jx, 64, method='generate', x_len=jl,
                       speaker=js, fast=False)
    out = tmodel.generate(torch.from_numpy(x), 64,
                          x_len=torch.from_numpy(x_len), compute_dtype=F32,
                          speaker=torch.from_numpy(SPK))
    np.testing.assert_array_equal(out['mel_len'].numpy(),
                                  np.asarray(ref['mel_len']))
    for i, n in enumerate(out['mel_len'].tolist()):
        a = out['mel_post'][i, :n].numpy()
        b = np.asarray(ref['mel_post'])[i, :n]
        assert np.mean(np.abs(a - b)) < 1e-3
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_mixed_speaker_batch_equals_each_alone():
    _, _, tmodel = _ft()
    x, x_len = _text(seed=4)
    spk = torch.from_numpy(SPK)
    both = tmodel.generate(torch.from_numpy(x), 64,
                           x_len=torch.from_numpy(x_len), compute_dtype=F32,
                           speaker=spk)
    for i in range(3):
        one = tmodel.generate(torch.from_numpy(x[i:i + 1]), 64,
                              x_len=torch.from_numpy(x_len[i:i + 1]),
                              compute_dtype=F32, speaker=spk[i:i + 1])
        n = int(one['mel_len'][0])
        assert n == int(both['mel_len'][i])
        np.testing.assert_allclose(both['mel_post'][i, :n].numpy(),
                                   one['mel_post'][0, :n].numpy(), atol=1e-5)
    # a missing speaker is speaker 0
    a = tmodel.generate(torch.from_numpy(x), 64,
                        x_len=torch.from_numpy(x_len), compute_dtype=F32)
    b = tmodel.generate(torch.from_numpy(x), 64,
                        x_len=torch.from_numpy(x_len), compute_dtype=F32,
                        speaker=torch.zeros(3, dtype=torch.long))
    np.testing.assert_array_equal(a['mel_post'].numpy(),
                                  b['mel_post'].numpy())


# ------------------------------------------------- entry points, server

@pytest.fixture(scope='module')
def ms_fjax(tmp_path_factory):
    """The tiny multi-speaker ForwardTacotron of `_ft` as a `.fjax`
    written by the JAX package."""
    from forwardtacotron_tpu.utils.checkpoints import save_checkpoint
    from forwardtacotron_tpu_torch.config import default_config
    cfg = default_config()
    cfg['dsp'].update(num_mels=N_MELS, n_fft=64, win_length=64,
                      hop_length=16)
    cfg['forward_tacotron']['model'] = dict(FT_TINY)
    _, variables, _ = _ft()
    path = tmp_path_factory.mktemp('multispeaker') / 'tts.fjax'
    save_checkpoint(variables, cfg, path, step=2000)
    return path


def test_gen_forward_speaker_checked_and_pt_round_trip(ms_fjax, tmp_path,
                                                       monkeypatch):
    """`--speaker` within [0, 4) selects the voice, outside it is refused
    as the JAX CLI refuses it; a multi-speaker `.pt` written by the port
    loads back and synthesizes what the `.fjax` does."""
    from forwardtacotron_tpu_torch import gen_forward
    from forwardtacotron_tpu_torch.utils.checkpoints import save_checkpoint
    monkeypatch.chdir(tmp_path)
    base = ['--checkpoint', str(ms_fjax), '--device', 'cpu', '-i',
            'Hello there.']
    for bad in ('4', '-1'):
        with pytest.raises(SystemExit):
            gen_forward.main(base + ['--speaker', bad, 'hifigan'])
    mels = []
    for spk in ('0', '3'):
        (path,) = gen_forward.main(base + ['--speaker', spk, 'hifigan'])
        mels.append(np.load(path))
    assert mels[0].shape[1] == N_MELS
    assert mels[0].shape != mels[1].shape or \
        not np.allclose(mels[0], mels[1], atol=1e-3)
    model, cfg, _ = gen_forward.load_tts(str(ms_fjax), None, 'cpu')
    ids = gen_forward.text_to_ids('Hello there.', cfg)
    want = gen_forward.synthesize(model, ids, speaker=3)
    np.testing.assert_array_equal(mels[1][0], want)
    save_checkpoint(model, None, cfg, tmp_path / 'ms.pt', step=2000)
    again, _, _ = gen_forward.load_tts(str(tmp_path / 'ms.pt'), None, 'cpu')
    assert again.n_speakers == 4
    np.testing.assert_array_equal(
        gen_forward.synthesize(again, ids, speaker=3), want)


def test_server_batches_mixed_speakers(ms_fjax):
    """Requests for different voices share one batch (and the power-of-two
    pad row); each answer's mel equals its solo run's at atol 1e-5 (the
    server's vocoder stage hands the mels through: random weights drive
    Griffin-Lim's PCM into clipping, where a rounding flips a sample by
    the full range); the wav path answers too; an out-of-range speaker is
    refused at submit."""
    from forwardtacotron_tpu_torch.serving import TTSServer
    reqs = [('The birch canoe slid.', 0), ('Glue the sheet.', 3),
            ('It is easy to tell.', 1)]
    with TTSServer(str(ms_fjax), vocoder='griffinlim', max_batch=4,
                   max_wait_ms=300.0, mel_bucket=64, device='cpu',
                   compute_dtype=F32) as srv:
        with pytest.raises(ValueError, match='speaker'):
            srv.submit('Hello.', speaker=4)
        pcm = srv.synthesize(reqs[0][0], speaker=3, timeout=300)
        assert pcm.dtype == np.int16 and len(pcm) > 0
        srv._vocode = lambda mels: [m.copy() for m in mels]
        srv.batch_sizes.clear()
        futs = [srv.submit(t, speaker=s) for t, s in reqs]
        batched = [f.result(timeout=300) for f in futs]
        assert list(srv.batch_sizes) == [3]
        for (text, spk), got in zip(reqs, batched):
            solo = srv.synthesize(text, speaker=spk, timeout=300)
            assert got.shape == solo.shape and got.shape[0] == N_MELS
            np.testing.assert_allclose(got, solo, atol=1e-5)
        other = srv.synthesize(reqs[1][0], speaker=0, timeout=300)
    assert other.shape != batched[1].shape or \
        not np.allclose(other, batched[1], atol=1e-3)
