"""The port's WaveRNN (CPU, float32 plain path) against the JAX package
with the same weights and inputs.

Gates follow tests/test_pallas_wavernn.py: upsampling at atol 1e-4;
greedy RAW trajectories pick the same class on > 95% of steps, greedy MOL ones
within 1e-3 on > 95%, against `sample_scan(greedy=True,
weights_dtype=float32)`. The JAX PRNG and the port's Philox differ, so
sampled output is checked by range, spread and determinism.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

TINY = dict(rnn_dims=32, fc_dims=32, bits=9, pad=2, upsample_factors=(2, 2),
            feat_dims=10, compute_dims=8, res_out_dims=8, res_blocks=1,
            hop_length=4, sample_rate=1000)
F32 = torch.float32


def _randomize_batch_stats(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize_batch_stats(v, rng)
        elif k == 'mean':
            out[k] = rng.randn(*v.shape).astype(np.float32) * 0.1
        else:
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return out


def _setup(mode):
    from forwardtacotron_tpu.models.wavernn import WaveRNN as JaxWaveRNN
    from forwardtacotron_tpu_torch.models.wavernn import WaveRNN
    from forwardtacotron_tpu_torch.weights import wavernn_state_dict
    jmodel = JaxWaveRNN(mode=mode, **TINY)
    rng = np.random.RandomState(0 if mode == 'RAW' else 1)
    mel = rng.randn(1, 30, TINY['feat_dims']).astype(np.float32)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 104)), jnp.asarray(mel))
    variables = {'params': jax.tree.map(np.asarray, variables['params']),
                 'batch_stats': _randomize_batch_stats(
                     variables['batch_stats'], rng)}
    tmodel = WaveRNN(mode=mode, **TINY)
    cfg = dict(TINY, mode=mode)
    tmodel.load_state_dict(wavernn_state_dict(variables, cfg), strict=True)
    return jmodel, variables, tmodel, mel


@pytest.fixture(scope='module')
def raw():
    return _setup('RAW')


@pytest.fixture(scope='module')
def mol():
    return _setup('MOL')


def _cond(jmodel, variables, mel):
    mels_up, aux = jmodel.apply(variables, jnp.asarray(mel),
                                method='upsample_cond')
    return np.asarray(mels_up), np.asarray(aux)


def test_upsample_cond_matches_jax(raw):
    jmodel, variables, tmodel, mel = raw
    ref = _cond(jmodel, variables, mel)
    out = tmodel.upsample_cond(torch.from_numpy(mel))
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4)


@pytest.mark.parametrize('mode', ['RAW', 'MOL'])
def test_greedy_trajectory_matches_jax_scan(raw, mol, mode):
    jmodel, variables, tmodel, mel = raw if mode == 'RAW' else mol
    mels_up, aux = _cond(jmodel, variables, mel)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(mels_up),
                                  jnp.asarray(aux), jax.random.PRNGKey(0),
                                  method='sample_scan', greedy=True,
                                  weights_dtype=jnp.float32))
    out = tmodel.sample_scan(torch.tensor(mels_up), torch.tensor(aux),
                             greedy=True,
                             compute_dtype=F32).numpy()
    assert out.shape == ref.shape
    # RAW: the same class (classes are 2/511 apart; the value formula may
    # round differently in the last bit)
    agree = np.abs(out - ref) < (1e-6 if mode == 'RAW' else 1e-3)
    assert float(np.mean(agree)) > 0.95, float(np.mean(agree))


@pytest.mark.parametrize('mode', ['RAW', 'MOL'])
def test_sampled_output_in_range_and_seeded(raw, mol, mode):
    from forwardtacotron_tpu_torch.kernels.wavernn_sample import (
        sample_conditioned)
    jmodel, variables, tmodel, mel = raw if mode == 'RAW' else mol
    mels_up, aux = (torch.from_numpy(a) for a in _cond(jmodel, variables,
                                                       mel))
    a = sample_conditioned(tmodel, mels_up, aux, seed=7, compute_dtype=F32)
    b = sample_conditioned(tmodel, mels_up, aux, seed=7, compute_dtype=F32)
    c = sample_conditioned(tmodel, mels_up, aux, seed=8, compute_dtype=F32)
    assert a.shape == (1, mels_up.shape[1])
    assert torch.all(a.abs() <= 1.0) and float(a.std()) > 0
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_lane_groups_equal_one_launch(raw, monkeypatch):
    from forwardtacotron_tpu_torch.kernels import wavernn_sample as ws
    jmodel, variables, tmodel, mel = raw
    mels_up, aux = (torch.from_numpy(np.concatenate([a] * 3))
                    for a in _cond(jmodel, variables, mel))
    one = ws.sample_conditioned(tmodel, mels_up, aux, greedy=True,
                                compute_dtype=F32)
    monkeypatch.setattr(ws, 'MAX_LANES', 2)
    grouped = ws.sample_conditioned(tmodel, mels_up, aux, greedy=True,
                                    compute_dtype=F32)
    assert torch.equal(one, grouped)


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    from forwardtacotron_tpu_torch.kernels.wavernn_sample import philox4x32
    z = torch.zeros(1, dtype=torch.int64)
    f = torch.full((1,), 0xFFFFFFFF, dtype=torch.int64)
    assert [int(w) for w in philox4x32(z, z, z, z, 0)] == [
        0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8]
    assert [int(w) for w in philox4x32(f, f, f, f, 0xFFFFFFFFFFFFFFFF)] == [
        0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd]


def test_generate_wav_greedy_matches_jax_pipeline(raw):
    """Port generate_wav (greedy, batched folds) against the JAX
    package's stepwise generate_wav pipeline with its float32 greedy
    sampler: upsample_cond, fold_with_overlap, sample_scan, mu-law
    decode, crossfade-unfold, fade-out."""
    from forwardtacotron_tpu.dsp.audio import DSP
    from forwardtacotron_tpu.models import wavernn as jw
    from forwardtacotron_tpu_torch.models.wavernn import generate_wav
    jmodel, variables, tmodel, _ = raw
    rng = np.random.RandomState(3)
    mel = rng.randn(TINY['feat_dims'], 40).astype(np.float32)
    target, overlap = 24, 8
    m = jw.pad_tensor(mel.T[None], pad=TINY['pad'], side='both')
    mels_up, aux = _cond(jmodel, variables, m)
    mels_f = jw.fold_with_overlap(mels_up, target, overlap)
    aux_f = jw.fold_with_overlap(aux, target, overlap)
    samples = np.asarray(jmodel.apply(
        variables, jnp.asarray(mels_f), jnp.asarray(aux_f),
        jax.random.PRNGKey(0), method='sample_scan', greedy=True,
        weights_dtype=jnp.float32)).astype(np.float64)
    ref = DSP.decode_mu_law(samples, 2 ** TINY['bits'], False)
    ref = jw.xfade_and_unfold(ref, target, overlap)
    wave_len = (mel.shape[1] - 1) * TINY['hop_length']
    ref = ref[:wave_len]
    n_fade = min(20 * TINY['hop_length'], wave_len)
    ref[wave_len - n_fade:] *= np.linspace(1, 0, n_fade)

    out = generate_wav(tmodel, mel, batched=True, target=target,
                       overlap=overlap, greedy=True, compute_dtype=F32)
    assert out.shape == ref.shape == (wave_len,)
    assert float(np.mean(np.abs(out - ref) < 1e-5)) > 0.95


def test_vocode_matches_generate_wav(raw):
    """The on-device crossfade (float32) equals the host one (float64)."""
    from forwardtacotron_tpu_torch.models.wavernn import (generate_wav,
                                                          vocode)
    _, _, tmodel, _ = raw
    mel = np.random.RandomState(4).randn(40, TINY['feat_dims']).astype(
        np.float32)
    kw = dict(target=24, overlap=8, greedy=True, compute_dtype=F32)
    a = vocode(tmodel, mel, **kw)
    b = generate_wav(tmodel, mel, **kw)
    np.testing.assert_allclose(a, b, atol=1e-5)
    pcm = vocode(tmodel, mel, pcm16=True, **kw)
    assert pcm.dtype == np.int16 and pcm.shape == a.shape
