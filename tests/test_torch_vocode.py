"""The port's WaveRNN vocoding entry points (CPU, float32 plain sampler)
against the JAX package's: the default fold, `vocode_batch` and
`stream_wav`.

The JAX side runs its scan sampler greedy in float32 (its `sample_scan`
patched to greedy=True, weights_dtype=float32, as tests/test_streaming.py
does), so both packages take the same greedy trajectory. Greedy RAW
samples are the same classes; their values `2*cls/511 - 1` may round
apart in the last bit, so waveforms are compared at atol 1e-6, as
tests/test_torch_wavernn.py compares; MOL greedy at atol 1e-5.
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
TOL = {'RAW': 1e-6, 'MOL': 1e-5}


def _setup(mode):
    from forwardtacotron_tpu.models.wavernn import WaveRNN as JaxWaveRNN
    from forwardtacotron_tpu_torch.models.wavernn import WaveRNN
    from forwardtacotron_tpu_torch.weights import wavernn_state_dict
    jmodel = JaxWaveRNN(mode=mode, **TINY)
    rng = np.random.RandomState(11 if mode == 'RAW' else 12)
    variables = jax.jit(jmodel.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 104)),
        jnp.zeros((1, 30, TINY['feat_dims'])))
    variables = jax.tree.map(np.asarray, variables)
    stats = jax.tree.map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
        variables['batch_stats'])
    variables = {'params': variables['params'], 'batch_stats': stats}
    tmodel = WaveRNN(mode=mode, **TINY)
    tmodel.load_state_dict(wavernn_state_dict(variables,
                                              dict(TINY, mode=mode)))
    return jmodel, variables, tmodel


@pytest.fixture(scope='module')
def raw():
    return _setup('RAW')


@pytest.fixture(scope='module')
def mol():
    return _setup('MOL')


@pytest.fixture
def jax_greedy_f32(monkeypatch):
    """The JAX package's scan sampler, greedy in float32, with its jit
    caches emptied so that the patch is traced."""
    from forwardtacotron_tpu.models import streaming as js
    from forwardtacotron_tpu.models import wavernn as jw
    orig = jw.WaveRNN.sample_scan

    def patched(self, mels_up, aux, key, greedy=False, weights_dtype=None):
        return orig(self, mels_up, aux, key, greedy=True,
                    weights_dtype=jnp.float32)
    monkeypatch.setattr(jw.WaveRNN, 'sample_scan', patched)
    monkeypatch.setattr(jw, '_GEN_JIT_CACHE', {})
    monkeypatch.setattr(js, '_STREAM_JIT_CACHE', {})


def _mel(T, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(TINY['feat_dims'], T).astype(np.float32)


@pytest.mark.parametrize('mode', ['RAW', 'MOL'])
def test_default_fold_matches_jax(raw, mol, jax_greedy_f32, mode):
    """target=None folds at the reference's 11000 on the plain path, as
    the JAX package does without its kernel: 2900 frames are one fold
    there and four at the kernel's 2750."""
    from forwardtacotron_tpu.models.wavernn import generate_wav as jgen
    from forwardtacotron_tpu_torch.models.wavernn import (
        TARGET_KERNEL, TARGET_PLAIN, fold_indices, fold_target,
        generate_wav, vocode)
    jmodel, variables, tmodel = raw if mode == 'RAW' else mol
    assert fold_target(None, 'cpu') == TARGET_PLAIN == 11_000
    assert fold_target(None, 'cuda') == TARGET_KERNEL == 2750
    assert fold_target(500, 'cuda') == 500
    mel = _mel(2900, seed=1)
    wave_len = (mel.shape[1] - 1) * TINY['hop_length']
    assert len(fold_indices(wave_len + 8, TARGET_PLAIN, 550)[0]) == 1
    assert len(fold_indices(wave_len + 8, TARGET_KERNEL, 550)[0]) == 4
    ref = jgen(jmodel, variables, mel, batched=True, target=None,
               use_pallas=False, fused=False)
    ours = generate_wav(tmodel, mel, target=None, greedy=True,
                        compute_dtype=F32)
    assert ours.shape == ref.shape == (wave_len,)
    np.testing.assert_allclose(ours, ref, atol=TOL[mode])
    np.testing.assert_allclose(
        vocode(tmodel, mel, target=None, greedy=True, compute_dtype=F32),
        ref, atol=TOL[mode])


@pytest.mark.parametrize('mode', ['RAW', 'MOL'])
def test_vocode_batch_matches_jax_and_vocode(raw, mol, jax_greedy_f32,
                                             mode):
    """Three utterances of 40, 57 and 23 frames in one batch (a 64-frame
    bucket, 18 fold lanes in groups of MAX_LANES) against the JAX
    vocode_batch and the port's per-utterance vocode."""
    from forwardtacotron_tpu.models.wavernn import vocode_batch as jbatch
    from forwardtacotron_tpu_torch.kernels import wavernn_sample as ws
    from forwardtacotron_tpu_torch.models.wavernn import (vocode,
                                                          vocode_batch)
    jmodel, variables, tmodel = raw if mode == 'RAW' else mol
    mels = [_mel(40, 2), _mel(57, 3).T, _mel(23, 4)]
    kw = dict(target=24, overlap=8, greedy=True)
    refs = jbatch(jmodel, variables, mels, use_pallas=False, **kw)
    ours = vocode_batch(tmodel, mels, compute_dtype=F32, **kw)
    for m, a, r in zip(mels, ours, refs):
        n = max(m.shape) - 1
        assert a.shape == r.shape == (n * TINY['hop_length'],)
        np.testing.assert_allclose(a, r, atol=TOL[mode])
        np.testing.assert_allclose(
            a, vocode(tmodel, m, compute_dtype=F32, **kw), atol=TOL[mode])
    # lanes split into groups of 4 launches: the same waveforms (greedy)
    saved = ws.MAX_LANES
    ws.MAX_LANES = 4
    try:
        grouped = vocode_batch(tmodel, mels, compute_dtype=F32, **kw)
    finally:
        ws.MAX_LANES = saved
    for a, b in zip(ours, grouped):
        np.testing.assert_array_equal(a, b)
    pcm = vocode_batch(tmodel, mels, compute_dtype=F32, pcm16=True, **kw)
    for a, p in zip(ours, pcm):
        assert p.dtype == np.int16
        np.testing.assert_array_equal(
            p, (np.clip(a, -1, 1) * 32767.0).astype(np.int16))


def test_vocode_batch_sampled_is_seeded(raw):
    from forwardtacotron_tpu_torch.models.wavernn import vocode_batch
    _, _, tmodel = raw
    mels = [_mel(30, 5), _mel(18, 6)]
    kw = dict(target=24, overlap=8, compute_dtype=F32)
    a = vocode_batch(tmodel, mels, seed=3, **kw)
    b = vocode_batch(tmodel, mels, seed=3, **kw)
    c = vocode_batch(tmodel, mels, seed=4, **kw)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    assert all(np.abs(x).max() <= 1.0 and x.std() > 0 for x in a)


def test_stream_wav_matches_jax_and_generate_wav(raw, jax_greedy_f32):
    from forwardtacotron_tpu.models.streaming import stream_wav as jstream
    from forwardtacotron_tpu_torch.models.streaming import stream_wav
    from forwardtacotron_tpu_torch.models.wavernn import generate_wav
    jmodel, variables, tmodel = raw
    mel = _mel(60, 7)
    kw = dict(target=24, overlap=8, group=2)
    chunks = list(stream_wav(tmodel, mel, greedy=True, compute_dtype=F32,
                             **kw))
    assert len(chunks) > 2
    assert max(len(c) for c in chunks) <= 2 * (24 + 8)
    ours = np.concatenate(chunks)
    ref = np.concatenate(list(jstream(jmodel, variables, mel,
                                      use_pallas=False, greedy=True, **kw)))
    assert ours.shape == ref.shape == (59 * TINY['hop_length'],)
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    np.testing.assert_allclose(ours, generate_wav(
        tmodel, mel, target=24, overlap=8, greedy=True, compute_dtype=F32),
        atol=1e-12)


def test_stream_wav_sample_fn_seam_and_writer(raw, tmp_path):
    """The sample_fn seam gets each group's lanes and seed + g0; the
    streamed file holds exactly the samples yielded."""
    import wave
    from forwardtacotron_tpu_torch.models.streaming import (
        stream_wav, write_wav_streaming)
    _, _, tmodel = raw
    seen = []

    def fake(m, a, s):
        seen.append((m.shape[0], s))
        return torch.zeros(m.shape[:2])

    mel = _mel(60, 8)
    chunks = list(stream_wav(tmodel, mel, target=24, overlap=8, group=3,
                             seed=10, sample_fn=fake, mu_law=False))
    assert [s for _, s in seen] == [10 + g for g in range(0, 3 * len(seen),
                                                          3)]
    assert sum(len(c) for c in chunks) == 59 * TINY['hop_length']
    n = write_wav_streaming(iter(chunks), tmp_path / 's.wav', 1000)
    with wave.open(str(tmp_path / 's.wav')) as w:
        assert w.getnframes() == n == 59 * TINY['hop_length']
        assert w.getframerate() == 1000
