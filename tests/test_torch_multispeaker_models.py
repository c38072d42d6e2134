"""Multi-speaker FastPitch and the multi-speaker Tacotron teacher in the
port on the CPU, against the JAX package with the same weights (random
from JAX's init, three speakers) and seeded inputs: the teacher-forced
forward at atol 1e-4; padded-bucket `generate` with a mel mean absolute
error below 1e-3 and an equal `mel_len` (FastPitch), the teacher's
free-running mel, linear and attention at atol 1e-4 with an equal
`n_valid`; each model's output moved by the speaker.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_multispeaker import (FP_TINY, N_MELS, NUM_CHARS, SPK,
                                     TACO_TINY, _j, _random_stats, _t,
                                     _text, _train_batch)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """Small ops in loops: one intra-op thread runs them faster under the
    suite's workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- FastPitch

def test_fast_pitch_forward_and_generate_match_jax():
    from forwardtacotron_tpu.models.fast_pitch import FastPitch as JaxFP
    from forwardtacotron_tpu_torch.models.fast_pitch import FastPitch
    from forwardtacotron_tpu_torch.weights import fast_pitch_state_dict
    jmodel = JaxFP(num_chars=NUM_CHARS, n_mels=N_MELS, **FP_TINY)
    b = _train_batch(seed=2)
    b['speaker'] = np.array([0, 2, 1], np.int64)
    variables = jax.jit(lambda k: jmodel.init(
        {'params': k}, _j(b), train=False))(jax.random.PRNGKey(1))
    variables = jax.tree.map(np.asarray, variables)
    tmodel = FastPitch(num_chars=NUM_CHARS, n_mels=N_MELS, **FP_TINY)
    tmodel.load_state_dict(fast_pitch_state_dict(variables, FP_TINY),
                           strict=True)
    ref = jmodel.apply(variables, _j(b), train=False)
    with torch.no_grad():
        out = tmodel.eval()(_t(b))
    for k in ('mel', 'dur', 'pitch', 'energy'):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-4, err_msg=k)
    x, x_len = _text(seed=5)
    spk = b['speaker']
    ref = jmodel.apply(variables, jnp.asarray(x.astype(np.int32)), 64,
                       method='generate',
                       x_len=jnp.asarray(x_len.astype(np.int32)),
                       speaker=jnp.asarray(spk.astype(np.int32)))
    out = tmodel.generate(torch.from_numpy(x), 64,
                          x_len=torch.from_numpy(x_len),
                          speaker=torch.from_numpy(spk))
    np.testing.assert_array_equal(out['mel_len'].numpy(),
                                  np.asarray(ref['mel_len']))
    for i, n in enumerate(out['mel_len'].tolist()):
        a = out['mel_post'][i, :n].numpy()
        r = np.asarray(ref['mel_post'])[i, :n]
        assert np.mean(np.abs(a - r)) < 1e-3
        np.testing.assert_allclose(a, r, atol=1e-4)
    other = tmodel.generate(torch.from_numpy(x), 64,
                            x_len=torch.from_numpy(x_len),
                            speaker=torch.zeros(3, dtype=torch.long))
    assert not torch.allclose(other['mel_post'], out['mel_post'], atol=1e-3)


# --------------------------------------------------------------- Tacotron

def test_tacotron_forward_and_generate_match_jax():
    from forwardtacotron_tpu.models.tacotron import Tacotron as JaxTaco
    from forwardtacotron_tpu_torch.models.tacotron import Tacotron
    from forwardtacotron_tpu_torch.weights import tacotron_state_dict
    x, _ = _text(seed=6)
    mel = _train_batch()['mel'][:, :12]
    jmodel = JaxTaco(num_chars=NUM_CHARS, n_mels=N_MELS, **TACO_TINY)
    js = jnp.asarray(SPK[[0, 1, 2]].astype(np.int32) - 1)
    variables = jax.jit(lambda k: jmodel.init(
        {'params': k}, jnp.asarray(x), jnp.asarray(mel), 2, train=False,
        speaker=js))(jax.random.PRNGKey(2))
    variables = {'params': jax.tree.map(np.asarray, variables['params']),
                 'batch_stats': _random_stats(variables['batch_stats'],
                                              np.random.RandomState(6))}
    tmodel = Tacotron(num_chars=NUM_CHARS, n_mels=N_MELS, **TACO_TINY)
    tmodel.load_state_dict(tacotron_state_dict(variables, TACO_TINY),
                           strict=True)
    tmodel.eval()
    spk = torch.from_numpy(SPK - 1)
    ref = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(mel), 2,
                       train=False, speaker=js)
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x), torch.from_numpy(mel), 2,
                     speaker=spk)
    for name, got, want in zip(('mel', 'linear', 'attention'), out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, err_msg=name)
    ref = jmodel.apply(variables, jnp.asarray(x), 16, 1, method='generate',
                       speaker=js)
    got = tmodel.generate(torch.from_numpy(x), 16, 1, speaker=spk)
    assert got[3] == int(ref[3])
    for name, a, b in zip(('mel', 'linear', 'attention'), got[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   err_msg=name)
    other = tmodel.generate(torch.from_numpy(x), 16, 1)
    assert not torch.allclose(other[0], got[0], atol=1e-4)
