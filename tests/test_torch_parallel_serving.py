"""The port's vocoding sharded over a mesh's devices on the CPU:
`vocode_batch(mesh=)` against the JAX package's `vocode_batch(mesh=)` over
two devices and against the port's unsharded call, and `TTSServer(mesh=)`.

Greedy RAW waveforms are compared at atol 1e-6, as
tests/test_torch_vocode.py compares them (the classes are equal; a value
2*cls/511 - 1 may round apart in the last bit between the packages), and
the port's sharded and unsharded calls bit for bit.
"""
import numpy as np
import pytest

import jax
import torch

import test_torch_fused_serving
from test_torch_vocode import F32, TINY, _mel, jax_greedy_f32, raw  # noqa

tts_ckpt = test_torch_fused_serving.tts_ckpt
wavernn_fjax = test_torch_fused_serving.wavernn_fjax
KW = dict(target=24, overlap=8)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mels():
    # 40, 57 and 23 frames: on two shards the second takes the third mel
    # and a silent dummy, and its bucket is smaller than the first's
    return [_mel(40, 2), _mel(57, 3).T, _mel(23, 4)]


def test_sharded_greedy_matches_jax_and_unsharded(raw, jax_greedy_f32):
    from forwardtacotron_tpu.models.wavernn import vocode_batch as jbatch
    from forwardtacotron_tpu.parallel.mesh import make_mesh as jax_mesh
    from forwardtacotron_tpu_torch.parallel import make_mesh
    from forwardtacotron_tpu_torch.models.wavernn import vocode_batch
    jmodel, variables, tmodel = raw
    mels = _mels()
    refs = jbatch(jmodel, variables, mels, use_pallas=False, greedy=True,
                  mesh=jax_mesh(n_data=2, devices=jax.devices()[:2]), **KW)
    mesh = make_mesh(devices=['cpu', 'cpu'])
    ours = vocode_batch(tmodel, mels, compute_dtype=F32, greedy=True,
                        mesh=mesh, **KW)
    whole = vocode_batch(tmodel, mels, compute_dtype=F32, greedy=True, **KW)
    assert len(ours) == len(refs) == 3
    for m, a, r, w in zip(mels, ours, refs, whole):
        assert a.shape == r.shape == ((max(m.shape) - 1)
                                      * TINY['hop_length'],)
        np.testing.assert_allclose(a, r, atol=1e-6)
        np.testing.assert_array_equal(a, w)


def test_sharded_sampling_seeds_each_shard(raw):
    """Sampled, shard i is `vocode_batch` of its own mels at seed + i *
    7919; the shards do not draw the unsharded call's noise."""
    from forwardtacotron_tpu_torch.models.wavernn import (SHARD_SEED_STRIDE,
                                                          vocode_batch)
    from forwardtacotron_tpu_torch.parallel import make_mesh
    _, _, tmodel = raw
    mels = _mels() + [_mel(31, 5)]
    mesh = make_mesh(devices=['cpu', 'cpu'])
    ours = vocode_batch(tmodel, mels, compute_dtype=F32, seed=3, mesh=mesh,
                        **KW)
    assert SHARD_SEED_STRIDE == 7919
    for i in range(2):
        shard = vocode_batch(tmodel, mels[2 * i:2 * i + 2], compute_dtype=F32,
                             seed=3 + i * 7919, **KW)
        for a, b in zip(ours[2 * i:2 * i + 2], shard):
            np.testing.assert_array_equal(a, b)
    whole = vocode_batch(tmodel, mels, compute_dtype=F32, seed=3, **KW)
    assert not np.array_equal(ours[2], whole[2])


def test_server_with_mesh(tts_ckpt, wavernn_fjax, monkeypatch):
    """`TTSServer(mesh=)` hands its mesh to the staged WaveRNN vocode, and
    answers concurrent requests with the unsharded server's lengths; a
    mesh that is not the port's `Mesh` is refused, naming `mesh`."""
    from forwardtacotron_tpu_torch import serving
    from forwardtacotron_tpu_torch.parallel import make_mesh
    seen = []
    real = serving.vocode_batch

    def spy(*args, mesh=None, **kw):
        seen.append(mesh)
        # short folds: many lanes of few sequential steps on the CPU
        return real(*args, mesh=mesh, target=256, overlap=32, **kw)
    monkeypatch.setattr(serving, 'vocode_batch', spy)
    mesh = make_mesh(devices=['cpu', 'cpu'])
    texts = ['Hello world.', 'The birch canoe slid.', 'Glue the sheet.']
    outs = []
    for m in (mesh, None):
        with serving.TTSServer(tts_ckpt, vocoder='wavernn',
                               voc_checkpoint=wavernn_fjax, device='cpu',
                               max_wait_ms=200.0, mel_bucket=128,
                               compute_dtype=F32, mesh=m) as srv:
            assert srv.mesh is m
            futs = [srv.submit(t) for t in texts]
            outs.append([f.result(timeout=600) for f in futs])
    assert seen and seen[0] is mesh and seen[-1] is None
    for a, b in zip(*outs):
        assert a.dtype == b.dtype == np.int16
        assert a.shape == b.shape and a.std() > 0
    with pytest.raises(ValueError, match='mesh'):
        serving.TTSServer(tts_ckpt, device='cpu', mesh=object())
