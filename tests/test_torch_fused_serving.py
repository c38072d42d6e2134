"""The port's fused server (`TTSServer(fused=True)`) on the CPU, against
its staged server and JAX's fused server, and `serve_forward --fused`.

On the CPU the fused function runs directly (the card captures it into a
CUDA graph; tests/test_torch_kernels_cuda.py holds the replay to the
eager function there). Tolerances are the JAX package's own
(tests/test_serving.py): fused HiFi-GAN PCM within 2 LSB of the staged
path's outside the last 64 * 40 samples (the staged path pads the mel to
a bucket, the fused one to `fused_max_t` frames, and the generator's
receptive field reaches back from the pad) and within 2 LSB of JAX's
fused server everywhere; WaveRNN's sampled PCM draws another noise
stream than JAX's, so the lengths are compared.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_serving

# the staged server's tests' fixtures: a tiny ForwardTacotron `.fjax` (hop
# 64) and a tiny HiFi-GAN in the official file layout
tts_ckpt = test_torch_serving.tts_ckpt
hifigan_file = test_torch_serving.hifigan_file

TEXT = 'The fused program speaks.'
VOC_TINY = dict(rnn_dims=16, fc_dims=16, pad=2, upsample_factors=[4, 4, 4],
                compute_dims=8, res_out_dims=8, res_blocks=1, mode='RAW')


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _server(tts, **kw):
    from forwardtacotron_tpu_torch.serving import TTSServer
    kw = dict(dict(max_wait_ms=5.0, mel_bucket=128, device='cpu',
                   compute_dtype=torch.float32), **kw)
    return TTSServer(tts, **kw)


@pytest.fixture(scope='module')
def wavernn_fjax(tts_ckpt, tmp_path_factory):
    """A tiny RAW WaveRNN `.fjax` of the JAX package, hop 64 as the TTS
    fixture's."""
    from forwardtacotron_tpu.models.wavernn import WaveRNN
    from forwardtacotron_tpu.utils.checkpoints import save_checkpoint
    from forwardtacotron_tpu_torch.weights import load_fjax
    config = dict(load_fjax(tts_ckpt)['config'],
                  vocoder={'model': dict(VOC_TINY)})
    model = WaveRNN.from_config(config)
    variables = jax.jit(model.init)(jax.random.PRNGKey(3),
                                    jnp.zeros((1, 128)),
                                    jnp.zeros((1, 6, 80)))
    path = tmp_path_factory.mktemp('fused_voc') / 'voc.fjax'
    save_checkpoint(jax.tree.map(np.asarray, variables), config, path,
                    step=1)
    return str(path)


def _pcm_diff(a, b):
    return int(np.abs(a.astype(np.int32) - b).max())


def test_fused_hifigan_matches_staged_and_jax(tts_ckpt, hifigan_file):
    from forwardtacotron_tpu.serving import TTSServer as JaxServer
    kw = dict(vocoder='hifigan', voc_checkpoint=hifigan_file)
    with _server(tts_ckpt, fused=True, fused_max_t=256, **kw) as srv:
        fused = srv.synthesize(TEXT, timeout=600)
        assert list(srv.batch_sizes) == [1]
        assert [k[1:] for k in srv._fused_programs] == [(1, 256)]
    with _server(tts_ckpt, **kw) as srv:
        staged = srv.synthesize(TEXT, timeout=600)
    with JaxServer(tts_ckpt, max_wait_ms=5.0, mel_bucket=128, fused=True,
                   fused_max_t=256, **kw) as jsrv:
        ref = jsrv.synthesize(TEXT, timeout=600)
        assert list(jsrv.batch_sizes) == [1]
    assert fused.dtype == staged.dtype == ref.dtype == np.int16
    assert fused.shape == staged.shape == ref.shape
    n = len(fused) - 64 * 40
    assert n > 0 and _pcm_diff(fused[:n], staged[:n]) <= 2
    assert _pcm_diff(fused, ref) <= 2


def test_fused_batch_of_knobs_matches_jax(tts_ckpt, hifigan_file):
    """Three requests of different alpha / pitch / energy in one fused
    batch (B=4 with one pad row), against JAX's fused server."""
    from forwardtacotron_tpu.serving import TTSServer as JaxServer
    reqs = [('The birch canoe slid on the smooth planks.', 1.0, 1.0, 1.0),
            ('Glue the sheet to the dark blue background.', 1.3, 0.8, 1.2),
            ('It is easy to tell the depth of a well.', 0.8, 1.2, 0.7)]
    kw = dict(vocoder='hifigan', voc_checkpoint=hifigan_file, max_batch=4,
              max_wait_ms=300.0, fused=True, fused_max_t=512)

    def batched(srv):
        futs = [srv.submit(t, alpha=a, pitch_scale=p, energy_scale=e)
                for t, a, p, e in reqs]
        out = [f.result(timeout=600) for f in futs]
        assert list(srv.batch_sizes) == [3]
        return out
    with _server(tts_ckpt, **kw) as srv:
        ours = batched(srv)
    with JaxServer(tts_ckpt, mel_bucket=128, **kw) as jsrv:
        refs = batched(jsrv)
    for a, r in zip(ours, refs):
        assert a.shape == r.shape and _pcm_diff(a, r) <= 2


def test_fused_overflow_falls_back(tts_ckpt, hifigan_file):
    """Outputs of `fused_max_t` frames or more rerun on the staged path,
    which gives the staged server's PCM."""
    text = 'This output will not fit in thirty two frames of mel at all.'
    kw = dict(vocoder='hifigan', voc_checkpoint=hifigan_file)
    with _server(tts_ckpt, fused=True, fused_max_t=32, **kw) as srv:
        pcm = srv.synthesize(text, timeout=600)
        # the fused program ran first
        assert [k[2] for k in srv._fused_programs] == [32]
    with _server(tts_ckpt, **kw) as srv:
        staged = srv.synthesize(text, timeout=600)
    assert len(pcm) > 32 * 64
    assert np.array_equal(pcm, staged)


def test_fused_wavernn_lengths_match_jax(tts_ckpt, wavernn_fjax):
    from forwardtacotron_tpu.serving import TTSServer as JaxServer
    kw = dict(vocoder='wavernn', voc_checkpoint=wavernn_fjax, fused=True,
              fused_max_t=128)
    text = 'Hello world.'
    with _server(tts_ckpt, **kw) as srv:
        pcm = srv.synthesize(text, timeout=600)
        assert list(srv.batch_sizes) == [1]
    with JaxServer(tts_ckpt, max_wait_ms=5.0, mel_bucket=128, **kw) as jsrv:
        ref = jsrv.synthesize(text, timeout=600)
    assert pcm.dtype == ref.dtype == np.int16
    assert pcm.shape == ref.shape and pcm.std() > 0


def test_fused_warmup(tts_ckpt, hifigan_file):
    """warmup() makes each (text bucket, batch) fused program, then runs
    the staged series and decode for the fallback, not the staged
    vocoder."""
    with _server(tts_ckpt, vocoder='hifigan', voc_checkpoint=hifigan_file,
                 max_batch=3, fused=True, fused_max_t=256) as srv:
        out = srv.warmup(text_lens=[16, 32])
        assert out['programs'] == 2 * 2 * (1 + 1)   # B 1, 4; tx 16, 32
        assert sorted(srv._fused_programs) == [
            (16, 1, 256), (16, 4, 256), (32, 1, 256), (32, 4, 256)]
        assert srv.synthesize('Hello world.', timeout=600).dtype == np.int16


def test_fused_refusals(tts_ckpt):
    from forwardtacotron_tpu.serving import TTSServer as JaxServer
    msg = 'fused serving needs a neural vocoder'
    with pytest.raises(ValueError, match=msg):
        JaxServer(tts_ckpt, fused=True)
    with pytest.raises(ValueError, match=msg):
        _server(tts_ckpt, fused=True)
    with pytest.raises(ValueError, match='mesh'):
        _server(tts_ckpt, vocoder='hifigan', voc_checkpoint='x',
                fused=True, mesh=object())


def test_serve_forward_fused_builds_and_warms(tts_ckpt, hifigan_file,
                                              monkeypatch, capsys):
    """`serve_forward --fused --fused_max_t 512 hifigan` builds the fused
    server, warms it up and serves (the HTTP front stubbed to stop at
    once)."""
    from forwardtacotron_tpu_torch import serve_forward, serving
    made = {}

    class Front:
        def serve_forever(self):
            srv = made['server']
            assert srv.fused and srv.fused_max_t == 512
            assert (16, 1, 512) in srv._fused_programs
            raise KeyboardInterrupt

        def server_close(self):
            made['closed'] = True

    def front(server, host, port):
        made['server'] = server
        return Front()
    monkeypatch.setattr(serving, 'make_http_server', front)
    serve_forward.main(['--checkpoint', tts_ckpt, '--device', 'cpu',
                        '--fused', '--fused_max_t', '512', 'hifigan',
                        '--voc_checkpoint', hifigan_file])
    assert made['closed'] and made['server']._closed
    assert 'warm-up shapes' in capsys.readouterr().out
