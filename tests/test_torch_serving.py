"""The port's dynamic-batching TTSServer on the CPU.

One tiny `.fjax` ForwardTacotron (written by the JAX package) and one
tiny HiFi-GAN in the official file layout go through both packages'
servers; three heterogeneous requests batch together on each side and
give the same int16 PCM within 8 units (float32 on both sides; measured
at most 1 here, printed by the test). Then the behaviours of the JAX
package's tests/test_serving.py that apply to the staged server, on the
HiFi-GAN server (batching, alpha scaling the length, error isolation,
the article paths, stats and the HTTP front on 127.0.0.1) and on
Griffin-Lim servers (warm-up, close and drain, load shedding, expiry).
"""
import io
import json
import threading
import time
import wave

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

TINY_MODEL_CFG = {
    'embed_dims': 16, 'series_embed_dims': 8,
    'durpred_conv_dims': 8, 'durpred_rnn_dims': 4, 'durpred_dropout': 0.5,
    'pitch_conv_dims': 8, 'pitch_rnn_dims': 4, 'pitch_dropout': 0.5,
    'pitch_strength': 1.0,
    'energy_conv_dims': 8, 'energy_rnn_dims': 4, 'energy_dropout': 0.5,
    'energy_strength': 1.0,
    'rnn_dims': 8, 'prenet_dims': 8, 'prenet_k': 2,
    'postnet_num_highways': 1, 'prenet_dropout': 0.5,
    'postnet_dims': 8, 'postnet_k': 2, 'prenet_num_highways': 1,
    'postnet_dropout': 0.0,
}
HIFI_CFG = {'resblock': '2', 'upsample_rates': [8, 4, 2],
            'upsample_kernel_sizes': [16, 8, 4],
            'upsample_initial_channel': 16, 'resblock_kernel_sizes': [3],
            'resblock_dilation_sizes': [[1, 3]]}
PCM_TOL = 8


@pytest.fixture(scope='module')
def tts_ckpt(tmp_path_factory):
    from forwardtacotron_tpu.models.forward_tacotron import ForwardTacotron
    from forwardtacotron_tpu.utils.checkpoints import save_checkpoint
    config = {
        'tts_model': 'forward_tacotron',
        'forward_tacotron': {'model': dict(TINY_MODEL_CFG)},
        'dsp': {'sample_rate': 22050, 'n_fft': 256, 'num_mels': 80,
                'hop_length': 64, 'win_length': 256, 'fmin': 0,
                'fmax': 8000, 'peak_norm': False,
                'trim_start_end_silence': False,
                'trim_silence_top_db': 60, 'pitch_max_freq': 600,
                'trim_long_silences': False, 'vad_window_length': 30,
                'vad_moving_average_width': 8,
                'vad_max_silence_length': 12, 'vad_sample_rate': 16000,
                'voc_mode': 'RAW', 'bits': 9, 'mu_law': True},
        'preprocessing': {'language': 'en-us', 'cleaner_name':
                          'english_cleaners', 'use_phonemes': True},
    }
    model = ForwardTacotron.from_config(config)
    variables = jax.jit(lambda k: model.init(
        {'params': k}, jnp.ones((1, 16), jnp.int32), 64, method='generate',
        x_len=jnp.asarray([12])))(jax.random.PRNGKey(0))
    p = tmp_path_factory.mktemp('torch_serving') / 'tts.fjax'
    save_checkpoint(variables, config, p, step=1000)
    return str(p)


@pytest.fixture(scope='module')
def hifigan_file(tmp_path_factory):
    from forwardtacotron_tpu_torch.models.hifigan import (
        HiFiGANGenerator, weight_norm_state_dict)
    d = tmp_path_factory.mktemp('torch_serving_voc')
    torch.manual_seed(7)
    gen = HiFiGANGenerator.from_config(HIFI_CFG, n_mels=80)
    torch.save({'generator': weight_norm_state_dict(gen)}, d / 'g_00000001')
    (d / 'config.json').write_text(json.dumps(HIFI_CFG))
    return str(d / 'g_00000001')


def _server(tts_ckpt, **kw):
    from forwardtacotron_tpu_torch.serving import TTSServer
    kw = dict(dict(vocoder='griffinlim', max_batch=4, max_wait_ms=150.0,
                   mel_bucket=128, device='cpu',
                   compute_dtype=torch.float32), **kw)
    return TTSServer(tts_ckpt, **kw)


@pytest.fixture(scope='module')
def server(tts_ckpt, hifigan_file):
    srv = _server(tts_ckpt, vocoder='hifigan', voc_checkpoint=hifigan_file)
    yield srv
    srv.close()


REQUESTS = [('The birch canoe slid on the smooth planks.', 1.0, 1.0, 1.0),
            ('Glue the sheet to the dark blue background.', 1.3, 0.8, 1.2),
            ('It is easy to tell the depth of a well.', 0.8, 1.2, 0.7)]


def _batched(srv):
    srv.batch_sizes.clear()
    futs = [srv.submit(t, alpha=a, pitch_scale=p, energy_scale=e)
            for t, a, p, e in REQUESTS]
    out = [f.result(timeout=600) for f in futs]
    assert list(srv.batch_sizes) == [3]
    return out


def test_server_output_matches_jax_server(tts_ckpt, hifigan_file):
    from forwardtacotron_tpu.serving import TTSServer as JaxServer
    with JaxServer(tts_ckpt, vocoder='hifigan', voc_checkpoint=hifigan_file,
                   max_batch=4, max_wait_ms=300.0, mel_bucket=128) as jsrv:
        refs = _batched(jsrv)
    with _server(tts_ckpt, vocoder='hifigan', voc_checkpoint=hifigan_file,
                 max_wait_ms=300.0) as srv:
        ours = _batched(srv)
    worst = 0
    for a, r in zip(ours, refs):
        assert a.dtype == r.dtype == np.int16 and a.shape == r.shape
        worst = max(worst, int(np.abs(a.astype(np.int32) - r).max()))
    print(f'server int16 max |port - jax| = {worst}')
    assert worst <= PCM_TOL


def test_single_request_and_batching(server):
    pcm = server.synthesize('Hello world.', timeout=300)
    assert pcm.dtype == np.int16 and pcm.ndim == 1 and len(pcm) > 0
    outs = _batched(server)
    assert all(o.dtype == np.int16 and len(o) > 0 for o in outs)


def test_alpha_scales_length(server):
    a = server.synthesize('A quick check of speed control.', alpha=1.0,
                          timeout=300)
    b = server.synthesize('A quick check of speed control.', alpha=1.5,
                          timeout=300)
    assert len(b) < len(a)


def test_article_paths(server):
    from forwardtacotron_tpu_torch.text.segmenter import split_sentences
    text = 'Hello there world. How is it going? All good here.'
    sentences = split_sentences(text)
    assert len(sentences) == 3
    gap = int(server.sample_rate * 100.0 / 1000.0)
    parts = [server.synthesize(s, timeout=600) for s in sentences]
    pcm = server.synthesize_long(text, timeout=600, gap_ms=100.0)
    assert len(pcm) == sum(len(p) for p in parts) + 2 * gap
    assert np.abs(pcm[len(parts[0]):len(parts[0]) + gap]).max() == 0
    server.batch_sizes.clear()
    chunks = list(server.synthesize_stream(text, timeout=600, gap_ms=100.0))
    assert len(chunks) == 5
    assert server.batch_sizes[0] == 1 and sum(server.batch_sizes) == 3
    for i, c in enumerate(chunks):
        assert c.dtype == np.int16
        if i % 2:
            assert len(c) == gap and np.abs(c).max() == 0
        else:
            assert len(c) == len(parts[i // 2])
    with pytest.raises(ValueError):
        server.synthesize_long('   ')


def test_stats_counters(server):
    before = server.stats()
    futs = [server.submit(f'stats request {i}.') for i in range(3)]
    for f in futs:
        f.result(timeout=600)
    after = server.stats()
    assert after['submitted'] - before['submitted'] == 3
    assert after['completed'] - before['completed'] == 3
    assert after['batches'] > before['batches']
    assert after['failed'] == before['failed']
    lat = after['latency_s']
    assert lat['window'] >= 3
    assert 0 < lat['p50'] <= lat['p95'] <= lat['p99'] <= lat['max']
    assert after['uptime_s'] > 0 and after['mean_batch_size'] >= 1
    # kernel #1 launches are counted on the card only
    assert after['birnn_paths'] == {}


def test_error_isolation(server):
    with pytest.raises(ValueError, match='empty token'):
        server.submit('').result(timeout=300)
    assert len(server.synthesize('Still alive.', timeout=300)) > 0
    with pytest.raises(ValueError, match='speaker'):
        server.submit('Hello.', speaker=1)


def test_http_front(server):
    import http.client
    import urllib.request
    from forwardtacotron_tpu_torch.serving import make_http_server
    httpd = make_http_server(server, '127.0.0.1', 0)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f'http://127.0.0.1:{port}'
    try:
        with urllib.request.urlopen(f'{base}/healthz', timeout=30) as r:
            assert r.status == 200 and r.read() == b'ok'
        req = urllib.request.Request(
            f'{base}/tts', data=json.dumps({'text': 'Served over http.',
                                            'amp': 1.1}).encode(),
            headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=300) as r:
            assert r.headers['Content-Type'] == 'audio/wav'
            body = r.read()
        assert body[:4] == b'RIFF'
        with wave.open(io.BytesIO(body)) as w:
            assert w.getframerate() == server.sample_rate
            assert w.getnframes() > 0
        conn = http.client.HTTPConnection('127.0.0.1', port, timeout=600)
        text = 'Stream me please. Another sentence here.'
        conn.request('POST', '/tts_stream', body=json.dumps({'text': text}),
                     headers={'Content-Type': 'application/json'})
        r = conn.getresponse()
        assert r.status == 200
        assert r.headers.get('Transfer-Encoding') == 'chunked'
        body = r.read()
        conn.close()
        assert body[:4] == b'RIFF' and body[4:8] == b'\xff\xff\xff\xff'
        pcm = np.frombuffer(body[44:], np.int16)
        assert len(pcm) == len(server.synthesize_long(text, timeout=600))
        conn = http.client.HTTPConnection('127.0.0.1', port, timeout=60)
        conn.request('POST', '/tts', body=b'{}')
        assert conn.getresponse().status == 400
        conn.close()
        with urllib.request.urlopen(f'{base}/stats', timeout=30) as r:
            assert r.headers['Content-Type'] == 'application/json'
            stats = json.loads(r.read())
        assert stats['completed'] >= 2 and stats['latency_s']['p95'] > 0
    finally:
        httpd.shutdown()
        httpd.server_close()


def _stall(srv):
    orig, gate = srv._run_batch, threading.Event()

    def slow(batch):
        gate.wait(timeout=60)
        orig(batch)
    srv._run_batch = slow
    return gate


def test_close_fails_requests_queued_behind_sentinel(tts_ckpt):
    from forwardtacotron_tpu_torch.serving import _Request
    srv = _server(tts_ckpt, max_wait_ms=200.0)
    f1 = srv.submit('Hello world.')
    srv._closed = True
    srv._q.put(None)
    orphan = _Request('Too late.', 1.0, 1.0, 1.0)
    srv._q.put(orphan)
    srv._worker.join(timeout=300)
    assert not srv._worker.is_alive()
    assert isinstance(f1.result(timeout=300), np.ndarray)
    with pytest.raises(RuntimeError, match='server closed'):
        orphan.future.result(timeout=5)
    with pytest.raises(RuntimeError, match='closed'):
        srv.submit('After close.')


def test_overload_sheds(tts_ckpt):
    from forwardtacotron_tpu_torch.serving import ServerOverloaded
    srv = _server(tts_ckpt, max_batch=2, max_wait_ms=50.0, max_queue=3)
    gate = _stall(srv)
    futures = [srv.submit('Hello one.'), srv.submit('Hello two.')]
    with pytest.raises(ServerOverloaded):
        for i in range(64):
            futures.append(srv.submit(f'Overflow {i}.'))
    gate.set()
    for f in futures:
        assert isinstance(f.result(timeout=300), np.ndarray)
    assert srv.stats()['shed'] >= 1
    srv.close()


def test_expired_requests_fail_fast(tts_ckpt):
    srv = _server(tts_ckpt, max_batch=2, max_wait_ms=10.0,
                  request_timeout_s=0.2)
    gate = _stall(srv)
    f = srv.submit('Hello world.')
    time.sleep(0.5)
    gate.set()
    with pytest.raises(TimeoutError):
        f.result(timeout=300)
    assert srv.stats()['expired'] == 1
    srv.close()


def test_warmup_and_refusals(tts_ckpt, monkeypatch):
    from forwardtacotron_tpu_torch.serving import TTSServer
    srv = _server(tts_ckpt, max_batch=3)
    out = srv.warmup(text_lens=[16, 32])
    assert out['programs'] == 2 * (2 + 1)    # B in {1, 4}: 2 decodes + voc
    assert out['seconds'] > 0
    srv.close()
    for kw, what in ((dict(fused=True),
                      'fused serving needs a neural vocoder'),
                     (dict(mesh=object()), 'mesh'),
                     (dict(vocoder='hifigan'), 'voc_checkpoint'),
                     (dict(vocoder='world'), 'unknown vocoder')):
        with pytest.raises(ValueError, match=what):
            _server(tts_ckpt, **kw)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        TTSServer(tts_ckpt)


def test_serve_forward_refuses_fused(tts_ckpt, hifigan_file):
    """`--fused` is refused with griffinlim (JAX's message) and accepted
    with a neural vocoder; `--fused_max_t` defaults to JAX's 1024."""
    from forwardtacotron_tpu_torch import serve_forward
    args = serve_forward._parser().parse_args(['wavernn'])
    assert args.device == 'cuda' and args.voc_checkpoint is None
    assert not args.fused and args.fused_max_t == 1024
    with pytest.raises(ValueError,
                       match='fused serving needs a neural vocoder'):
        serve_forward.main(['--checkpoint', tts_ckpt, '--device', 'cpu',
                            '--fused', 'griffinlim'])
    args = serve_forward._parser().parse_args(
        ['--fused', '--fused_max_t', '512', 'hifigan', '--voc_checkpoint',
         hifigan_file])
    assert args.fused and args.fused_max_t == 512
    with _server(tts_ckpt, vocoder='hifigan', voc_checkpoint=hifigan_file,
                 fused=args.fused, fused_max_t=args.fused_max_t) as srv:
        assert srv.fused and srv.fused_max_t == 512
