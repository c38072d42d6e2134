"""The port's spans (`utils/profiling.py:annotate`) on the CPU: nothing is
recorded without a recording profiler; under one, a training step of a
tiny ForwardTacotron and of a tiny FastPitch records `ftt.train.step`
with its forward, backward and update in order, the data feed records its
wait and its copy under the step that follows, every stored span has a
profiler event of its name in the same order, a second thread's spans
carry the step and no parent of another thread, and threads recording at
once lose no span."""
import collections
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from forwardtacotron_tpu_torch.utils import profiling

FT_TINY = {
    'embed_dims': 16, 'series_embed_dims': 8, 'durpred_conv_dims': 12,
    'durpred_rnn_dims': 4, 'pitch_conv_dims': 12, 'pitch_rnn_dims': 6,
    'energy_conv_dims': 12, 'energy_rnn_dims': 3, 'rnn_dims': 12,
    'prenet_dims': 8, 'prenet_k': 3, 'postnet_dims': 8, 'postnet_k': 2,
}
FP_TINY = {
    'durpred_d_model': 8, 'durpred_n_heads': 2, 'durpred_layers': 1,
    'durpred_d_fft': 8, 'pitch_d_model': 8, 'pitch_n_heads': 2,
    'pitch_layers': 1, 'pitch_d_fft': 8, 'energy_d_model': 8,
    'energy_n_heads': 2, 'energy_layers': 1, 'energy_d_fft': 8,
    'd_model': 16, 'prenet_layers': 1, 'prenet_heads': 2, 'prenet_fft': 16,
    'postnet_layers': 1, 'postnet_heads': 2, 'postnet_fft': 16,
}
PHASES = ['ftt.train.forward', 'ftt.train.backward', 'ftt.train.update']


@pytest.fixture(autouse=True)
def store(monkeypatch):
    """An empty span store and step count for each test."""
    monkeypatch.setattr(profiling, '_store', collections.deque(
        maxlen=profiling.STORE_SPANS))
    monkeypatch.setattr(profiling, '_steps', 0)
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _setup(kind):
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.train import common as tc
    cfg = default_config()
    cfg['tts_model'] = kind
    if kind == 'fast_pitch':
        from forwardtacotron_tpu_torch.models.fast_pitch import FastPitch
        cfg['fast_pitch']['model'].update(FP_TINY)
        model = FastPitch.from_config(cfg)
    else:
        from forwardtacotron_tpu_torch.models.forward_tacotron import (
            ForwardTacotron)
        cfg['forward_tacotron']['model'].update(FT_TINY)
        model = ForwardTacotron.from_config(cfg)
    torch.manual_seed(0)
    train_cfg = dict(cfg[kind]['training'], pitch_zoneout=0.0,
                     energy_zoneout=0.0)
    return model, tc.make_optimizer(model, 1e-4), train_cfg, \
        cfg['dsp']['num_mels']


def _raw_batch(n_mels, seed):
    """A host batch of three items of 5-8 tokens, as the loader gives."""
    rng = np.random.RandomState(seed)
    x_len = np.array([8, 6, 5])
    x = np.zeros((3, 8), np.int64)
    dur = np.zeros((3, 8), np.float32)
    for i, n in enumerate(x_len):
        x[i, :n] = rng.randint(1, 30, n)
        dur[i, :n] = rng.randint(1, 3, n)
    mel_len = dur.sum(axis=1).astype(np.int64)
    mel = np.full((3, 16, n_mels), -11.5129, np.float32)
    for i, m in enumerate(mel_len):
        mel[i, :m] = rng.randn(m, n_mels) * 2 - 5
    return {'x': x, 'x_len': x_len, 'mel': mel, 'mel_len': mel_len,
            'dur': dur, 'pitch': rng.randn(3, 8).astype(np.float32),
            'energy': rng.randn(3, 8).astype(np.float32)}


def _steps(kind, n):
    """`n` steps as a trainer runs them: the next batch from `Prefetcher`,
    `batch_to_device`, `train_step`."""
    from forwardtacotron_tpu_torch.data.dataset import Prefetcher
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.forward_trainer import (
        batch_to_device)
    model, opt, train_cfg, n_mels = _setup(kind)
    feed = iter(Prefetcher([_raw_batch(n_mels, s) for s in range(n)]))
    for i in range(n):
        batch = batch_to_device(next(feed), 'cpu')
        tc.train_step(model, opt, batch, torch.Generator().manual_seed(i),
                      train_cfg)


@pytest.mark.parametrize('kind', ['forward_tacotron', 'fast_pitch'])
def test_no_profiler_no_spans(kind, monkeypatch):
    """Without a recording profiler a step stores nothing and enters no
    `record_function`: `annotate` hands out one shared do-nothing
    context."""
    def refused(*_):
        raise AssertionError('record_function entered with tracing off')
    monkeypatch.setattr(torch.profiler, 'record_function', refused)
    _steps(kind, 2)
    assert profiling.spans() == [] and profiling._steps == 0
    assert profiling.annotate('ftt.x') is profiling.annotate('ftt.y', a=1)


@pytest.mark.parametrize('kind', ['forward_tacotron', 'fast_pitch'])
def test_step_records_its_phases_and_its_data(kind):
    with profile(activities=[ProfilerActivity.CPU]):
        _steps(kind, 3)
    spans = profiling.spans()
    steps = [s for s in spans if s.name == 'ftt.train.step']
    assert [s.step for s in steps] == [0, 1, 2]
    assert len({s.thread for s in spans}) == 1
    for root in steps:
        children = sorted((s for s in spans if s.parent == root.id),
                          key=lambda s: s.start_ns)
        assert [s.name for s in children] == PHASES
        assert all(s.step == root.step for s in children)
        assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
                   for s in children)
        # the batch's wait and copy come before the step and carry its
        # number, at the top level
        data = [s for s in spans if s.name.startswith('ftt.data.')
                and s.step == root.step]
        assert sorted(s.name for s in data) == ['ftt.data.next',
                                                'ftt.data.to_device']
        assert all(s.parent is None and s.end_ns <= root.start_ns
                   for s in data)
    assert all(s.name.startswith('ftt.') for s in spans)


def test_every_span_has_its_profiler_event():
    """The spans share the profiler's clock: each stored span has an event
    of its name in the profiler's trace, as many and in the same order of
    start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _steps('forward_tacotron', 2)
    spans = sorted(profiling.spans(), key=lambda s: s.start_ns)
    events = sorted((e for e in prof.events() if e.name.startswith('ftt.')),
                    key=lambda e: e.time_range.start)
    assert len(spans) == 2 * 6
    assert [e.name for e in events] == [s.name for s in spans]


def test_second_thread_spans_carry_the_step():
    """A span on another thread takes the step of the main thread's
    count and never a parent from another thread."""
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate('ftt.train.step'):
            pass
        with profiling.annotate('ftt.train.step'):
            gate = threading.Event()

            def worker():
                with profiling.annotate('ftt.data.next', lane=1):
                    with profiling.annotate('ftt.data.to_device'):
                        pass
                gate.set()
            t = threading.Thread(target=worker)
            t.start()
            gate.wait(10)
            t.join(10)
            assert not t.is_alive()
    spans = profiling.spans()
    outer, = [s for s in spans if s.name == 'ftt.data.next']
    inner, = [s for s in spans if s.name == 'ftt.data.to_device']
    main_step = [s for s in spans if s.name == 'ftt.train.step'][1]
    assert outer.step == inner.step == main_step.step == 1
    assert outer.parent is None and inner.parent == outer.id
    assert outer.thread == inner.thread != main_step.thread
    assert outer.attrs == {'lane': 1}


def test_threads_lose_no_span():
    """Sixteen threads record spans at once, every fourth a step, with the
    interpreter switching threads every microsecond: every span is stored
    and every step counted, and each thread's nesting is its own."""
    import sys
    n_threads, n_spans = 16, 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            def worker():
                for i in range(n_spans):
                    name = 'ftt.train.step' if i % 4 == 0 else 'ftt.x'
                    with profiling.annotate(name):
                        with profiling.annotate('ftt.y'):
                            pass
            threads = [threading.Thread(target=worker)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    spans = profiling.spans()
    assert len(spans) == 2 * n_threads * n_spans
    assert profiling._steps == n_threads * n_spans // 4
    by_id = {s.id: s for s in spans}
    inner = [s for s in spans if s.name == 'ftt.y']
    assert all(by_id[s.parent].thread == s.thread for s in inner)
