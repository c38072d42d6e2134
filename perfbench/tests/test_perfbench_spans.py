"""The readers of the port's spans on a synthetic store: the traced steps
are those below N = len(ctx['traced_shapes']), each metric is a mean over
them, a store without those N steps (or a program without the store)
gives None, and the launch roofline against a hand count at a small
shape."""
import pytest
import torch

from forwardtacotron_tpu_torch.utils import profiling
from perfbench.run import reader

MS = 1_000_000          # ns


def _span(name, step, start_ms, length_ms, **attrs):
    start = int(start_ms * MS)
    return profiling.Span(name, start, start + int(length_ms * MS), 1, 0,
                          None, step, attrs)


def _store(steps, extra=()):
    """One step's spans a step: data 1 + 2 ms, forward 10 + step, backward
    20, update 5; with `extra` appended."""
    out = []
    for k in steps:
        t = 1000.0 * k
        out += [_span('ftt.data.next', k, t, 1.0),
                _span('ftt.data.to_device', k, t + 1, 2.0),
                _span('ftt.train.step', k, t + 3, 40.0),
                _span('ftt.train.forward', k, t + 4, 10.0 + k),
                _span('ftt.train.backward', k, t + 15, 20.0),
                _span('ftt.train.update', k, t + 36, 5.0)]
    return out + list(extra)


@pytest.fixture
def store(monkeypatch):
    def use(spans):
        monkeypatch.setattr(profiling, 'spans', lambda: list(spans))
    return use


def _ctx(n, trace=None):
    return {'traced_shapes': [(16, 64, [60])] * n, 'trace': trace}


def test_means_over_the_traced_steps(store):
    # steps 0-2 are traced; 3-5 (the slice's second stretch) are not
    store(_store(range(6)))
    ctx = _ctx(3)
    assert reader('loader_wait_ms.train')(ctx) == pytest.approx(1.0)
    assert reader('h2d_copy_ms.train')(ctx) == pytest.approx(2.0)
    assert reader('forward_host_ms.train')(ctx) == pytest.approx(11.0)
    assert reader('backward_host_ms.train')(ctx) == pytest.approx(20.0)
    assert reader('update_host_ms.train')(ctx) == pytest.approx(5.0)


def test_micro_batches_sum_within_a_step(store):
    """Under grad_accum k the step's k forward spans are summed, then
    averaged over the steps."""
    extra = [_span('ftt.train.forward', 0, 20, 4.0),
             _span('ftt.train.forward', 1, 1020, 6.0)]
    store(_store(range(2), extra))
    assert reader('forward_host_ms.train')(_ctx(2)) == pytest.approx(
        (10 + 4 + 11 + 6) / 2)


NAMES = ['loader_wait_ms.train', 'h2d_copy_ms.train',
         'forward_host_ms.train', 'backward_host_ms.train',
         'update_host_ms.train', 'birnn_launch_roofline.train']


@pytest.mark.parametrize('name', NAMES)
def test_nothing_to_read_gives_none(store, monkeypatch, name):
    trace = {'kernel_s': {'void train_fwd_kernel<float>': 1e-3}}
    store(_store(range(2)))                       # 2 steps of 3 traced
    assert reader(name)(_ctx(3, trace)) is None
    store(_store([0, 2]))                         # a step missing
    assert reader(name)(_ctx(3, trace)) is None
    assert reader(name)(_ctx(0, trace)) is None   # no traced slice
    # a program without the store (the parent of this benchmark entry)
    monkeypatch.delattr(profiling, 'spans')
    assert reader(name)(_ctx(2, trace)) is None


def _launch(kind, step, dtype='float32'):
    return _span(f'ftt.kernels.birnn_train_{kind}', step, 1000 * step + 5,
                 0.1, path='batch_split', cell='gru', dtype=dtype, T=4, B=2,
                 S=2, H=8, lengths=torch.tensor([4, 2], dtype=torch.int32))


def test_launch_roofline_against_a_hand_count(store):
    """One GRU launch of #2 and one of #3 a step (T=4, B=2, S=2, H=8,
    lengths 4 and 2), both bound by bytes: #2 reads gi (4*2*2*24 floats)
    and writes y and the stash (4*2*2*8*6), #3 reads the stash and dy
    (4*2*2*8*(5+1)) and writes dgi and dgh (2*384); both read W_hh, b_hh
    and the lengths (2*24*8 + 2*24 + 2 words)."""
    small = (2 * 24 * 8 + 2 * 24 + 2) * 4
    fwd = (384 + 768) * 4 + small
    bwd = (640 + 128 + 768) * 4 + small
    per_step = (fwd + bwd) / 3.35e12
    assert 2.0 * 3 * 2 * 6 * 64 / 67e12 < fwd / 3.35e12   # bytes bind
    launches = [_launch(k, s) for s in range(3) for k in ('fwd', 'bwd')]
    store(_store(range(3), launches))
    trace = {'kernel_s': {'void train_fwd_bs_kernel<float, 1>': 2e-6,
                          'void train_bwd_bs_kernel<float, 1>': 3e-6,
                          'sgemm': 1.0}}
    # two traced steps: the third step's launches are left out
    got = reader('birnn_launch_roofline.train')(_ctx(2, trace))
    assert got == pytest.approx(100 * 2 * per_step / 5e-6)
    # a bfloat16 launch: the float32 arithmetic does not apply
    store(_store(range(2), launches[:3] + [_launch('bwd', 1, 'bfloat16')]))
    assert reader('birnn_launch_roofline.train')(_ctx(2, trace)) is None
    # no launch of the kernels in the traced steps (FastPitch)
    store(_store(range(2)))
    assert reader('birnn_launch_roofline.train')(_ctx(2, trace)) is None
