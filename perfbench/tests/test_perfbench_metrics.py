"""The metric arithmetic: the tail of all requests with misses as
infinite, step time and rates over the window, and each per-layer
reader on a context of known numbers."""
import math
import time

import numpy as np
import pytest

from perfbench.harness.common import percentile
from perfbench.harness.flops import PEAK_FLOPS, train_step_flops
from perfbench.harness.train_steps import TrainCell
from perfbench.run import reader
from perfbench.tests.conftest import small_config


def test_percentile_matches_numpy_on_finite_values():
    rng = np.random.default_rng(0)
    xs = rng.exponential(size=101).tolist()
    for q in (50, 90, 95, 99):
        assert percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_tail_counts_misses_as_infinite():
    answered = [0.1 + 0.001 * i for i in range(96)]
    assert math.isfinite(percentile(answered + [math.inf] * 4, 95))
    assert percentile(answered[:94] + [math.inf] * 6, 95) == math.inf
    assert percentile([math.inf], 95) == math.inf
    assert percentile([], 95) == math.inf


def test_step_time_is_the_window_over_its_steps():
    cell = TrainCell.__new__(TrainCell)
    cell.device = type('D', (), {'type': 'cpu'})()
    steps = []
    cell.step = lambda: (steps.append(1), time.sleep(0.02))
    out = cell.window(0.2)
    assert cell.window_steps == len(steps) >= 5
    assert out['train_step_ms'] == pytest.approx(
        1e3 * cell.window_s / len(steps))
    assert cell.window_s >= 0.2


def test_readers_on_known_numbers():
    cfg = small_config('ftw_ljspeech')
    trace = {'busy_s': 0.75, 'window_s': 1.0,
             'kernel_s': {'void train_fwd_kernel<float>': 0.2,
                          'void train_bwd_bs_kernel<float>': 0.2,
                          'sgemm': 0.3}}
    shapes = [(16, 64, [60, 50, 40, 64]), (32, 128, [100] * 4)]
    ctx = {'kind': 'forward_tacotron', 'cfg': cfg, 'batch_size': 4,
           'window_s': 2.0, 'window_steps': 2, 'shapes': shapes,
           'traced_shapes': shapes, 'data_wait_s': [0.001, 0.003],
           'peak': 'tf32', 'trace': trace, 'batch_sizes': [8, 4, 6],
           'max_batch': 8}
    assert reader('data_wait_ms.train')(ctx) == pytest.approx(2.0)
    assert reader('device_idle_share.train')(ctx) == pytest.approx(25.0)
    assert reader('device_idle_share.serve')(ctx) == pytest.approx(25.0)
    assert reader('batch_occupancy.serve')(ctx) == pytest.approx(75.0)
    flops = sum(train_step_flops(cfg, 4, tx, tm) for tx, tm, _ in shapes)
    assert reader('train_mfu')(ctx) == pytest.approx(
        100 * flops / (2.0 * PEAK_FLOPS['tf32']))
    from perfbench.harness.flops import forward_tacotron_kernel_bound_s
    m = cfg['forward_tacotron']['model']
    bound = sum(forward_tacotron_kernel_bound_s(m, 4, tx, tm, lens)
                for tx, tm, lens in shapes)
    assert reader('birnn_train_roofline.train')(ctx) == pytest.approx(
        100 * bound / 0.4)
    # nothing to read: no value, never 0
    assert reader('birnn_train_roofline.train')(dict(ctx, trace=None)) is None
    assert reader('birnn_train_roofline.train')(
        dict(ctx, kind='fast_pitch')) is None
    assert reader('batch_occupancy.serve')({'batch_sizes': []}) is None
    assert reader('device_idle_share.train')({'trace': None}) is None


class _Ev:
    def __init__(self, name, start, end, device='CUDA', annotation=False):
        self.name, self.device_type = name, f'DeviceType.{device}'
        self.time_range = type('R', (), {'start': start, 'end': end})()
        self.is_user_annotation = annotation


def test_trace_summary_unions_kernels_and_labels_gaps():
    from perfbench.harness.trace import summarize
    events = [_Ev('k1', 0, 100), _Ev('k2', 50, 150), _Ev('k1', 300, 400),
              _Ev('perfbench.train_step', 0, 400),
              _Ev('Optimizer.step#Adam.step', 0, 400, annotation=True),
              _Ev('perfbench.train_step', 0, 400, device='CPU'),
              _Ev('aten::item', 160, 290, device='CPU')]
    prof = type('P', (), {'events': lambda self: events})()
    out = summarize(prof, wall_s=400e-6)
    assert out['busy_s'] == pytest.approx(250e-6)
    assert out['kernel_s'] == {'k1': pytest.approx(200e-6),
                               'k2': pytest.approx(100e-6)}
    assert out['idle_gaps'] == [['aten::item', pytest.approx(150e-6)]]
    assert out['device_ops'][0][0] == 'k1'
