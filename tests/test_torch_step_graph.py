"""The student step's CUDA graphs (`train/common.py:StepGraphs`).

On the CPU: which steps run eagerly (each case of `train_step`'s list, on
stand-ins for the card's tensors, and a whole CPU step, whose span says
`eager`), the helpers the graph path adds (the learning rate held in a
tensor, the plain optimizer state a checkpoint writes, the spans of a
replay's launches), and the reader of `step_graph_share.train` on
made-up spans.

On the card (marker `cuda`; no JAX here): graphed against eager for both
models from one seed, over 7 steps in three shapes in shuffled order,
parameters, Adam's moments, BatchNorm's statistics and the metrics, with
the options too; the generators after a capture; a learning rate set
between replays; the spans of a profiled replay; kernels #2/#3 on every
path captured alone; the benchmark's harness at a small size. The
graphed run is held, tensor by tensor and metric by metric, to what
two eager runs of the same steps with the same (capturable) Adam differ
by, measured in the test under deterministic algorithms, twice that:
bit for bit where the eager runs agree (`_gaps`, `_outside`).
"""
import collections
import contextlib
import types

import numpy as np
import pytest
import torch

from forwardtacotron_tpu_torch.config import default_config
from forwardtacotron_tpu_torch.parallel import data_parallel
from forwardtacotron_tpu_torch.train import common as tc
from forwardtacotron_tpu_torch.utils import profiling
from forwardtacotron_tpu_torch.utils.checkpoints import optimizer_state

SMALL = {
    'forward_tacotron': dict(
        embed_dims=32, series_embed_dims=16, durpred_conv_dims=32,
        durpred_rnn_dims=16, pitch_conv_dims=32, pitch_rnn_dims=24,
        energy_conv_dims=32, energy_rnn_dims=16, prenet_dims=32,
        prenet_k=4, rnn_dims=64, postnet_dims=32, postnet_k=3),
    'fast_pitch': dict(
        durpred_d_model=32, durpred_d_fft=32, durpred_layers=2,
        pitch_d_model=32, pitch_d_fft=32, pitch_layers=2,
        energy_d_model=32, energy_d_fft=32, energy_layers=2, d_model=32,
        prenet_layers=2, prenet_fft=64, postnet_layers=2, postnet_fft=64),
}
# (Tx, Tm) of the three buckets
SHAPES = [(12, 48), (16, 64), (20, 80)]
ORDER = [1, 0, 2, 0, 1, 2, 1]      # 7 steps over the three, shuffled


@pytest.fixture(autouse=True)
def _store(monkeypatch):
    """A span store and step count of this test's own."""
    monkeypatch.setattr(profiling, '_store', collections.deque(
        maxlen=profiling.STORE_SPANS))
    monkeypatch.setattr(profiling, '_steps', 0)


def _cfg(kind, **training):
    cfg = default_config()
    cfg['tts_model'] = kind
    cfg[kind]['model'].update(SMALL[kind])
    train_cfg = dict(cfg[kind]['training'], pitch_zoneout=0.2,
                     energy_zoneout=0.1, **training)
    return cfg, train_cfg


def _model(kind, cfg, device, seed=0):
    from forwardtacotron_tpu_torch.utils.checkpoints import init_tts_model
    torch.manual_seed(seed)
    return init_tts_model(cfg).to(device)


def _batch(i, shape, device, B=4):
    """A batch of `shape` (Tx, Tm), item lengths drawn from `i`."""
    tx, tm = SHAPES[shape]
    rng = np.random.RandomState(100 + i)
    x_len = rng.randint(tx // 2, tx + 1, B)
    x_len[0] = tx
    x = np.zeros((B, tx), np.int64)
    dur = np.zeros((B, tx), np.float32)
    for b, n in enumerate(x_len):
        x[b, :n] = rng.randint(1, 40, n)
        dur[b, :n] = rng.randint(1, max(2, (tm - 2) // n), n)
    mel_len = dur.sum(1).astype(np.int64)
    mel = rng.randn(B, tm, 80).astype(np.float32)
    mel[np.arange(tm)[None, :] >= mel_len[:, None]] = -11.5129
    out = {'x': x, 'x_len': x_len.astype(np.int64), 'mel': mel,
           'mel_len': mel_len, 'dur': dur,
           'pitch': rng.randn(B, tx).astype(np.float32),
           'energy': rng.randn(B, tx).astype(np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def _span(name, step, **attrs):
    return profiling.Span(name, 1000 * step, 1000 * step + 10, 1, step,
                          None, step, attrs)


# ----------------------------------------------------------- on the CPU
class _Fake:
    """A stand-in with a device (a parameter or generator on the card)."""

    def __init__(self, device='cuda:0'):
        self.device = torch.device(device)


class _FakeModel:
    def __init__(self, devices=('cuda:0',)):
        self.params = [_Fake(d) for d in devices]

    def parameters(self):
        return iter(self.params)


def _eager_case(monkeypatch, case):
    """`_graph_device`'s answer where everything is as the graph path
    wants it (a card, parameters and generator on cuda:0, torch's Adam,
    no mesh) but `case`."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    model, gen = _FakeModel(), _Fake()
    optimizer = torch.optim.Adam([torch.zeros(2, requires_grad=True)])
    batch, train_cfg = {}, {'remat': False}
    if case == 'no card':
        monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    elif case == 'remat':
        train_cfg['remat'] = True
    elif case == 'no generator':
        gen = None
    elif case == 'generator on the host':
        gen = torch.Generator()
    elif case == 'generator on another card':
        gen = _Fake('cuda:1')
    elif case == 'process group of two ranks':
        monkeypatch.setattr(torch.distributed, 'is_initialized',
                            lambda: True)
        monkeypatch.setattr(torch.distributed, 'get_world_size', lambda: 2)
    elif case == 'model axis':
        monkeypatch.setattr(tc, 'shards_of', lambda m: object())
    elif case == 'not Adam':
        optimizer = torch.optim.SGD([torch.zeros(2, requires_grad=True)],
                                    lr=0.1)
    elif case == 'fused Adam':
        optimizer.param_groups[0]['fused'] = True
    elif case == 'parameters on two cards':
        model = _FakeModel(('cuda:0', 'cuda:1'))
    elif case == 'parameters on the host':
        model = _FakeModel(('cpu',))
    elif case == 'batch on the host':
        batch = {'x': torch.zeros(2)}
    elif case == 'batch value not a tensor':
        batch = {'item_id': ['a', 'b']}
    if case == 'one-rank mesh':
        with data_parallel(types.SimpleNamespace(group=None, size=1)):
            return tc._graph_device(model, optimizer, batch, gen, train_cfg,
                                    None)
    return tc._graph_device(model, optimizer, batch, gen, train_cfg, None)


EAGER_CASES = ['no card', 'remat', 'no generator', 'generator on the host',
               'generator on another card', 'one-rank mesh',
               'process group of two ranks', 'model axis', 'not Adam',
               'fused Adam', 'parameters on two cards',
               'parameters on the host', 'batch on the host',
               'batch value not a tensor']


def test_the_graph_path_engages_where_nothing_forbids_it(monkeypatch):
    assert _eager_case(monkeypatch, None) == torch.device('cuda:0')


@pytest.mark.parametrize('case', EAGER_CASES)
def test_each_eager_case_runs_eagerly(monkeypatch, case):
    assert _eager_case(monkeypatch, case) is None


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize('kind', ['forward_tacotron', 'fast_pitch'])
def test_a_cpu_step_runs_eagerly_and_says_so(one_thread, kind):
    """A CPU step takes the eager path (its span's `path`), records its
    forward, backward and update, and computes what `_eager_step`
    computes from the same state."""
    cfg, train_cfg = _cfg(kind)
    runs = []
    for step in (tc.train_step, tc._eager_step):
        model = _model(kind, cfg, 'cpu')
        opt = tc.make_optimizer(model, lr=1e-3)
        torch.manual_seed(5)
        gen = torch.Generator().manual_seed(7)
        with torch.profiler.profile():
            metrics = step(model, opt, _batch(0, 0, 'cpu'), gen, train_cfg)
        runs.append((metrics, [p.detach().clone()
                               for p in model.parameters()]))
    names = [s.name for s in profiling.spans()]
    steps = [s for s in profiling.spans() if s.name == 'ftt.train.step']
    assert [s.attrs for s in steps] == [{'path': 'eager'}]
    assert {'ftt.train.forward', 'ftt.train.backward',
            'ftt.train.update'} <= set(names)
    (m1, p1), (m2, p2) = runs
    assert {k: float(v) for k, v in m1.items()} == \
        {k: float(v) for k, v in m2.items()}
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    assert not tc._GRAPHS


def test_a_learning_rate_in_a_tensor_is_filled_in_place():
    p = torch.zeros(3, requires_grad=True)
    opt = torch.optim.Adam([p], lr=1e-3)
    tc.set_learning_rate(opt, 2e-4)
    assert opt.param_groups[0]['lr'] == 2e-4
    held = torch.tensor(1e-3)
    opt.param_groups[0]['lr'] = held
    tc.set_learning_rate(opt, 5e-5)
    assert opt.param_groups[0]['lr'] is held
    assert float(held) == pytest.approx(5e-5)


def test_adam_is_made_capturable_as_its_first_step_would_make_it():
    """Every group capturable with its rate in a float32 tensor; the
    state of each trained parameter made as Adam's first step makes it
    (an existing one kept), none for the others."""
    fresh, seen, idle = (torch.randn(3, requires_grad=True)
                         for _ in range(3))
    opt = torch.optim.Adam([fresh, seen, idle], lr=2e-4, amsgrad=True)
    seen.grad = torch.ones(3)
    opt.step()
    before = opt.state[seen]['exp_avg'].clone()
    tc._make_capturable(opt, [fresh, seen], torch.device('cpu'))
    group = opt.param_groups[0]
    assert group['capturable'] and group['lr'].dtype == torch.float32
    assert float(group['lr']) == pytest.approx(2e-4)
    state = opt.state[fresh]
    assert set(state) == {'step', 'exp_avg', 'exp_avg_sq', 'max_exp_avg_sq'}
    assert state['step'].shape == () and float(state['step']) == 0.0
    assert all(not state[k].any() for k in state)
    assert torch.equal(opt.state[seen]['exp_avg'], before)
    assert float(opt.state[seen]['step']) == 1.0
    assert idle not in opt.state


def test_a_checkpoint_holds_a_plain_adam_state():
    """The graph path's capturable Adam (lr in a tensor, step counts as
    float32 tensors; on the card in a real run) is written as a plain
    Adam's state, which a fresh Adam loads and steps with."""
    params = [torch.randn(3, requires_grad=True),
              torch.randn(2, requires_grad=True)]
    opt = torch.optim.Adam(params, lr=1e-3)
    for p in params:
        p.grad = torch.ones_like(p)
    opt.step()
    plain = opt.state_dict()
    assert optimizer_state(opt) is not None
    assert optimizer_state(opt)['param_groups'] == plain['param_groups']
    group = opt.param_groups[0]
    group['capturable'], group['lr'] = True, torch.tensor(1e-3)
    for p in params:
        opt.state[p]['step'] = opt.state[p]['step'].clone()
    got = optimizer_state(opt)
    (g,), (want,) = got['param_groups'], plain['param_groups']
    assert dict(g, lr=None) == dict(want, lr=None)
    assert type(g['lr']) is float and g['lr'] == pytest.approx(1e-3)
    for k, s in got['state'].items():
        assert s['step'].device.type == 'cpu'
        assert s['step'].dtype == torch.float32 and float(s['step']) == 1.0
        assert torch.equal(s['exp_avg'], plain['state'][k]['exp_avg'])
    fresh = torch.optim.Adam([p.detach().clone().requires_grad_()
                              for p in params], lr=0.5)
    fresh.load_state_dict(got)
    assert not fresh.param_groups[0]['capturable']
    assert fresh.param_groups[0]['lr'] == pytest.approx(1e-3)
    for p in fresh.param_groups[0]['params']:
        p.grad = torch.ones_like(p)
    fresh.step()


def test_launch_spans_are_listed_while_a_graph_is_captured():
    """Inside `captured_launches` every launch span is listed with its
    attributes, profiler or not; outside it, and for other spans, not."""
    with profiling.captured_launches() as launches:
        with profiling.annotate('ftt.kernels.birnn_train_fwd', T=3):
            pass
        with profiling.annotate('ftt.train.forward'):
            pass
    with profiling.annotate('ftt.kernels.birnn_train_bwd', T=4):
        pass
    assert launches == [('ftt.kernels.birnn_train_fwd', {'T': 3})]
    assert profiling.spans() == []


@pytest.mark.parametrize('traced', [True, False])
def test_replayed_launches_join_the_open_step(traced):
    """While a profiler records, each launch a replay ran is stored as a
    span of the step open on the thread, with its capture's attributes
    and a copy of `lengths` as the replay left it; without a profiler,
    nothing is stored."""
    lengths = torch.tensor([5, 3], dtype=torch.int32)
    launches = [(name, {'T': 2, 'lengths': lengths})
                for name in profiling.LAUNCH_SPANS]
    with torch.profiler.profile() if traced else contextlib.nullcontext():
        with profiling.annotate('ftt.train.step', path='replay'):
            profiling.replayed(launches, 5, 9)
        lengths.fill_(1)                 # the next replay's
        with profiling.annotate('ftt.train.step', path='replay'):
            pass
    if not traced:
        assert profiling.spans() == []
        return
    fwd, bwd, step, _ = profiling.spans()
    for span, (name, _) in zip((fwd, bwd), launches):
        assert (span.name, span.start_ns, span.end_ns) == (name, 5, 9)
        assert span.parent == step.id and span.step == step.step == 0
        assert span.attrs['T'] == 2
        assert span.attrs['lengths'].tolist() == [5, 3]


@pytest.mark.parametrize('paths,want', [
    (['replay'] * 4, 100.0), (['capture', 'replay', 'eager', 'replay'], 50.0),
    (['eager'] * 4, 0.0)])
def test_step_graph_share_reads_the_replays(monkeypatch, paths, want):
    from perfbench.run import reader
    spans = [_span('ftt.train.step', i, path=p) for i, p in enumerate(paths)]
    spans.append(_span('ftt.train.step', 4, path='eager'))  # not traced
    monkeypatch.setattr(profiling, 'spans', lambda: spans)
    ctx = {'traced_shapes': [(16, 64, [60])] * 4}
    assert reader('step_graph_share.train')(ctx) == pytest.approx(want)


def test_step_graph_share_without_steps_or_paths_gives_none(monkeypatch):
    from perfbench.run import reader
    read = reader('step_graph_share.train')
    ctx = {'traced_shapes': [(16, 64, [60])] * 2}
    monkeypatch.setattr(profiling, 'spans', lambda: [])
    assert read(ctx) is None
    # a program whose steps carry no path (before the step graphs)
    monkeypatch.setattr(profiling, 'spans', lambda: [
        _span('ftt.train.step', i) for i in range(2)])
    assert read(ctx) is None
    assert read({'traced_shapes': []}) is None


# ----------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (kernels are built with nvcc)')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda:0')


def _capturable_adam(model, lr, device):
    return torch.optim.Adam(model.parameters(), capturable=True,
                            lr=torch.tensor(lr, device=device))


def _state(model, opt, ema):
    out = {f'p.{n}': p.detach().clone() for n, p in model.named_parameters()}
    out.update({f'b.{n}': b.detach().clone().float()
                for n, b in model.named_buffers()})
    for n, p in model.named_parameters():
        for k in ('exp_avg', 'exp_avg_sq'):
            out[f'{k}.{n}'] = opt.state[p][k].detach().clone()
    if ema is not None:
        out.update({f'ema.{n}': t.clone() for n, t in ema.params.items()})
    return out


def _run(kind, device, step, adam='plain', order=ORDER, train_cfg_opts=None,
         lr=1e-3):
    """`order`'s steps from one seed with `step` (train_step or
    _eager_step) and Adam `adam` ('plain' or 'capturable'); (state after,
    the metrics of each step)."""
    cfg, train_cfg = _cfg(kind, **(train_cfg_opts or {}))
    model = _model(kind, cfg, device)
    opt = tc.make_optimizer(model, lr) if adam == 'plain' \
        else _capturable_adam(model, lr, device)
    ema = tc.make_ema(model, train_cfg)
    torch.cuda.manual_seed(11)
    metrics = []
    for i, shape in enumerate(order):
        gen = torch.Generator(device=device).manual_seed(1000 + i)
        m = step(model, opt, _batch(i, shape, device), gen, train_cfg, ema)
        metrics.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    return _state(model, opt, ema), metrics, (model, opt, ema)


def _rel(a, b):
    a, b = a.float(), b.float()
    norm = float(b.norm())
    return float((a - b).norm()) / norm if norm > 0 else float(a.norm())


GROUPS = (('params', ('p.', 'ema.')), ('moments', ('exp_avg',)),
          ('buffers', ('b.',)), ('metrics', ('metric',)))


def _gaps(a, b):
    """How far two runs lie apart, tensor by tensor: the relative L2
    distance of each parameter, EMA weight, Adam moment and buffer, and the
    relative difference of each metric of each step."""
    (sa, ma), (sb, mb) = a[:2], b[:2]
    assert sa.keys() == sb.keys()
    out = {k: _rel(sa[k], sb[k]) for k in sb}
    out.update({f'metric{i}.{k}': abs(x[k] - y[k]) / max(abs(y[k]), 1e-30)
                for i, (x, y) in enumerate(zip(ma, mb)) for k in y})
    return out


def _graphed_against_eager(kind, cuda, **opts):
    """Two eager runs of the same steps with the capturable Adam that the
    graph path converts to, and the graphed run: (the graphed run's gap to
    the first eager run, the second eager run's, tensor by tensor; the
    graphed run)."""
    eager, again = (_run(kind, cuda, tc._eager_step, 'capturable',
                         train_cfg_opts=opts) for _ in range(2))
    graphed = _run(kind, cuda, tc.train_step, train_cfg_opts=opts)
    got, tol = _gaps(graphed, eager), _gaps(again, eager)
    for group, prefixes in GROUPS:
        keys = [k for k in got if k.startswith(prefixes)]
        print(f'{kind} {opts} {group}: graphed against eager median '
              f'{np.median([got[k] for k in keys]):.3g} max '
              f'{max(got[k] for k in keys):.3g}; eager against eager median '
              f'{np.median([tol[k] for k in keys]):.3g} max '
              f'{max(tol[k] for k in keys):.3g}')
    return got, tol, graphed


def _outside(got, tol):
    """The tensors and metrics whose graphed gap exceeds twice the eager
    runs' own: under deterministic algorithms those agree bit for bit, so
    this is every tensor or metric the graph computes otherwise."""
    return {k: (got[k], tol[k]) for k in tol if got[k] > 2 * tol[k]}


@pytest.fixture
def deterministic():
    """cuDNN's and torch's deterministic algorithms, restored after: two
    eager runs of the same steps then agree bit for bit, and what the
    graphed run differs by is the graph's (under the default algorithms
    every run differs from every other, and one pair's gap in a tensor
    does not bound another pair's)."""
    saved = (torch.backends.cudnn.deterministic,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.backends.cudnn.deterministic = saved[0]
    torch.use_deterministic_algorithms(saved[1], warn_only=saved[2])


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['forward_tacotron', 'fast_pitch'])
def test_graphed_steps_match_eager(cuda, deterministic, kind):
    """Seven steps in three shapes, shuffled: three captures, four
    replays; the parameters, Adam's moments, the buffers and the metrics
    as the eager step's within what two eager runs differ by."""
    got, tol, graphed = _graphed_against_eager(kind, cuda)
    assert not _outside(got, tol)
    model, opt, _ = graphed[2]
    graphs = tc._GRAPHS[opt]
    assert len(graphs.graphs) == 3
    assert opt.param_groups[0]['capturable']
    for p in model.parameters():
        assert p.grad is not None


@pytest.mark.cuda
@pytest.mark.parametrize('opts', [{'grad_accum': 2}, {'precision': 'bf16'},
                                  {'ema_decay': 0.9}])
def test_graphed_options_match_eager(cuda, deterministic, opts):
    got, tol, _ = _graphed_against_eager('forward_tacotron', cuda, **opts)
    assert not _outside(got, tol)


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['forward_tacotron', 'fast_pitch'])
def test_a_capture_leaves_statistics_and_generators_as_eager(cuda, kind):
    """One step (a capture, then its replay) against one eager step: the
    BatchNorm statistics (and every buffer) as eager's, the global CUDA
    generator and the step's generator in the same state."""
    cfg, train_cfg = _cfg(kind)
    out = []
    for step in (tc._eager_step, tc.train_step):
        model = _model(kind, cfg, cuda)
        opt = _capturable_adam(model, 1e-3, cuda)
        torch.cuda.manual_seed(3)
        gen = torch.Generator(device=cuda).manual_seed(4)
        step(model, opt, _batch(0, 1, cuda), gen, train_cfg)
        torch.cuda.synchronize()
        out.append(([b.clone() for b in model.buffers()],
                    torch.cuda.get_rng_state(cuda), gen.get_state()))
    (b1, rng1, g1), (b2, rng2, g2) = out
    assert torch.equal(rng1, rng2) and torch.equal(g1, g2)
    for x, y in zip(b1, b2):
        assert float((x.float() - y.float()).abs().max()) <= \
            1e-5 * max(float(x.float().abs().max()), 1.0)


@pytest.mark.cuda
def test_a_learning_rate_holds_at_the_next_replay(cuda):
    cfg, train_cfg = _cfg('forward_tacotron')
    model = _model('forward_tacotron', cfg, cuda)
    opt = tc.make_optimizer(model, 1e-3)

    def step(i):
        gen = torch.Generator(device=cuda).manual_seed(i)
        tc.train_step(model, opt, _batch(i, 0, cuda), gen, train_cfg)
        torch.cuda.synchronize()
        return [p.detach().clone() for p in model.parameters()]
    before = step(0)
    tc.set_learning_rate(opt, 0.0)
    held = step(1)
    assert all(torch.equal(a, b) for a, b in zip(before, held))
    tc.set_learning_rate(opt, 1e-3)
    moved = step(2)
    assert any(not torch.equal(a, b) for a, b in zip(held, moved))
    assert len(tc._GRAPHS[opt].graphs) == 1


@pytest.mark.cuda
def test_a_profiled_replay_records_its_path_and_launches(cuda):
    """Under the profiler a replay records `ftt.train.step` with path
    'replay', no forward, backward or update span, and one span a launch
    the graph holds, inside the step, with this step's own lengths; the
    profiler sees the same launches by kernel name. The wrappers'
    counters count their calls: twice a recurrence at the capture (the
    warm-up, then the capture), none at a replay."""
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        train_backward, train_forward)

    def calls():
        return train_forward.launches, train_backward.launches
    cfg, train_cfg = _cfg('forward_tacotron')
    model = _model('forward_tacotron', cfg, cuda)
    opt = tc.make_optimizer(model, 1e-3)
    before = calls()
    for i in (0, 1):                       # capture, then replay
        tc.train_step(model, opt, _batch(i, 2, cuda),
                      torch.Generator(device=cuda).manual_seed(i), train_cfg)
    torch.cuda.synchronize()
    assert profiling.spans() == []
    captured = (before[0] + 12, before[1] + 12)
    assert calls() == captured
    batch = _batch(7, 2, cuda)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tc.train_step(model, opt, batch,
                      torch.Generator(device=cuda).manual_seed(7), train_cfg)
        torch.cuda.synchronize()
    spans = profiling.spans()
    (step,) = [s for s in spans if s.name == 'ftt.train.step']
    assert step.attrs == {'path': 'replay'}
    assert not {'ftt.train.forward', 'ftt.train.backward',
                'ftt.train.update'} & {s.name for s in spans}
    launches = [s for s in spans if s.name in profiling.LAUNCH_SPANS]
    assert len(launches) == 12
    for s in launches:
        assert s.parent == step.id and s.step == step.step
        assert step.start_ns <= s.start_ns <= s.end_ns <= step.end_ns
    (lstm,) = [s for s in launches if s.attrs['cell'] == 'lstm'
               and s.name.endswith('_fwd')]
    assert torch.equal(lstm.attrs['lengths'].cpu(),
                       batch['mel_len'].int().cpu())
    recorded = collections.Counter(
        f'{s.name.split(".")[-1]}_{s.attrs["path"]}' for s in launches)
    counted = profiling.kernel_launches(prof)
    assert {k: v for k, v in counted.items() if 'train' in k} == {
        k: recorded[k] for k in counted if 'train' in k}
    assert calls() == captured


@pytest.mark.cuda
@pytest.mark.parametrize('cell,H', [('lstm', 512), ('gru', 256),
                                    ('gru', 64)])
def test_training_kernels_capture_and_replay(cuda, cell, H):
    """Kernels #2 and #3 at B=32, two streams, float32, captured in one
    CUDA graph and replayed on new inputs: each path the plans give at
    these shapes (the decoder's cooperative pair at H=512, the cluster
    forward at 256, batch-split at 64) equals its eager launch."""
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        train_backward, train_forward)
    T, B, S = 60, 32, 2
    ng = 4 if cell == 'lstm' else 3
    g = torch.Generator().manual_seed(H)

    def inputs():
        gi = torch.randn((T, B, S, ng * H), generator=g) * 0.5
        w = (torch.rand((S, ng * H, H), generator=g) * 2 - 1) / H ** 0.5
        b = torch.rand((S, ng * H), generator=g) * 0.1
        lengths = torch.randint(T // 2, T + 1, (B,), generator=g,
                                dtype=torch.int32)
        dy = torch.randn((T, B, S, H), generator=g)
        return [t.to(cuda).contiguous() for t in (gi, w, b, lengths, dy)]

    def run(gi, w, b, lengths, dy):
        y, stash = train_forward(cell, gi, w, b, lengths)
        return (y, stash) + tuple(train_backward(cell, stash, dy, w,
                                                 lengths))
    static = inputs()
    run(*static)                                   # build, warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with profiling.captured_launches() as launches, \
            torch.cuda.graph(graph, capture_error_mode='thread_local'):
        outs = run(*static)
    paths = [(n.split('_')[-1], a['path']) for n, a in launches]
    for _ in range(2):
        fresh = inputs()
        for s, f in zip(static, fresh):
            s.copy_(f)
        graph.replay()
        want = run(*fresh)
        torch.cuda.synchronize()
        for got, ref in zip(outs, want):
            assert torch.equal(got, ref), paths
    want_paths = {512: 'cooperative', 256: 'cluster', 64: 'batch_split'}[H]
    assert paths[0] == ('fwd', want_paths), paths


@pytest.mark.cuda
def test_the_harness_replays_every_checked_step(cuda):
    """The benchmark's training cell at a small size on the card: its
    check passes with every step a replay, and the new reader reads
    100."""
    import argparse
    from perfbench.run import run_cell
    from perfbench.tests.conftest import small_inputs
    for cell in ('ftw_ljspeech.train_b32', 'fph_ljspeech.train_b32'):
        args = argparse.Namespace(workload=cell, seed=2 ** 31 + 5,
                                  seconds=1.0, trace=1)
        result, check, _ = run_cell(args, 'cuda', small_inputs(cell))
        assert result['correct'], check
        assert result['metrics']['step_graph_share.train']['value'] == 100.0
