"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: they need an NVIDIA GPU and nvcc, and skip elsewhere.
Run them on a CUDA machine with

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q

Tolerances: float32 at atol 1e-4 (summation order differs); bfloat16
at atol 2e-2 for the inference kernel (a bf16 rounding flip of h moves a
step by one bf16 ulp), relative to the largest plain value for the
training kernels (see test_train_kernels_match_plain); greedy sampling
trajectories agree on > 95% of samples.
"""
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (kernels are built with nvcc)')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


# (cell, H, S, B, path, cluster): None takes the plan's choice. The
# stream-local path at every cluster size the plan picks and at 16
# (non-portable), an H that is not a power of two, B > 1, and B=32 with
# more clusters than the card holds at once (they run in waves); the
# cooperative path forced on the same inputs. Where the forced cluster size
# does not fit (LSTM H=512 float32 at 8 blocks), the wrapper raises.
BIRNN_CASES = [
    ('lstm', 256, 2, 3, None, None),
    ('gru', 128, 6, 1, None, None),
    ('gru', 96, 2, 2, None, None),
    ('lstm', 512, 2, 32, None, None),
    ('gru', 64, 2, 32, None, None),
    ('gru', 128, 6, 1, 'cooperative', None),
    ('gru', 128, 6, 4, 'stream_local', 1),
    ('gru', 128, 6, 1, 'stream_local', 2),
    ('gru', 256, 2, 1, 'stream_local', 2),
    ('gru', 256, 2, 1, 'stream_local', 4),
    ('gru', 256, 2, 3, 'stream_local', 8),
    ('gru', 256, 2, 32, 'stream_local', 8),
    ('gru', 256, 2, 1, 'cooperative', None),
    ('lstm', 512, 2, 1, 'stream_local', 8),
    ('lstm', 512, 2, 1, 'stream_local', 16),
    ('lstm', 512, 2, 32, 'stream_local', 16),
    ('lstm', 512, 2, 1, 'cooperative', None),
    ('gru', 96, 2, 1, 'stream_local', 1),
    ('gru', 160, 2, 2, 'stream_local', 2),
    ('lstm', 64, 2, 5, 'stream_local', 2),
    ('lstm', 64, 2, 5, 'stream_local', 1),
    # one stream (WaveRNN's GRUs): evaluate()'s B=32 H=512, a lane, and
    # the cooperative path forced
    ('gru', 512, 1, 32, None, None),
    ('gru', 512, 1, 1, None, None),
    ('gru', 96, 1, 3, 'cooperative', None),
]


@pytest.mark.parametrize('cell,H,S,B,path,cluster', BIRNN_CASES)
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_birnn_kernel_matches_plain(cuda, cell, H, S, B, path, cluster,
                                    dtype, tol):
    """Ragged lengths (every lane shorter than T at B=1) on forward and
    reversed streams; `path_launches` moves on the path that ran."""
    from forwardtacotron_tpu_torch.kernels import birnn as kb
    from forwardtacotron_tpu_torch.ops.rnn import birnn_recurrence
    g = torch.Generator().manual_seed(H + S)
    T, ng = 70, (4 if cell == 'lstm' else 3)
    gi = (torch.randn((T, B, S, ng * H), generator=g) * 0.5).to(dtype)
    w = ((torch.rand((S, ng * H, H), generator=g) * 2 - 1)
         / H ** 0.5).to(dtype)
    b = torch.zeros((S, ng * H)) if cell == 'lstm' else \
        torch.rand((S, ng * H), generator=g) * 0.1
    lengths = torch.tensor([T - (9 * i + 5) % T for i in range(B)],
                           dtype=torch.int32)
    args = [t.to(cuda).contiguous() for t in (gi, w, b, lengths)]
    props = torch.cuda.get_device_properties(cuda)
    smem = props.shared_memory_per_block_optin
    if cluster is not None and kb.stream_local_shape(
            cell, H, dtype, smem, cluster) is None:
        with pytest.raises(ValueError, match=f'clusters of {cluster}'):
            kb.recurrence(cell, *args, dtype, path=path, cluster=cluster)
        return
    ran = path or kb.inference_plan(cell, S, B, H, dtype, smem,
                                    props.multi_processor_count)['path']
    before = dict(kb.recurrence.path_launches)
    launches = kb.recurrence.launches
    y = kb.recurrence(cell, *args, dtype, path=path, cluster=cluster)
    assert kb.recurrence.launches == launches + 1
    assert kb.recurrence.path_launches == {
        p: n + (p == ran) for p, n in before.items()}
    ref = birnn_recurrence(cell, *args, dtype)
    assert float((y - ref).abs().max()) <= tol


def test_serving_shapes_take_the_stream_local_path(cuda):
    """On this card, every batch-1 bf16 shape of the serving path plans
    the stream-local path, and its clusters are resident at once."""
    from forwardtacotron_tpu_torch.kernels import birnn as kb
    props = torch.cuda.get_device_properties(cuda)
    for cell, S, H in (('lstm', 2, 512), ('gru', 2, 256), ('gru', 6, 128)):
        plan = kb.inference_plan(cell, S, 1, H, torch.bfloat16,
                                 props.shared_memory_per_block_optin,
                                 props.multi_processor_count)
        assert plan['path'] == 'stream_local', (cell, S, H)
        resident = kb.sl_size_on_card(cell, H, torch.bfloat16,
                                      plan['cluster'], plan['splits'])[2]
        assert resident >= S, (cell, S, H, plan['cluster'], resident)


@pytest.mark.parametrize('cell,H,cluster,splits', [
    ('gru', 128, 1, 4), ('gru', 256, 4, 8), ('gru', 256, 2, 4),
    ('lstm', 512, 8, 8), ('lstm', 512, 16, 16), ('gru', 96, 1, 4),
    ('gru', 100, 1, 1), ('lstm', 64, 2, 2), ('gru', 256, 8, 16)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_stream_local_sizes_match_the_c_side(cuda, cell, H, cluster, splits,
                                             dtype):
    """The plan's size formula (`_sl_size`) against the launcher's
    (ftt_birnn_sl_size), shapes it refuses included (threads 0)."""
    from forwardtacotron_tpu_torch.kernels import birnn as kb
    from forwardtacotron_tpu_torch.ops.rnn import n_gates
    threads, smem, _ = kb.sl_size_on_card(cell, H, dtype, cluster, splits)
    size = kb._sl_size(n_gates(cell), H, cluster, splits, dtype.itemsize)
    assert (threads, smem) == ((0, 0) if size is None else size[:2])


@pytest.mark.parametrize('mode', ['RAW', 'MOL'])
def test_sampler_kernel_matches_plain(cuda, mode):
    from forwardtacotron_tpu_torch.kernels import wavernn_sample as ws
    from forwardtacotron_tpu_torch.models.wavernn import WaveRNN
    torch.manual_seed(0)
    model = WaveRNN(rnn_dims=128, fc_dims=128, feat_dims=20, res_blocks=1,
                    compute_dims=16, res_out_dims=16, mode=mode).to(cuda)
    f32 = torch.float32
    w = ws.pack_weights(model, f32)
    cond = (torch.randn((300, 12, 20 + 16), device=cuda) * 0.5).to(f32)
    nr_mix = 10 if mode == 'MOL' else 0
    k = ws.sample(cond, w, ws.seed_tensor(0, cuda), nr_mix, True, f32)
    p = ws.sample_plain(cond, w, 0, nr_mix, True, f32)
    tol = 1e-6 if mode == 'RAW' else 1e-3
    assert float(((k - p).abs() < tol).float().mean()) > 0.95
    s1 = ws.sample(cond, w, ws.seed_tensor(5, cuda), nr_mix, False, f32)
    s2 = ws.sample(cond, w, ws.seed_tensor(5, cuda), nr_mix, False, f32)
    assert torch.equal(s1, s2) and bool((s1.abs() <= 1).all())


def _train_inputs(cell, T, B, S, H, dtype, seed, device):
    g = torch.Generator().manual_seed(seed)
    ng = 4 if cell == 'lstm' else 3
    gi = (torch.randn((T, B, S, ng * H), generator=g) * 0.5).to(dtype)
    w = ((torch.rand((S, ng * H, H), generator=g) * 2 - 1)
         / H ** 0.5).to(dtype)
    b = torch.zeros((S, ng * H)) if cell == 'lstm' else \
        torch.rand((S, ng * H), generator=g) * 0.1
    lengths = torch.tensor([T - 9 * i % T for i in range(B)],
                           dtype=torch.int32)
    dy = torch.randn((T, B, S, H), generator=g)
    return [t.to(device).contiguous() for t in (gi, w, b, lengths, dy)]


@pytest.mark.parametrize('cell,H,S,B', [('lstm', 256, 2, 5),
                                        ('gru', 128, 2, 6),
                                        ('gru', 64, 2, 33),
                                        ('gru', 96, 6, 2),
                                        ('gru', 512, 1, 32),
                                        ('gru', 64, 1, 3)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_train_kernels_match_plain(cuda, cell, H, S, B, dtype):
    """Kernel #2 (y, stash) and #3 (dgi, dgh) against their plain
    versions on the same inputs: float32 at atol 1e-4; bf16 relative to
    the largest plain value, at 2^-7 for the outputs stored in bf16
    (stash, dgi, dgh: one rounding flip) and 2e-3 for y, with a relative
    L2 error of at most 2^-8."""
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        train_backward, train_forward)
    from forwardtacotron_tpu_torch.ops.rnn import (birnn_train_backward,
                                                   birnn_train_forward)
    bf16_rel = {'y': 2e-3, 'stash': 2.0 ** -7, 'dgi': 2.0 ** -7,
                'dgh': 2.0 ** -7}
    gi, w, b, lengths, dy = _train_inputs(cell, 70, B, S, H, dtype, H + B,
                                          cuda)
    n_fwd, n_bwd = train_forward.launches, train_backward.launches
    y, st = train_forward(cell, gi, w, b, lengths, dtype)
    dgi, dgh = train_backward(cell, st, dy, w, lengths, dtype)
    assert (train_forward.launches, train_backward.launches) == \
        (n_fwd + 1, n_bwd + 1)
    y_p, st_p = birnn_train_forward(cell, gi, w, b, lengths, dtype)
    dgi_p, dgh_p = birnn_train_backward(cell, st, dy, w, lengths, dtype)
    for name, got, ref in (('y', y, y_p), ('stash', st, st_p),
                           ('dgi', dgi, dgi_p), ('dgh', dgh, dgh_p)):
        diff = got.float() - ref.float()
        err = float(diff.abs().max())
        if dtype == torch.float32:
            assert err <= 1e-4, (name, err)
        else:
            assert err <= bf16_rel[name] * float(ref.float().abs().max()), \
                (name, err)
            assert float(diff.norm() / ref.float().norm()) <= 2.0 ** -8, name


@pytest.mark.parametrize('cell', ['lstm', 'gru'])
def test_train_function_grads_match_autograd(cuda, cell):
    """BiRNNTrain (kernels #2/#3 plus the weight-gradient products) against
    autograd through the plain recurrence, float32."""
    from forwardtacotron_tpu_torch.ops.rnn import (BiRNNTrain,
                                                   birnn_recurrence)
    gi, w, b, lengths, dy = _train_inputs(cell, 50, 4, 2, 64, torch.float32,
                                          3, cuda)
    inputs = [gi.requires_grad_(), w.requires_grad_()]
    if cell == 'gru':
        inputs.append(b.requires_grad_())
    y = BiRNNTrain.apply(cell, gi, w, b, lengths, torch.float32)
    grads = torch.autograd.grad(y, inputs, dy)
    y_ref = birnn_recurrence(cell, gi, w, b, lengths, torch.float32)
    refs = torch.autograd.grad(y_ref, inputs, dy)
    assert float((y - y_ref).detach().abs().max()) <= 1e-4
    for got, ref in zip(grads, refs):
        torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-5)


def test_one_stream_gru_on_the_card(cuda):
    """`ops/rnn.py:gru` at WaveRNN's width (H=512, one stream): under
    autograd one launch each of #2 and #3 with outputs and gradients as
    the CPU plain path's; under no_grad one launch of #1."""
    from forwardtacotron_tpu_torch.kernels.birnn import recurrence
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        train_backward, train_forward)
    from forwardtacotron_tpu_torch.ops.rnn import gru
    g = torch.Generator().manual_seed(8)
    B, T, D, H = 4, 60, 544, 512
    params = {k: (torch.rand(shape, generator=g) * 2 - 1) / H ** 0.5
              for k, shape in (('w_ih', (3 * H, D)), ('w_hh', (3 * H, H)),
                               ('b_ih', (3 * H,)), ('b_hh', (3 * H,)))}
    x = torch.randn((B, T, D), generator=g)
    dy = torch.randn((B, T, H), generator=g)
    outs = {}
    for dev in ('cpu', cuda):
        p = {k: v.to(dev).requires_grad_() for k, v in params.items()}
        xd = x.to(dev).requires_grad_()
        n = (train_forward.launches, train_backward.launches)
        y = gru(p, xd)
        grads = torch.autograd.grad(y, [xd] + list(p.values()), dy.to(dev))
        if dev == cuda:
            assert (train_forward.launches, train_backward.launches) == \
                (n[0] + 1, n[1] + 1)
        outs[str(dev)] = [t.detach().cpu() for t in (y,) + grads]
    for got, ref in zip(outs[str(cuda)], outs['cpu']):
        torch.testing.assert_close(got, ref, rtol=2e-4, atol=1e-4)
    n = recurrence.launches
    with torch.no_grad():
        y = gru({k: v.to(cuda) for k, v in params.items()}, x.to(cuda))
    assert recurrence.launches == n + 1
    torch.testing.assert_close(y.cpu(), outs['cpu'][0], rtol=0, atol=1e-4)


def test_inference_kernel_refuses_grad(cuda):
    """The inference kernel's output has no grad_fn: under autograd the
    wrapper raises instead of silently cutting the graph."""
    from forwardtacotron_tpu_torch.kernels.birnn import recurrence
    gi, w, b, lengths, _ = _train_inputs('gru', 20, 2, 2, 32, torch.float32,
                                         1, cuda)
    w.requires_grad_()
    with pytest.raises(RuntimeError, match='require grad'):
        recurrence('gru', gi, w, b, lengths, torch.float32)
    with torch.no_grad():
        recurrence('gru', gi, w, b, lengths, torch.float32)


def _full_width_student(cuda):
    """(model, config, batch) of the full-width ForwardTacotron on the
    card with a batch of 4 items of 40 tokens."""
    import numpy as np
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    cfg = default_config()
    torch.manual_seed(0)
    model = ForwardTacotron.from_config(cfg).to(cuda)
    rng = np.random.RandomState(0)
    B, tx = 4, 40
    x = torch.tensor(rng.randint(1, 60, (B, tx)))
    dur = torch.tensor(rng.randint(1, 6, (B, tx)), dtype=torch.float32)
    mel_len = dur.sum(1).long()
    batch = {'x': x, 'x_len': torch.full((B,), tx), 'dur': dur,
             'mel': torch.randn(B, int(mel_len.max()) + 1, 80),
             'mel_len': mel_len, 'pitch': torch.randn(B, tx),
             'energy': torch.randn(B, tx)}
    return model, cfg, {k: v.to(cuda) for k, v in batch.items()}


def test_full_width_step_gives_every_parameter_a_gradient(cuda):
    """One train step of the full-width ForwardTacotron on the card: its
    six recurrences go through kernels #2/#3 (the step's first call
    captures its CUDA graph, so the wrappers are called twice a
    recurrence: the warm-up, then the capture), and every parameter gets a
    finite, nonzero gradient (none is cut off by a detached kernel)."""
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        train_backward, train_forward)
    from forwardtacotron_tpu_torch.train import common as tc
    model, cfg, batch = _full_width_student(cuda)
    before = (train_forward.launches, train_backward.launches)
    tc.train_step(model, tc.make_optimizer(model), batch,
                  torch.Generator(device=cuda).manual_seed(0),
                  cfg['forward_tacotron']['training'])
    assert (train_forward.launches - before[0],
            train_backward.launches - before[1]) == (12, 12)
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert bool(torch.isfinite(p.grad).all()), name
        assert float(p.grad.abs().max()) > 0, name


@pytest.mark.parametrize('path', ['eager', 'replay'])
def test_traced_step_spans_every_launch(cuda, monkeypatch, path):
    """A profiled student step on the card: the spans of kernels #2/#3 by
    path equal the launches the profiler saw by kernel name
    (`kernel_launches`). A replay of the step's CUDA graph records them
    inside its step's span (`train/common.py:StepGraphs`), and no phase
    span. An eager step (`remat`, which runs eagerly) says `eager` in its
    step span and records each inside its phase's span (#2 in
    `ftt.train.forward`, and again in `ftt.train.backward` where remat
    recomputes it; #3 in `ftt.train.backward`) both on the profiler's
    timeline and in the store, with its step's number."""
    import collections
    from torch.profiler import ProfilerActivity, profile
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, '_store', collections.deque(
        maxlen=profiling.STORE_SPANS))
    monkeypatch.setattr(profiling, '_steps', 0)
    model, cfg, batch = _full_width_student(cuda)
    opt = tc.make_optimizer(model)
    train_cfg = dict(cfg['forward_tacotron']['training'],
                     remat=path == 'eager')

    def step(seed):
        tc.train_step(model, opt, batch,
                      torch.Generator(device=cuda).manual_seed(seed),
                      train_cfg)
    step(0)                # builds the kernels (or captures), untraced
    assert profiling.spans() == []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(1)
        torch.cuda.synchronize()
    spans = profiling.spans()
    launches = [s for s in spans if s.name.startswith('ftt.kernels.')]
    recorded = collections.Counter(
        f'{s.name.split(".")[-1]}_{s.attrs["path"]}' for s in launches)
    counted = profiling.kernel_launches(prof)
    assert len(launches) == (12 if path == 'replay' else 18)
    assert {k: v for k, v in counted.items() if 'train' in k} == {
        k: recorded[k] for k in counted if 'train' in k}
    (held,) = [s for s in spans if s.name == 'ftt.train.step']
    assert held.attrs == {'path': path}
    if path == 'replay':
        assert not [s for s in spans if s.name in ('ftt.train.forward',
                                                   'ftt.train.backward')]
        for s in launches:
            assert s.step == 0 and s.parent == held.id
            assert held.start_ns <= s.start_ns <= s.end_ns <= held.end_ns
            assert s.attrs['lengths'].device.type == 'cuda'
        return
    phase = {'ftt.kernels.birnn_train_fwd': ('ftt.train.forward',
                                             'ftt.train.backward'),
             'ftt.kernels.birnn_train_bwd': ('ftt.train.backward',)}
    per_step = {'ftt.kernels.birnn_train_fwd': 12,
                'ftt.kernels.birnn_train_bwd': 6}
    # the profiler mirrors each host range onto the card's timeline as a
    # user annotation, which is not device work
    on_card = [e for e in prof.events() if str(e.device_type).endswith('CUDA')
               and e.name.startswith('ftt.')]
    assert on_card and all(e.is_user_annotation for e in on_card)
    events = [e for e in prof.events()
              if not str(e.device_type).endswith('CUDA')]

    def inside(s, opened):
        return any(h.start_ns <= s.start_ns and s.end_ns <= h.end_ns
                   for h in opened)
    for name, outer in phase.items():
        ranges = [e.time_range for e in events if e.name in outer]
        inner = [e.time_range for e in events if e.name == name]
        assert len(inner) == sum(s.name == name for s in launches) \
            == per_step[name]
        assert all(any(r.start <= i.start and i.end <= r.end
                       for r in ranges) for i in inner), name
        opened = [s for s in spans if s.name in outer]
        for s in (s for s in launches if s.name == name):
            assert s.step == 0 and s.attrs['dtype'] == 'float32'
            assert s.attrs['lengths'].device.type == 'cuda'
            assert inside(s, opened), name
    forward = [s for s in spans if s.name == 'ftt.train.forward']
    assert sum(inside(s, forward) for s in launches
               if s.name == 'ftt.kernels.birnn_train_fwd') == 6


@pytest.mark.parametrize('cell,H', [('gru', 64), ('gru', 128), ('lstm', 64)])
@pytest.mark.parametrize('B', [1, 7, 32])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_batch_split_forward_matches_plain(cuda, cell, H, B, dtype):
    """Kernel #2's batch-split path (no grid barrier) against the plain
    version at ragged lengths, with the tolerances of
    test_train_kernels_match_plain; its stash fed to kernel #3 gives the
    plain dgi/dgh. The cooperative path on the same inputs agrees too."""
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        train_backward, train_forward)
    from forwardtacotron_tpu_torch.ops.rnn import (birnn_train_backward,
                                                   birnn_train_forward)
    bf16_rel = {'y': 2e-3, 'stash': 2.0 ** -7, 'dgi': 2.0 ** -7,
                'dgh': 2.0 ** -7}
    gi, w, b, lengths, dy = _train_inputs(cell, 70, B, 2, H, dtype, H + B,
                                          cuda)
    n_bs = train_forward.path_launches['batch_split']
    y, st = train_forward(cell, gi, w, b, lengths, dtype)
    assert train_forward.path_launches['batch_split'] == n_bs + 1
    dgi, dgh = train_backward(cell, st, dy, w, lengths, dtype)
    y_c, st_c = train_forward(cell, gi, w, b, lengths, dtype,
                              path='cooperative')
    y_p, st_p = birnn_train_forward(cell, gi, w, b, lengths, dtype)
    dgi_p, dgh_p = birnn_train_backward(cell, st, dy, w, lengths, dtype)
    for name, got, ref in (('y', y, y_p), ('stash', st, st_p),
                           ('dgi', dgi, dgi_p), ('dgh', dgh, dgh_p),
                           ('y', y_c, y_p), ('stash', st_c, st_p)):
        diff = got.float() - ref.float()
        err = float(diff.abs().max())
        if dtype == torch.float32:
            assert err <= 1e-4, (name, err)
        else:
            assert err <= bf16_rel[name] * float(ref.float().abs().max()), \
                (name, err)
            assert float(diff.norm() / ref.float().norm()) <= 2.0 ** -8, name


def _masked_lane_inputs(cell, H, S, B, dtype, device):
    """_train_inputs at T=70 with the last lane's length set to 0: a lane
    that is masked at every step."""
    gi, w, b, lengths, dy = _train_inputs(cell, 70, B, S, H, dtype, H + B,
                                          device)
    lengths[-1] = 0
    return gi, w, b, lengths, dy


@pytest.mark.parametrize('path,cell,H,S,B', [
    ('batch_split', 'gru', 64, 2, 32),
    ('batch_split', 'gru', 128, 2, 32),
    ('batch_split', 'gru', 128, 6, 3),
    ('batch_split', 'lstm', 64, 2, 7),
    ('cooperative', 'lstm', 64, 2, 5),
    ('cooperative', 'lstm', 256, 2, 9),
    ('cooperative', 'gru', 96, 2, 33),
    ('cooperative', 'gru', 256, 2, 32),
    ('cooperative', 'gru', 30, 2, 5),
    ('cooperative', 'gru', 520, 2, 3),
])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_train_backward_paths_match_plain(cuda, path, cell, H, S, B, dtype):
    """Kernel #3 on each path against its plain version, fed the same
    stash, at ragged lengths with one lane masked at every step: float32 at
    atol 1e-4; bf16 at 2^-7 of the largest plain value, relative L2 at
    most 2^-8 (the tolerances of test_train_kernels_match_plain). The
    batch-split cases are the ones its plan picks; H=30 takes the
    cooperative path's sums one unit at a time (U=1, H not a multiple of
    4), H=520 its three W_hh columns a thread."""
    from forwardtacotron_tpu_torch.kernels import birnn_train as bt
    from forwardtacotron_tpu_torch.ops.rnn import birnn_train_backward
    props = torch.cuda.get_device_properties(cuda)
    if path == 'batch_split':
        assert bt.train_backward_plan(
            cell, S, B, H, dtype, props.shared_memory_per_block_optin,
            props.multi_processor_count)['path'] == path
    gi, w, b, lengths, dy = _masked_lane_inputs(cell, H, S, B, dtype, cuda)
    st = bt.train_forward(cell, gi, w, b, lengths, dtype)[1]
    before = dict(bt.train_backward.path_launches)
    dgi, dgh = bt.train_backward(cell, st, dy, w, lengths, dtype, path=path)
    assert bt.train_backward.path_launches[path] == before[path] + 1
    dgi_p, dgh_p = birnn_train_backward(cell, st, dy, w, lengths, dtype)
    for name, got, ref in (('dgi', dgi, dgi_p), ('dgh', dgh, dgh_p)):
        diff = got.float() - ref.float()
        err = float(diff.abs().max())
        assert bool(torch.isfinite(got).all()), name
        if dtype == torch.float32:
            assert err <= 1e-4, (name, err)
        else:
            assert err <= 2.0 ** -7 * float(ref.float().abs().max()), \
                (name, err)
            assert float(diff.norm() / ref.float().norm()) <= 2.0 ** -8, name
        # the masked lane: zero gradients at every step
        assert float(got[:, -1].float().abs().max()) == 0.0, name


@pytest.mark.parametrize('cell,H', [('gru', 64), ('gru', 128),
                                    ('lstm', 64)])
def test_train_backward_paths_agree(cuda, cell, H):
    """The cooperative and batch-split backward on the same inputs agree
    within 1e-4 in float32 (their sums run in other orders)."""
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        train_backward, train_forward)
    gi, w, b, lengths, dy = _masked_lane_inputs(cell, H, 2, 32,
                                                torch.float32, cuda)
    st = train_forward(cell, gi, w, b, lengths, torch.float32)[1]
    split = train_backward(cell, st, dy, w, lengths, torch.float32,
                           path='batch_split')
    coop = train_backward(cell, st, dy, w, lengths, torch.float32,
                          path='cooperative')
    for got, ref in zip(split, coop):
        assert float((got - ref).abs().max()) <= 1e-4


@pytest.mark.parametrize('bwd,cell,H,splits', [
    (0, 'gru', 128, 2), (0, 'gru', 64, 4), (0, 'lstm', 64, 1),
    (1, 'gru', 128, 16), (1, 'gru', 64, 32), (1, 'lstm', 64, 32),
    (1, 'gru', 64, 1)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_batch_split_sizes_match_the_c_side(cuda, bwd, cell, H, splits,
                                            dtype):
    """The plan's size formulas (`_bs_size`, `_bs_bwd_size`) against the
    ones the launchers of csrc/birnn_train.cu use, as the library reports
    them (ftt_birnn_train_bs_size)."""
    import ctypes
    from forwardtacotron_tpu_torch.kernels import _build
    from forwardtacotron_tpu_torch.kernels import birnn_train as bt
    from forwardtacotron_tpu_torch.ops.rnn import n_gates
    fn = _build.load('birnn_train').ftt_birnn_train_bs_size
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_longlong)]
    threads, smem = ctypes.c_int(), ctypes.c_longlong()
    assert fn(bwd, int(cell == 'lstm'), int(dtype == torch.bfloat16), H,
              splits, ctypes.byref(threads), ctypes.byref(smem)) == 0
    size = bt._bs_bwd_size if bwd else bt._bs_size
    assert size(n_gates(cell), H, splits, dtype.itemsize) == \
        (threads.value, smem.value)


# (cell, H, S, B, dtype, cluster): the cluster forward at the decoder's,
# WaveRNN's and the CBHG's widths and at every (C, lanes) that fits there,
# None taking the plan's; B=13 leaves the last group of 8 or 16 lanes
# part empty, B=5 one group of 8 with three empty lanes
CLUSTER_CASES = [
    ('lstm', 512, 2, 13, torch.float32, None),
    ('lstm', 512, 2, 13, torch.bfloat16, None),
    ('lstm', 512, 2, 13, torch.bfloat16, (16, 16)),
    ('lstm', 512, 2, 13, torch.bfloat16, (16, 8)),
    ('lstm', 512, 2, 13, torch.bfloat16, (8, 8)),
    ('gru', 512, 1, 13, torch.float32, (16, 8)),
    ('gru', 512, 1, 13, torch.bfloat16, (16, 8)),
    ('gru', 512, 1, 32, torch.bfloat16, (16, 16)),
    ('gru', 512, 1, 13, torch.bfloat16, (8, 8)),
    ('gru', 256, 2, 32, torch.float32, (4, 8)),
    ('gru', 256, 2, 32, torch.float32, (8, 8)),
    ('gru', 256, 2, 13, torch.float32, (16, 8)),
    ('gru', 256, 2, 13, torch.bfloat16, (4, 8)),
    ('gru', 256, 2, 13, torch.bfloat16, (8, 16)),
    ('gru', 256, 2, 13, torch.bfloat16, (16, 16)),
    ('lstm', 128, 2, 5, torch.float32, (8, 8)),
]


@pytest.mark.parametrize('cell,H,S,B,dtype,cluster', CLUSTER_CASES)
def test_cluster_forward_matches_plain(cuda, cell, H, S, B, dtype, cluster):
    """Kernel #2's cluster path against the plain version at ragged
    lengths with one lane masked at every step (y and the stash, the
    stash's values at masked steps included), with the tolerances of
    test_train_kernels_match_plain; kernel #3 over its stash against #3
    over the cooperative path's stash, at the same tolerances."""
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        _cluster_plan, launch_forward, train_backward, train_forward)
    from forwardtacotron_tpu_torch.ops.rnn import birnn_train_forward
    bf16_rel = {'y': 2e-3, 'stash': 2.0 ** -7, 'dgi': 2.0 ** -7,
                'dgh': 2.0 ** -7}
    gi, w, b, lengths, dy = _masked_lane_inputs(cell, H, S, B, dtype, cuda)
    n = train_forward.path_launches['cluster']
    if cluster is None:
        y, st = train_forward(cell, gi, w, b, lengths, dtype, path='cluster')
    else:
        props = torch.cuda.get_device_properties(cuda)
        plan = _cluster_plan(cell, S, B, H, dtype,
                             props.shared_memory_per_block_optin,
                             props.multi_processor_count, cluster)
        assert (plan['cluster'], plan['lanes']) == cluster
        y, st = launch_forward(plan, cell, gi, w, b, lengths, dtype)
    assert train_forward.path_launches['cluster'] == n + 1
    st_c = train_forward(cell, gi, w, b, lengths, dtype,
                         path='cooperative')[1]
    y_p, st_p = birnn_train_forward(cell, gi, w, b, lengths, dtype)
    dgi, dgh = train_backward(cell, st, dy, w, lengths, dtype)
    dgi_c, dgh_c = train_backward(cell, st_c, dy, w, lengths, dtype)
    for name, got, ref in (('y', y, y_p), ('stash', st, st_p),
                           ('dgi', dgi, dgi_c), ('dgh', dgh, dgh_c)):
        diff = got.float() - ref.float()
        err = float(diff.abs().max())
        assert bool(torch.isfinite(got).all()), name
        if dtype == torch.float32:
            assert err <= 1e-4, (name, err)
        else:
            assert err <= bf16_rel[name] * float(ref.float().abs().max()), \
                (name, err)
            assert float(diff.norm() / ref.float().norm()) <= 2.0 ** -8, name


# (cell, H, S, B, cluster, lanes, reg): the float32 cluster forward at
# each register share of W_hh at the widths the plans give it, B=13
# leaving the last group part empty
CLUSTER_REG_CASES = [
    ('lstm', 512, 2, 13, 16, 8, 8),
    ('gru', 512, 1, 13, 16, 8, 4),
    ('gru', 512, 1, 13, 16, 8, 8),
    ('gru', 256, 2, 13, 8, 8, 4),
    ('gru', 256, 2, 32, 8, 8, 8),
    ('gru', 256, 2, 13, 4, 8, 4),
    ('lstm', 128, 2, 5, 8, 8, 4),
]


@pytest.mark.parametrize('cell,H,S,B,cluster,lanes,reg', CLUSTER_REG_CASES)
def test_cluster_register_shares_match_plain(cuda, cell, H, S, B, cluster,
                                             lanes, reg):
    """The float32 cluster forward (its product on the CUDA cores) with
    4 or 8 16-byte chunks of each W_hh row in registers against the plain
    version at atol 1e-4 (y and the stash; ragged lengths, one lane masked
    at every step)."""
    from forwardtacotron_tpu_torch.kernels import birnn_train as bt
    from forwardtacotron_tpu_torch.ops.rnn import (birnn_train_forward,
                                                   n_gates)
    smem = torch.cuda.get_device_properties(
        cuda).shared_memory_per_block_optin
    f32 = torch.float32
    shape = bt.cluster_shape(cell, H, f32, smem, cluster, lanes)
    size = bt._cl_size(n_gates(cell), H, cluster, lanes, shape['splits'],
                       reg, 4)
    assert size is not None and size[1] <= smem
    plan = dict(shape, path='cluster', reg=reg)
    gi, w, b, lengths, _ = _masked_lane_inputs(cell, H, S, B, f32, cuda)
    n = bt.train_forward.path_dtype_launches[('cluster', 'float32')]
    y, st = bt.launch_forward(plan, cell, gi, w, b, lengths, f32)
    assert bt.train_forward.path_dtype_launches[('cluster', 'float32')] \
        == n + 1
    y_p, st_p = birnn_train_forward(cell, gi, w, b, lengths, f32)
    for name, got, ref in (('y', y, y_p), ('stash', st, st_p)):
        assert bool(torch.isfinite(got).all()), name
        assert float((got - ref).abs().max()) <= 1e-4, name


@pytest.mark.parametrize('cell,H,cluster,lanes,splits,reg', [
    ('lstm', 512, 16, 8, 8, 8), ('lstm', 512, 16, 16, 2, 8),
    ('lstm', 512, 8, 8, 1, 8), ('gru', 512, 16, 8, 8, 4),
    ('gru', 512, 16, 8, 8, 8), ('gru', 256, 8, 8, 8, 4),
    ('gru', 256, 4, 8, 4, 4), ('gru', 256, 16, 16, 4, 8),
    ('lstm', 128, 8, 8, 16, 4), ('gru', 96, 2, 8, 2, 8),
    ('lstm', 512, 16, 16, 8, 8), ('gru', 100, 4, 8, 1, 4),
    ('gru', 256, 8, 8, 2, 6)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_cluster_sizes_match_the_c_side(cuda, cell, H, cluster, lanes,
                                        splits, reg, dtype):
    """The plan's size formula (`_cl_size`) against the launcher's
    (ftt_birnn_train_cl_size), shapes it refuses included (threads 0);
    the card holds at least one cluster of every shape that fits a
    block."""
    from forwardtacotron_tpu_torch.kernels import birnn_train as bt
    from forwardtacotron_tpu_torch.ops.rnn import n_gates
    threads, smem, resident = bt.cl_size_on_card(cell, H, dtype, cluster,
                                                 lanes, splits, reg)
    size = bt._cl_size(n_gates(cell), H, cluster, lanes, splits, reg,
                       dtype.itemsize)
    assert (threads, smem) == ((0, 0) if size is None else size[:2])
    if size is not None and size[1] <= torch.cuda.get_device_properties(
            cuda).shared_memory_per_block_optin:
        assert resident >= 1


@pytest.mark.parametrize('lanes', [1, 64, 72, 128])
@pytest.mark.parametrize('mode', ['RAW', 'MOL'])
def test_sampler_lanes_match_plain(cuda, lanes, mode):
    """The sampler at 1, 64, 72 and 128 lanes: greedy float32 and bfloat16
    trajectories agree with the plain version on > 95% of samples (RAW:
    the same class; MOL: within 1e-3), a seed repeats its samples and
    sampled values lie in [-1, 1]."""
    from forwardtacotron_tpu_torch.kernels import wavernn_sample as ws
    from forwardtacotron_tpu_torch.models.wavernn import WaveRNN
    torch.manual_seed(1)
    model = WaveRNN(rnn_dims=128, fc_dims=128, feat_dims=20, res_blocks=1,
                    compute_dims=16, res_out_dims=16, mode=mode).to(cuda)
    nr_mix = 10 if mode == 'MOL' else 0
    tol = 1e-6 if mode == 'RAW' else 1e-3
    cond = torch.randn((200, lanes, 20 + 16), device=cuda) * 0.5
    for dtype in (torch.float32, torch.bfloat16):
        w = ws.pack_weights(model, dtype)
        c = cond.to(dtype)
        before = ws.sample.launches
        k = ws.sample(c, w, ws.seed_tensor(0, cuda), nr_mix, True, dtype)
        assert ws.sample.launches == before + 1
        p = ws.sample_plain(c, w, 0, nr_mix, True, dtype)
        assert float(((k - p).abs() < tol).float().mean()) > 0.95, dtype
        s1 = ws.sample(c, w, ws.seed_tensor(5, cuda), nr_mix, False, dtype)
        s2 = ws.sample(c, w, ws.seed_tensor(5, cuda), nr_mix, False, dtype)
        assert torch.equal(s1, s2) and bool((s1.abs() <= 1).all())
        assert float(s1.std()) > 0


@pytest.mark.parametrize('T', [1000, 40])
def test_teacher_synthesis_birnn_matches_plain(cuda, T):
    """Kernel #1 at the teacher's free-running shapes: the postnet CBHG
    BiGRU over 1000 frames and the encoder's over a 40-token text, B=1,
    H=128, float32, at atol 1e-4 on the path its plan names."""
    from forwardtacotron_tpu_torch.kernels import birnn as kb
    from forwardtacotron_tpu_torch.ops.rnn import birnn_recurrence
    g = torch.Generator().manual_seed(T)
    H = 128
    gi = torch.randn((T, 1, 2, 3 * H), generator=g) * 0.5
    w = (torch.rand((2, 3 * H, H), generator=g) * 2 - 1) / H ** 0.5
    b = torch.rand((2, 3 * H), generator=g) * 0.1
    lengths = torch.tensor([T], dtype=torch.int32)
    args = [t.to(cuda).contiguous() for t in (gi, w, b, lengths)]
    launches = kb.recurrence.launches
    y = kb.recurrence('gru', *args, torch.float32)
    assert kb.recurrence.launches == launches + 1
    ref = birnn_recurrence('gru', *args, torch.float32)
    assert float((y - ref).abs().max()) <= 1e-4


def test_fast_pitch_card_matches_cpu(cuda):
    """FastPitch at config.yaml's width, random seeded weights: the
    padded-bucket float32 generate on the card against the CPU at atol
    1e-4 (TF32 off), with equal mel lengths."""
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.models.fast_pitch import FastPitch
    torch.backends.cudnn.allow_tf32 = False
    cfg = default_config()
    cfg['tts_model'] = 'fast_pitch'
    torch.manual_seed(0)
    model = FastPitch.from_config(cfg)
    model.dur_pred.lin.bias.data.fill_(4.0)
    g = torch.Generator().manual_seed(1)
    x = torch.randint(1, 60, (2, 48), generator=g)
    xl = torch.tensor([48, 31])
    ref = model.generate(x, 512, x_len=xl)
    got = model.to(cuda).generate(x.to(cuda), 512, x_len=xl.to(cuda))
    assert torch.equal(got['mel_len'].cpu(), ref['mel_len'])
    for i, n in enumerate(ref['mel_len'].tolist()):
        err = (got['mel'][i, :n].cpu() - ref['mel'][i, :n]).abs().max()
        assert float(err) <= 1e-4


def test_tacotron_generate_card_matches_cpu(cuda):
    """The teacher's free-running synthesis at config.yaml's width with
    random seeded weights and a threshold that stops the run: mel, linear
    and attention of the first 16 steps at atol 1e-4 on the card (kernel
    #1 in both CBHGs) against the CPU, and an equal n_valid."""
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.kernels import birnn as kb
    from forwardtacotron_tpu_torch.models.tacotron import Tacotron
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    model = Tacotron.from_config(default_config()).eval()
    model.stop_threshold.fill_(1e9)          # stops once 10 frames are out
    x = torch.randint(1, 60, (1, 30),
                      generator=torch.Generator().manual_seed(2))
    ref = model.generate(x, 64, 1)
    launches = kb.recurrence.launches
    got = model.to(cuda).generate(x.to(cuda), 64, 1)
    assert kb.recurrence.launches == launches + 2
    assert got[3] == ref[3] == 11
    for a, b in zip(got[:3], ref[:3]):
        assert float((a[:, :16].cpu() - b[:, :16]).abs().max()) <= 1e-4


def test_sampler_seed_from_device_memory(cuda):
    """Kernel #4 reads its seed from an int64 on the card: the same seed
    tensor gives the same samples, another seed others; rewriting the
    seed in place before a replay of a captured launch changes the
    draw; lane groups are seeded seed + g on the card."""
    from forwardtacotron_tpu_torch.kernels import wavernn_sample as ws
    from forwardtacotron_tpu_torch.models.wavernn import WaveRNN
    torch.manual_seed(2)
    model = WaveRNN(rnn_dims=128, fc_dims=128, feat_dims=20, res_blocks=1,
                    compute_dims=16, res_out_dims=16).to(cuda)
    bf16 = torch.bfloat16
    w = ws.pack_weights(model, bf16)
    cond = (torch.randn((150, 24, 20 + 16), device=cuda) * 0.5).to(bf16)
    seed = ws.seed_tensor(7, cuda)
    a = ws.sample(cond, w, seed, 0, False, bf16)
    assert torch.equal(a, ws.sample(cond, w, seed.clone(), 0, False, bf16))
    assert not torch.equal(a, ws.sample(cond, w, ws.seed_tensor(8, cuda),
                                        0, False, bf16))
    ws.sample(cond, w, seed, 0, False, bf16)      # warm before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode='thread_local'):
        out = ws.sample(cond, w, seed, 0, False, bf16)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, a)
    seed.fill_(8)
    graph.replay()
    torch.cuda.synchronize()
    assert not torch.equal(out, a)
    # groups of 16 lanes: the group at lane 16 draws with seed + 16
    mels_up = torch.randn((32, 150, 20), device=cuda) * 0.5
    aux = torch.randn((32, 150, 16), device=cuda) * 0.5
    saved = ws.MAX_LANES
    ws.MAX_LANES = 16
    try:
        grouped = ws.sample_conditioned(model, mels_up, aux,
                                        ws.seed_tensor(3, cuda), False, bf16)
    finally:
        ws.MAX_LANES = saved
    second = ws.sample(ws.compact_cond(mels_up[16:], aux[16:], bf16), w,
                       ws.seed_tensor(3 + 16, cuda), 0, False, bf16)
    assert torch.equal(grouped[16:], second.T)


def _tiny_serving_config(voc_dims=128):
    """config.yaml with small ForwardTacotron and WaveRNN widths (the
    sampler kernel takes rnn_dims 128)."""
    from forwardtacotron_tpu_torch.config import default_config
    cfg = default_config()
    cfg['forward_tacotron']['model'].update(
        embed_dims=32, series_embed_dims=16, durpred_conv_dims=32,
        durpred_rnn_dims=16, pitch_conv_dims=32, pitch_rnn_dims=16,
        energy_conv_dims=32, energy_rnn_dims=16, rnn_dims=64,
        prenet_dims=32, prenet_k=4, postnet_dims=32, postnet_k=4)
    cfg['vocoder']['model'].update(rnn_dims=voc_dims, fc_dims=voc_dims,
                                   compute_dims=16, res_out_dims=16,
                                   res_blocks=1)
    return cfg


def _tiny_hifigan(tmp_path):
    import json
    from forwardtacotron_tpu_torch.models.hifigan import (
        HiFiGANGenerator, weight_norm_state_dict)
    cfg = {'resblock': '2', 'upsample_rates': [8, 8, 4],
           'upsample_kernel_sizes': [16, 16, 8],
           'upsample_initial_channel': 32, 'resblock_kernel_sizes': [3],
           'resblock_dilation_sizes': [[1, 3]]}
    torch.manual_seed(7)
    gen = HiFiGANGenerator.from_config(cfg, n_mels=80)
    torch.save({'generator': weight_norm_state_dict(gen)},
               tmp_path / 'g_00000001')
    (tmp_path / 'config.json').write_text(json.dumps(cfg))
    return str(tmp_path / 'g_00000001')


@pytest.mark.parametrize('vocoder', ['hifigan', 'wavernn'])
def test_fused_graph_replay_equals_eager(cuda, tmp_path, vocoder):
    """The fused server's captured graph against the same function run
    eagerly on the card with the same inputs and seed: int16 PCM, mel_len
    and wav_len equal bit for bit; kernels #1 and #4 run inside the
    replay (profiler, by kernel name) as often as in the eager run (the
    wrappers' counters); WaveRNN replays with other seeds differ."""
    from torch.profiler import ProfilerActivity, profile
    from forwardtacotron_tpu_torch.kernels.birnn import recurrence
    from forwardtacotron_tpu_torch.kernels.wavernn_sample import sample
    from forwardtacotron_tpu_torch.serving import TTSServer
    from forwardtacotron_tpu_torch.utils.profiling import kernel_launches
    voc = _tiny_hifigan(tmp_path) if vocoder == 'hifigan' else None
    with TTSServer(None, vocoder=vocoder, voc_checkpoint=voc,
                   config=_tiny_serving_config(), device=cuda, fused=True,
                   fused_max_t=128) as srv:
        B, tx = 2, 16
        g = torch.Generator().manual_seed(0)
        x = torch.randint(1, 40, (B, tx), generator=g)
        inputs = [x.numpy(), torch.tensor([tx, 9]).numpy(),
                  torch.tensor([1.0, 1.3]).numpy(),
                  torch.tensor([0.9, 1.1]).numpy(),
                  torch.tensor([1.0, 0.8]).numpy(),
                  torch.zeros(B, dtype=torch.long).numpy(),
                  torch.tensor(11).numpy()]
        run = srv._fused_program(tx, B, 128)
        assert (tx, B, 128) in srv.capture_seconds
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            replay = run(*inputs)
        counted = kernel_launches(prof)
        n1, n4 = recurrence.launches, sample.launches
        with torch.no_grad():
            eager = srv._fused_forward(
                *(torch.as_tensor(v).to(cuda) for v in inputs), 128)
        torch.cuda.synchronize()
        assert counted['birnn_stream_local'] + counted['birnn_cooperative'] \
            == recurrence.launches - n1 > 0
        assert counted['wavernn_sample'] == sample.launches - n4
        assert torch.equal(run.outputs[3], eager[3])    # the mel
        for got, ref in zip(replay, eager[:3]):
            assert got.dtype == ref.cpu().numpy().dtype
            assert (got == ref.cpu().numpy()).all()
        assert replay[0].dtype.name == 'int16'
        if vocoder == 'wavernn':
            assert counted['wavernn_sample'] > 0
            again = run(*inputs[:-1], torch.tensor(11).numpy())
            other = run(*inputs[:-1], torch.tensor(12).numpy())
            assert (again[0] == replay[0]).all()
            assert not (other[0] == replay[0]).all()


def test_exported_artifact_launches_kernels(cuda, tmp_path):
    """An artifact exported on the card (ForwardTacotron + WaveRNN) runs
    kernels #1 and #4 as the ops ftt::birnn_recurrence /
    ftt::wavernn_sample, not their plain versions: the wrappers' counters
    and the profiler's kernel names both move; a fixed seed repeats its
    PCM, and generate matches the live model."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from forwardtacotron_tpu_torch.kernels.birnn import recurrence
    from forwardtacotron_tpu_torch.kernels.wavernn_sample import sample
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.models.wavernn import WaveRNN
    from forwardtacotron_tpu_torch.utils.export import (ExportedTTS,
                                                        save_exported_tts)
    from forwardtacotron_tpu_torch.utils.profiling import kernel_launches
    cfg = _tiny_serving_config()
    torch.manual_seed(0)
    model = ForwardTacotron.from_config(cfg).to(cuda).eval()
    voc = WaveRNN.from_config(cfg).to(cuda).eval()
    path = tmp_path / 'tts.ftpt'
    save_exported_tts(model, path, buckets=[(16, 128)], vocoder=voc)
    art = ExportedTTS(path)
    ids = [5, 9, 12, 3, 7, 22, 14]
    n1, n4 = recurrence.launches, sample.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        a = art.synthesize(ids, seed=4)
    counted = kernel_launches(prof)
    assert recurrence.launches > n1 and sample.launches > n4
    assert counted['birnn_stream_local'] + counted['birnn_cooperative'] \
        == recurrence.launches - n1
    assert counted['wavernn_sample'] == sample.launches - n4
    assert a.dtype == np.int16 and np.array_equal(
        a, art.synthesize(ids, seed=4))
    mel, _ = art.generate(ids)
    x = torch.zeros((1, 16), dtype=torch.long)
    x[0, :len(ids)] = torch.tensor(ids)
    live = model.generate(x.to(cuda), 128, x_len=torch.tensor(
        [len(ids)], device=cuda), compute_dtype=torch.float32)
    n = int(live['mel_len'][0])
    assert mel.shape == (80, n)
    ref = live['mel_post'][0, :n].T.cpu().numpy()
    assert float(np.abs(mel - ref).mean()) < 1e-3
