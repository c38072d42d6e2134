"""The port's kernel launch plans and build key, on the CPU.

- `kernels/birnn_train.py:train_forward_plan` with an H100's numbers
  (232,448 bytes of shared memory per block, 132 SMs): the training
  step's series-predictor BiGRUs (config.yaml: H=64 duration/energy,
  H=128 pitch) take the batch-split path in float32 and bfloat16; the CBHG
  GRUs (H=256), WaveRNN's GRU (H=512, one stream) and the decoder LSTM
  (H=512) take the cluster path, at the (C, lanes) of the least estimate,
  where its clusters run in one wave; the cooperative one where they need
  two (the float32 decoder at batch 32) or no cluster fits; `_cl_size`
  against a hand count of the C layout (and the probe's 3xTF32 size);
  forced paths.
- `kernels/birnn_train.py:train_backward_plan` likewise: the predictor
  BiGRUs take the batch-split backward in float32 and bfloat16, the CBHG
  GRUs and the decoder LSTM the cooperative one; `_bs_bwd_size` against a
  hand count of the C layout.
- `kernels/_build.py`: the library's path hashes the headers under
  `csrc/`, so an edited header is rebuilt.
- `kernels/wavernn_sample.py:scratch_bytes` against the layout it mirrors.
"""
import pytest
import torch

H100_SMEM = 232448
H100_SMS = 132


@pytest.mark.parametrize('cell,H,dtype,path', [
    ('gru', 64, torch.float32, 'batch_split'),
    ('gru', 128, torch.float32, 'batch_split'),
    ('gru', 64, torch.bfloat16, 'batch_split'),
    ('gru', 128, torch.bfloat16, 'batch_split'),
    ('gru', 256, torch.float32, 'cluster'),
    ('gru', 256, torch.bfloat16, 'cluster'),
    ('lstm', 512, torch.float32, 'cooperative'),
    ('lstm', 512, torch.bfloat16, 'cluster'),
    ('lstm', 64, torch.float32, 'batch_split'),
    ('lstm', 128, torch.float32, 'cluster'),
])
def test_train_forward_plan_on_h100(cell, H, dtype, path):
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        BS_MAX_THREADS, CL_MAX_THREADS, train_forward_plan)
    plan = train_forward_plan(cell, 2, 32, H, dtype, H100_SMEM, H100_SMS)
    assert plan['path'] == path
    if path == 'cluster':
        # one cluster per stream and group of lanes, W_hh split by units
        assert plan['clusters'] == 2 * -(-32 // plan['lanes'])
        assert H % plan['cluster'] == 0
        assert plan['smem'] <= H100_SMEM
        assert plan['threads'] % 32 == 0
        assert plan['threads'] <= CL_MAX_THREADS
        return
    if path == 'batch_split':
        ng = 4 if cell == 'lstm' else 3
        item = 4 if dtype == torch.float32 else 2
        assert plan['blocks'] == 2 * 32     # one per stream and batch lane
        assert plan['smem'] <= H100_SMEM
        # the whole W_hh of a stream is resident, beside h and the partials
        assert plan['smem'] >= item * ng * H * H
        assert plan['threads'] % 32 == 0
        assert H <= plan['threads'] <= BS_MAX_THREADS
        assert (H * item // 16) % plan['splits'] == 0
    else:
        assert 2 * H // plan['units'] <= H100_SMS


def test_config_predictors_take_batch_split():
    """Every BiGRU of the series predictors in config.yaml fits the
    batch-split path on an H100, at the training batch."""
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        train_forward_plan)
    cfg = default_config()['forward_tacotron']
    batch = max(int(s.split(',')[2]) for s in cfg['training']['schedule'])
    dims = [cfg['model'][f'{k}_rnn_dims']
            for k in ('durpred', 'pitch', 'energy')]
    assert sorted(dims) == [64, 64, 128] and batch == 32
    for H in dims:
        for dtype in (torch.float32, torch.bfloat16):
            plan = train_forward_plan('gru', 2, batch, H, dtype, H100_SMEM,
                                      H100_SMS)
            assert plan['path'] == 'batch_split', (H, dtype)


def test_train_forward_plan_is_cached():
    """The wrapper asks for the plan at every launch: the same arguments
    give the same plan object, without recomputing it."""
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        train_forward_plan)
    args = ('gru', 2, 32, 128, torch.float32, H100_SMEM, H100_SMS)
    assert train_forward_plan(*args) is train_forward_plan(*args)
    other = train_forward_plan('gru', 2, 32, 128, torch.bfloat16,
                               H100_SMEM, H100_SMS)
    assert other is not train_forward_plan(*args)
    assert other['path'] == 'batch_split'


def test_batch_split_refuses_what_does_not_fit():
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        batch_split_shape)
    assert batch_split_shape('gru', 60, torch.bfloat16, H100_SMEM) is None
    # less room: fewer k-splits, until not even one fits
    shape = batch_split_shape('gru', 128, torch.float32, H100_SMEM)
    fewer = batch_split_shape('gru', 128, torch.float32, shape['smem'] - 1)
    assert fewer['splits'] == shape['splits'] // 2
    # the stream's W_hh alone leaves no room for the lanes' state
    assert batch_split_shape('gru', 128, torch.float32,
                             4 * 3 * 128 * 128) is None


@pytest.mark.parametrize('cell,H,dtype,path', [
    ('gru', 64, torch.float32, 'batch_split'),
    ('gru', 128, torch.float32, 'batch_split'),
    ('gru', 64, torch.bfloat16, 'batch_split'),
    ('gru', 128, torch.bfloat16, 'batch_split'),
    ('gru', 256, torch.float32, 'cooperative'),
    ('gru', 256, torch.bfloat16, 'cooperative'),
    ('lstm', 512, torch.float32, 'cooperative'),
    ('lstm', 512, torch.bfloat16, 'cooperative'),
    ('lstm', 64, torch.float32, 'batch_split'),
    ('lstm', 128, torch.float32, 'cooperative'),
])
def test_train_backward_plan_on_h100(cell, H, dtype, path):
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        BS_BWD_MAX_SPLITS, BS_MAX_THREADS, train_backward_plan)
    plan = train_backward_plan(cell, 2, 32, H, dtype, H100_SMEM, H100_SMS)
    assert plan['path'] == path
    ng = 4 if cell == 'lstm' else 3
    if path == 'batch_split':
        item = dtype.itemsize
        assert plan['blocks'] == 2 * 32     # one per stream and batch lane
        assert item * ng * H * H <= plan['smem'] <= H100_SMEM
        assert plan['threads'] % 32 == 0
        assert H <= plan['threads'] <= BS_MAX_THREADS
        assert (ng * H) % plan['splits'] == 0
        assert plan['splits'] <= BS_BWD_MAX_SPLITS
    else:
        assert 2 * H // plan['units'] <= H100_SMS


def test_config_predictors_take_batch_split_backward():
    """Every BiGRU of the series predictors in config.yaml takes the
    batch-split backward on an H100 at the training batch; the prenet,
    postnet and decoder recurrences take the cooperative one."""
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        train_backward_plan)
    cfg = default_config()['forward_tacotron']
    batch = max(int(s.split(',')[2]) for s in cfg['training']['schedule'])
    model = cfg['model']
    dims = [model[f'{k}_rnn_dims'] for k in ('durpred', 'pitch', 'energy')]
    assert sorted(dims) == [64, 64, 128] and batch == 32
    wide = [('gru', model['prenet_dims']), ('lstm', model['rnn_dims']),
            ('gru', model['postnet_dims'])]
    for dtype in (torch.float32, torch.bfloat16):
        for H in dims:
            plan = train_backward_plan('gru', 2, batch, H, dtype, H100_SMEM,
                                       H100_SMS)
            assert plan['path'] == 'batch_split', (H, dtype)
        for cell, H in wide:
            plan = train_backward_plan(cell, 2, batch, H, dtype, H100_SMEM,
                                       H100_SMS)
            assert plan['path'] == 'cooperative', (cell, H, dtype)


def test_train_backward_plan_is_cached():
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        train_backward_plan)
    args = ('gru', 2, 32, 64, torch.float32, H100_SMEM, H100_SMS)
    assert train_backward_plan(*args) is train_backward_plan(*args)
    other = train_backward_plan('gru', 2, 32, 64, torch.bfloat16,
                                H100_SMEM, H100_SMS)
    assert other is not train_backward_plan(*args)


def test_batch_split_backward_refuses_what_does_not_fit():
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        _cooperative_bwd, batch_split_bwd_shape, train_backward_plan,
        train_forward_plan)
    # H not a whole number of 16-byte chunks
    assert batch_split_bwd_shape('gru', 60, torch.bfloat16, H100_SMEM) \
        is None
    # less room: fewer row slices, until not even one fits
    shape = batch_split_bwd_shape('gru', 128, torch.float32, H100_SMEM)
    fewer = batch_split_bwd_shape('gru', 128, torch.float32,
                                  shape['smem'] - 1)
    assert fewer['splits'] == shape['splits'] // 2
    assert batch_split_bwd_shape('gru', 128, torch.float32,
                                 4 * 3 * 128 * 128) is None
    # the wide recurrences do not fit a block at all
    assert batch_split_bwd_shape('gru', 256, torch.bfloat16,
                                 H100_SMEM) is None
    assert batch_split_bwd_shape('lstm', 512, torch.bfloat16,
                                 H100_SMEM) is None
    # the cooperative path keeps W_hh's rows in registers, up to 768
    # columns: every H that two streams fit on the SMs (U=8 at H=528), and
    # for one stream the cooperative forward refuses the same H
    assert _cooperative_bwd(2, 528, H100_SMS) == {'path': 'cooperative',
                                                  'units': 8}
    for plan in (train_backward_plan, train_forward_plan):
        with pytest.raises(ValueError, match='768 units'):
            plan('lstm', 1, 32, 776, torch.float32, H100_SMEM, H100_SMS)


@pytest.mark.parametrize('cell,H,gs,item,threads,smem', [
    # W_hh, dgh (NG*H floats), gs slices of H floats, 2 steps of dy (H
    # floats) and of the stash row (5H items)
    ('gru', 128, 16, 4, 512,
     4 * 3 * 128 * 128 + 4 * 384 + 4 * 16 * 128 + 4 * 2 * 128 + 4 * 2 * 640),
    ('gru', 64, 32, 2, 256,
     2 * 3 * 64 * 64 + 4 * 192 + 4 * 32 * 64 + 4 * 2 * 64 + 2 * 2 * 320),
    ('lstm', 64, 32, 4, 512,
     4 * 4 * 64 * 64 + 4 * 256 + 4 * 32 * 64 + 4 * 2 * 64 + 4 * 2 * 320),
    # fewer product threads than units: one owner thread per unit
    ('gru', 64, 1, 4, 64,
     4 * 3 * 64 * 64 + 4 * 192 + 4 * 64 + 4 * 2 * 64 + 4 * 2 * 320),
])
def test_bs_bwd_size_matches_the_c_layout(cell, H, gs, item, threads, smem):
    """`_bs_bwd_size` against a hand count of csrc/birnn_train.cu's
    batch-split backward: H*item/16 chunks of a row times gs slices of
    threads (at least H, whole warps), and its shared-memory layout."""
    from forwardtacotron_tpu_torch.kernels.birnn_train import _bs_bwd_size
    from forwardtacotron_tpu_torch.ops.rnn import n_gates
    assert _bs_bwd_size(n_gates(cell), H, gs, item) == (threads, smem)


def test_build_key_covers_headers(tmp_path, monkeypatch):
    from forwardtacotron_tpu_torch.kernels import _build
    (tmp_path / 'k.cu').write_text('#include "probe.cuh"\n')
    (tmp_path / 'probe.cuh').write_text('// v1\n')
    monkeypatch.setattr(_build, 'CSRC', tmp_path)
    first = _build._lib_path('k')
    assert _build._lib_path('k') == first
    (tmp_path / 'probe.cuh').write_text('// v2\n')
    second = _build._lib_path('k')
    assert second != first
    (tmp_path / 'other.h').write_text('// new header\n')
    assert _build._lib_path('k') != second
    (tmp_path / 'notes.txt').write_text('not a header\n')
    third = _build._lib_path('k')
    (tmp_path / 'notes.txt').write_text('edited\n')
    assert _build._lib_path('k') == third


def test_build_key_covers_included_sources(tmp_path, monkeypatch):
    """A source that includes another (csrc/birnn_train_staged.cu includes
    csrc/birnn_train.cu) is rebuilt when the included one changes."""
    from forwardtacotron_tpu_torch.kernels import _build
    (tmp_path / 'base.cu').write_text('// v1\n')
    (tmp_path / 'variant.cu').write_text('#include "base.cu"\n')
    monkeypatch.setattr(_build, 'CSRC', tmp_path)
    first = _build._lib_path('variant')
    (tmp_path / 'base.cu').write_text('// v2\n')
    assert _build._lib_path('variant') != first


def test_probe_build_is_a_library_of_its_own(tmp_path, monkeypatch):
    from forwardtacotron_tpu_torch.kernels import _build
    (tmp_path / 'k.cu').write_text('// kernel\n')
    monkeypatch.setattr(_build, 'CSRC', tmp_path)
    normal = _build._lib_path('k')
    monkeypatch.setattr(_build, 'PROBE', True)
    assert '-DFTT_PROBE' in _build._flags()
    assert _build._lib_path('k') != normal


def test_sampler_scratch_bytes():
    """Keys (3 slots of uint64 per lane), float32 logits, then the seven
    published vectors in the compute type, each part 16-byte aligned."""
    from forwardtacotron_tpu_torch.kernels.wavernn_sample import (
        scratch_bytes)
    assert scratch_bytes(64, 512, 512, 512, 2) == \
        3 * 8 * 64 + 4 * 64 * 512 + 2 * 64 * (5 * 512 + 2 * 512)
    # one lane: the 24 bytes of keys and the 4 * 10 of logits round up
    assert scratch_bytes(1, 8, 8, 10, 4) == 32 + 48 + 4 * (5 * 8 + 2 * 8)


# ------------------------------------------------- kernel #1's inference plan

@pytest.mark.parametrize('cell,S,H,cluster', [
    ('gru', 6, 128, 1),      # the fused series predictors
    ('gru', 2, 256, 8),      # the prenet and postnet CBHG
    ('lstm', 2, 512, 16),    # the decoder
])
def test_serving_shapes_plan_stream_local_on_h100(cell, S, H, cluster):
    """Every batch-1 bf16 shape of the serving path takes the stream-local
    path with a cluster whose share of W_hh fits a block, and its S
    clusters are counted resident."""
    from forwardtacotron_tpu_torch.kernels.birnn import (
        SL_MAX_THREADS, inference_plan, resident_clusters)
    plan = inference_plan(cell, S, 1, H, torch.bfloat16, H100_SMEM,
                          H100_SMS)
    assert plan['path'] == 'stream_local'
    assert plan['cluster'] == cluster and plan['clusters'] == S
    assert S <= resident_clusters(cluster, H100_SMS)
    ng = 4 if cell == 'lstm' else 3
    # the block's rows of W_hh: in shared memory, or in the registers of
    # its product threads (kSlRows rows, 2 bf16 chunks of 16 bytes each)
    rows = ng * H // cluster
    assert plan['w_smem'] + plan['threads'] * 4 * 2 * 16 >= rows * H * 2
    assert plan['smem'] <= H100_SMEM
    assert plan['threads'] % 32 == 0
    assert H // cluster <= plan['threads'] <= SL_MAX_THREADS


@pytest.mark.parametrize('cell,S,B,H,dtype,path', [
    # 4 MB a stream: only clusters of 16 hold it
    ('lstm', 2, 1, 512, torch.float32, 'stream_local'),
    ('gru', 2, 1, 256, torch.float32, 'stream_local'),
    ('gru', 6, 1, 128, torch.float32, 'stream_local'),
    # evaluate() at batch 32 in float32: in waves where needed
    ('lstm', 2, 32, 512, torch.float32, 'stream_local'),
    ('gru', 2, 32, 256, torch.float32, 'stream_local'),
    ('gru', 2, 32, 128, torch.float32, 'stream_local'),
    ('gru', 2, 32, 64, torch.float32, 'stream_local'),
    # batch 8: 16 clusters of the decoder, in two waves of 8 blocks
    ('lstm', 2, 8, 512, torch.bfloat16, 'stream_local'),
    ('gru', 6, 8, 128, torch.bfloat16, 'stream_local'),
    ('gru', 2, 8, 256, torch.float32, 'stream_local'),
    # H not a whole number of 16-byte chunks: no cluster size fits
    ('gru', 2, 1, 30, torch.float32, 'cooperative'),
    ('gru', 2, 32, 100, torch.bfloat16, 'cooperative'),
])
def test_inference_plan_on_h100(cell, S, B, H, dtype, path):
    from forwardtacotron_tpu_torch.kernels.birnn import (
        inference_plan, resident_clusters)
    plan = inference_plan(cell, S, B, H, dtype, H100_SMEM, H100_SMS)
    assert plan['path'] == path
    if path == 'stream_local':
        assert plan['waves'] == -(-S * B // resident_clusters(
            plan['cluster'], H100_SMS))
        assert plan['smem'] <= H100_SMEM
    else:
        assert S * H // plan['units'] <= H100_SMS


@pytest.mark.parametrize('cell,S,B,H,dtype', [
    ('gru', 6, 1, 128, torch.bfloat16), ('gru', 2, 1, 256, torch.bfloat16),
    ('lstm', 2, 1, 512, torch.bfloat16), ('lstm', 2, 32, 512, torch.float32),
    ('gru', 2, 32, 256, torch.float32), ('gru', 2, 32, 64, torch.float32),
    ('lstm', 2, 8, 512, torch.bfloat16)])
def test_inference_plan_takes_the_least_step_estimate(cell, S, B, H, dtype):
    """Of the cluster sizes that fit, the plan takes the one of the least
    estimated launch, waves x step estimate, the smaller on a tie."""
    from forwardtacotron_tpu_torch.kernels.birnn import (
        SL_CLUSTERS, inference_plan, resident_clusters, step_estimate_us,
        stream_local_shape)
    plan = inference_plan(cell, S, B, H, dtype, H100_SMEM, H100_SMS)
    est = {c: -(-S * B // resident_clusters(c, H100_SMS))
           * step_estimate_us(H, dtype, sh) for c in SL_CLUSTERS
           if (sh := stream_local_shape(cell, H, dtype, H100_SMEM, c))}
    least = min(est.values())
    assert est[plan['cluster']] == pytest.approx(least)
    assert plan['cluster'] == min(
        c for c, e in est.items() if e == pytest.approx(least))


def test_step_estimate():
    """0.15 µs a chunk of a row per product thread, plus the fixed cost
    of a block or a cluster; the decoder's W_hh fits no fewer than 8
    blocks."""
    from forwardtacotron_tpu_torch.kernels.birnn import (
        step_estimate_us, stream_local_shape)
    bf16 = torch.bfloat16
    assert stream_local_shape('lstm', 512, bf16, H100_SMEM, 4) is None
    shape = stream_local_shape('gru', 128, bf16, H100_SMEM, 1)
    assert step_estimate_us(128, bf16, shape) == pytest.approx(
        0.15 * 4 + 0.7)


@pytest.mark.parametrize('what,cell,H,cluster,waves', [
    ('decoder', 'lstm', 512, 16, 10),   # only 16 blocks hold it
    ('postnet', 'gru', 256, 4, 3),
    ('prenet', 'gru', 256, 4, 3),
    ('pitch', 'gru', 128, 1, 1),
    ('dur/energy', 'gru', 64, 1, 1),
])
def test_evaluate_shapes_plan_stream_local_in_waves(what, cell, H, cluster,
                                                    waves):
    """evaluate()'s five recurrences (B=32, float32, 64 clusters) take the
    stream-local path at the cluster size that measured fastest on the
    H100 (PERF.md, PR 5), in waves where fewer than 64 are resident."""
    from forwardtacotron_tpu_torch.kernels.birnn import inference_plan
    plan = inference_plan(cell, 2, 32, H, torch.float32, H100_SMEM,
                          H100_SMS)
    assert (plan['path'], plan['cluster'], plan['waves']) == (
        'stream_local', cluster, waves), what


def test_inference_plan_raises_where_nothing_fits():
    """An LSTM of H=1024 fits neither a portable cluster nor, with S=2, a
    cooperative grid of at most 8 units a block."""
    from forwardtacotron_tpu_torch.kernels.birnn import inference_plan
    with pytest.raises(ValueError, match='do not fit'):
        inference_plan('lstm', 2, 1, 1024, torch.bfloat16, H100_SMEM,
                       H100_SMS)


def test_inference_plan_is_cached():
    from forwardtacotron_tpu_torch.kernels.birnn import inference_plan
    args = ('gru', 6, 1, 128, torch.bfloat16, H100_SMEM, H100_SMS)
    assert inference_plan(*args) is inference_plan(*args)


def test_forced_paths():
    """`path=` and `cluster=` force a launch's plan; a forced cluster that
    does not fit, or a stream-local path the plan does not give, raises."""
    from types import SimpleNamespace
    from forwardtacotron_tpu_torch.kernels.birnn import _plan
    props = SimpleNamespace(shared_memory_per_block_optin=H100_SMEM,
                            multi_processor_count=H100_SMS)
    bf16, f32 = torch.bfloat16, torch.float32
    assert _plan('lstm', 2, 1, 512, bf16, props, None, None)['cluster'] == 16
    assert _plan('lstm', 2, 1, 512, bf16, props, 'cooperative', None) == {
        'path': 'cooperative', 'units': 8}
    forced = _plan('lstm', 2, 1, 512, bf16, props, 'stream_local', 8)
    assert forced['path'] == 'stream_local' and forced['cluster'] == 8
    with pytest.raises(ValueError, match='clusters of 8'):
        _plan('lstm', 2, 1, 512, f32, props, 'stream_local', 8)
    with pytest.raises(ValueError, match='stream-local path does not'):
        _plan('gru', 2, 32, 30, f32, props, 'stream_local', None)
    with pytest.raises(ValueError, match='unknown path'):
        _plan('gru', 2, 1, 64, f32, props, 'batch_split', None)


@pytest.mark.parametrize('cell,H,cluster,splits,item,size', [
    # W_hh chunks outside registers (16 bytes, R rows x KS slices x
    # chunks past the registers' 2 (bf16) or 4 (float32)), KS x R partial
    # sums, two buffers of H floats, two steps of R gate inputs
    ('lstm', 512, 8, 8, 2,
     (512, 16 * 256 * 8 * 6 + 4 * (8 * 256 + 2 * 512) + 2 * 2 * 256)),
    ('gru', 128, 1, 4, 2,
     (384, 16 * 384 * 4 * 2 + 4 * (4 * 384 + 2 * 128) + 2 * 2 * 384)),
    ('gru', 256, 8, 16, 4, (384, 4 * (16 * 96 + 2 * 256) + 4 * 2 * 96)),
    # fewer product threads than units: one owner thread per unit
    ('gru', 100, 1, 1, 4,
     (128, 16 * 300 * 21 + 4 * (300 + 2 * 100) + 4 * 2 * 300)),
    # refused: U not a whole number of chunks; too many threads; C not a
    # power of two
    ('gru', 100, 1, 1, 2, None), ('gru', 128, 1, 8, 2, None),
    ('gru', 96, 3, 1, 4, None),
])
def test_sl_size_matches_the_c_layout(cell, H, cluster, splits, item, size):
    """`_sl_size` against a hand count of csrc/birnn.cu's sl_size."""
    from forwardtacotron_tpu_torch.kernels.birnn import _sl_size
    from forwardtacotron_tpu_torch.ops.rnn import n_gates
    got = _sl_size(n_gates(cell), H, cluster, splits, item)
    assert (got[:2] if got else None) == size


# ------------------------------------------ kernel #2's cluster forward plan

@pytest.mark.parametrize('what,cell,S,B,H,dtype,plan', [
    # the training step's shapes at batch 32 (PERF.md: the probe
    # measured every (C, lanes) that fits; the plan's choice was the
    # fastest of them, and faster than the cooperative path)
    ('decoder', 'lstm', 2, 32, 512, torch.bfloat16, ('cluster', 8, 8, 1)),
    # in float32 only clusters of 16 in groups of 8 fit: two waves, a tie
    # with the cooperative path on the card
    ('decoder', 'lstm', 2, 32, 512, torch.float32, ('cooperative',)),
    ('postnet', 'gru', 2, 32, 256, torch.float32, ('cluster', 8, 8, 1)),
    ('postnet', 'gru', 2, 32, 256, torch.bfloat16, ('cluster', 8, 8, 1)),
    ('wavernn', 'gru', 1, 32, 512, torch.float32, ('cluster', 16, 8, 1)),
    ('wavernn', 'gru', 1, 32, 512, torch.bfloat16, ('cluster', 16, 8, 1)),
    # grad_accum's micro-batches: 16 lanes are one wave of the decoder's
    # clusters of 16 in float32, 8 lanes a wave of two, 1 lane a group
    # with 7 masked lanes (each measured faster than the cooperative path)
    ('decoder grad_accum 2', 'lstm', 2, 16, 512, torch.float32,
     ('cluster', 16, 8, 1)),
    ('decoder grad_accum 4', 'lstm', 2, 8, 512, torch.float32,
     ('cluster', 16, 8, 1)),
    ('decoder B=1', 'lstm', 2, 1, 512, torch.float32, ('cluster', 16, 8, 1)),
    ('decoder B=1', 'lstm', 2, 1, 512, torch.bfloat16,
     ('cluster', 16, 8, 1)),
    ('decoder grad_accum 4', 'lstm', 2, 8, 512, torch.bfloat16,
     ('cluster', 16, 8, 1)),
    ('postnet grad_accum 4', 'gru', 2, 8, 256, torch.float32,
     ('cluster', 16, 8, 1)),
    # one lane: a group of 8 with 7 masked lanes
    ('wavernn B=1', 'gru', 1, 1, 512, torch.bfloat16, ('cluster', 16, 8, 1)),
])
def test_cluster_plan_on_h100(what, cell, S, B, H, dtype, plan):
    """The forward's plan at the shapes the training paths give it: path,
    cluster size, lanes a group and waves."""
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        train_forward_plan)
    got = train_forward_plan(cell, S, B, H, dtype, H100_SMEM, H100_SMS)
    assert (got['path'],) + tuple(got[k] for k in ('cluster', 'lanes',
                                                   'waves')
                                  if k in got) == plan, what


@pytest.mark.parametrize('cell,S,B,H,dtype', [
    ('lstm', 2, 32, 512, torch.bfloat16), ('gru', 2, 32, 256, torch.float32),
    ('gru', 2, 32, 256, torch.bfloat16), ('gru', 1, 32, 512, torch.float32),
    ('gru', 1, 32, 512, torch.bfloat16), ('lstm', 2, 16, 512, torch.float32),
    ('gru', 2, 13, 256, torch.bfloat16)])
def test_cluster_plan_takes_the_least_estimate(cell, S, B, H, dtype):
    """Of the (C, lanes) that fit, the plan takes the one of the least
    estimated launch, waves x step estimate, where the S x ceil(B / lanes)
    clusters run in waves of `resident_clusters(C)`."""
    from forwardtacotron_tpu_torch.kernels.birnn import resident_clusters
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        cl_step_estimate_us, cluster_shapes, train_forward_plan)
    plan = train_forward_plan(cell, S, B, H, dtype, H100_SMEM, H100_SMS)
    est = {}
    for sh in cluster_shapes(cell, H, dtype, H100_SMEM):
        clusters = S * -(-B // sh['lanes'])
        waves = -(-clusters // resident_clusters(sh['cluster'], H100_SMS))
        est[(sh['cluster'], sh['lanes'])] = waves * cl_step_estimate_us(
            cell, H, dtype, sh)
    assert est[(plan['cluster'], plan['lanes'])] == pytest.approx(
        min(est.values()))
    assert plan['clusters'] == S * -(-B // plan['lanes'])


def test_cluster_path_in_one_wave():
    """The cluster path is planned where its clusters run in one wave; in
    two (the float32 decoder at batch 32) the cooperative path is, unless
    it cannot launch (six streams of H=512 need 384 blocks of 8 units)."""
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        _cluster_plan, train_forward_plan)
    f32 = torch.float32
    for B, waves, path in ((32, 2, 'cooperative'), (16, 1, 'cluster')):
        cl = _cluster_plan('lstm', 2, B, 512, f32, H100_SMEM, H100_SMS)
        assert cl['waves'] == waves
        assert train_forward_plan('lstm', 2, B, 512, f32, H100_SMEM,
                                  H100_SMS)['path'] == path
    plan = train_forward_plan('lstm', 6, 32, 512, f32, H100_SMEM, H100_SMS)
    assert plan['path'] == 'cluster' and plan['waves'] == 4


@pytest.mark.parametrize('cell,S,H,dtype', [
    # no cluster of up to 16 blocks holds a stream's float32 W_hh
    ('lstm', 1, 768, torch.float32), ('gru', 1, 768, torch.float32),
    # H / C is never a whole number of 16-byte pieces
    ('gru', 2, 200, torch.bfloat16)])
def test_cooperative_forward_where_no_cluster_fits(cell, S, H, dtype):
    """The cooperative forward is planned where neither the batch-split
    nor any cluster shape fits."""
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        _cluster_plan, batch_split_shape, cluster_shapes,
        train_forward_plan)
    assert batch_split_shape(cell, H, dtype, H100_SMEM) is None
    assert cluster_shapes(cell, H, dtype, H100_SMEM) == []
    assert _cluster_plan(cell, S, 32, H, dtype, H100_SMEM, H100_SMS) is None
    plan = train_forward_plan(cell, S, 32, H, dtype, H100_SMEM, H100_SMS)
    assert plan['path'] == 'cooperative' and H % plan['units'] == 0


def test_step_estimates():
    """The plan's step estimate: the cluster path's fixed cost grows by
    CL_FIXED_US_PER_LANE a lane, its product is counted in mma tiles
    (bf16) or FMAs (float32) of a block."""
    from forwardtacotron_tpu_torch.kernels import birnn_train as bt
    shape = {'cluster': 16, 'lanes': 16, 'product': 'mma', 'reg': 8}
    # decoder bf16 in clusters of 16: 8 m-tiles x 32 k-tiles x 2 n-tiles
    assert bt.cl_step_estimate_us('lstm', 512, torch.bfloat16, shape) == \
        pytest.approx(bt.CL_FIXED_US + 16 * bt.CL_FIXED_US_PER_LANE
                      + 512 * bt.CL_US_PER_MMA)
    # float32 by the register share: 8 chunks a row spill
    for reg in (4, 8):
        shape = {'cluster': 8, 'lanes': 8, 'product': 'fma', 'reg': reg}
        assert bt.cl_step_estimate_us('gru', 256, torch.float32, shape) == \
            pytest.approx(bt.CL_FIXED_US + 8 * bt.CL_FIXED_US_PER_LANE
                          + 96 * 256 * 8 * bt.CL_US_PER_FMA[reg])
    assert bt.CL_US_PER_FMA[8] > bt.CL_US_PER_FMA[4]


@pytest.mark.parametrize('cell,H,C,lanes,splits,reg,item,size', [
    # bf16: warps of 16 rows x KS slices, (tiles - 8) A tiles a warp in
    # shared memory (512 bytes each); h: 2 x lanes x (H + 8) x 2 bytes;
    # partials KS x lanes x (R + 4) floats; gate inputs 2 x NG x lanes x U
    ('lstm', 512, 8, 8, 1, 8, 2,
     (512, 512 * 16 * 24 + 2 * 2 * 8 * 520 + 4 * 8 * 260 + 2 * 2 * 4 * 8 * 64)),
    ('lstm', 512, 16, 16, 2, 8, 2,
     (512, 512 * 8 * 2 * 8 + 2 * 2 * 16 * 520 + 4 * 2 * 16 * 132
      + 2 * 2 * 4 * 16 * 32)),
    # one warp's k-tiles all in registers; fewer product threads than
    # (lane, unit) owners
    ('gru', 256, 8, 8, 2, 8, 2,
     (384, 0 + 2 * 2 * 8 * 264 + 4 * 2 * 8 * 100 + 2 * 2 * 3 * 8 * 32)),
    # float32: rows / 2 x KS threads, (chunks - reg) 16-byte chunks a row
    # and slice in shared memory; h rows of H + 4 floats
    ('lstm', 512, 16, 8, 8, 8, 4,
     (512, 16 * 128 * 8 * 8 + 4 * 2 * 8 * 516 + 4 * 8 * 8 * 132
      + 4 * 2 * 4 * 8 * 32)),
    ('gru', 512, 16, 8, 8, 4, 4,
     (384, 16 * 96 * 8 * 12 + 4 * 2 * 8 * 516 + 4 * 8 * 8 * 100
      + 4 * 2 * 3 * 8 * 32)),
    # refused: 16 lanes in float32; U not a whole number of 16 bytes; rows
    # not whole m-tiles; a register count the kernel is not built for; C
    # not a power of two; too many threads
    ('gru', 256, 8, 16, 8, 4, 4, None), ('gru', 100, 4, 8, 1, 4, 4, None),
    ('gru', 96, 8, 8, 1, 8, 2, None), ('gru', 256, 8, 8, 8, 6, 4, None),
    ('gru', 96, 3, 8, 1, 4, 4, None), ('lstm', 512, 16, 8, 16, 8, 4, None),
])
def test_cl_size_matches_the_c_layout(cell, H, C, lanes, splits, reg, item,
                                      size):
    """`_cl_size` against a hand count of csrc/birnn_train.cu's cl_layout."""
    from forwardtacotron_tpu_torch.kernels.birnn_train import _cl_size
    from forwardtacotron_tpu_torch.ops.rnn import n_gates
    got = _cl_size(n_gates(cell), H, C, lanes, splits, reg, item)
    assert (got[:2] if got else None) == size


@pytest.mark.parametrize('cell,H,C,lanes,splits,reg,size', [
    # float32 on the tensor cores (3xTF32): 16 x 8 A tiles of 512 bytes,
    # h rows of H + 4 floats; the decoder's 16-lane group fits only with 16
    # A tiles of a warp in registers
    ('lstm', 512, 16, 16, 2, 16,
     (512, 512 * 8 * 2 * 16 + 4 * 2 * 16 * 516 + 4 * 2 * 16 * 132
      + 4 * 2 * 4 * 16 * 32)),
    ('gru', 512, 16, 8, 2, 8,
     (384, 512 * 6 * 2 * 24 + 4 * 2 * 8 * 516 + 4 * 2 * 8 * 100
      + 4 * 2 * 3 * 8 * 32)),
    ('gru', 256, 8, 8, 2, 12, None),
])
def test_tf32x3_size_matches_the_c_layout(cell, H, C, lanes, splits, reg,
                                          size):
    """The probe-only 3xTF32 product's block (csrc/birnn_train_tf32.cu,
    cl_layout of its float32 ClMmaProduct), as tools/torch_kernel_probe.py
    sizes it, against a hand count; the plan never takes that product."""
    import importlib.util
    from pathlib import Path
    from forwardtacotron_tpu_torch.kernels.birnn_train import cluster_shapes
    from forwardtacotron_tpu_torch.ops.rnn import n_gates
    spec = importlib.util.spec_from_file_location(
        'torch_kernel_probe', Path(__file__).resolve().parent.parent
        / 'tools' / 'torch_kernel_probe.py')
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    got = probe.tf32_size(n_gates(cell), H, C, lanes, splits, reg)
    assert (got[:2] if got else None) == size
    if size is not None:
        shape = probe.tf32_shape(cell, H, H100_SMEM, C, lanes)
        assert shape['product'] == 'tf32x3' and shape['smem'] <= H100_SMEM
    assert all(sh['product'] == 'fma' for sh in cluster_shapes(
        cell, H, torch.float32, H100_SMEM))


def test_cluster_shape_prefers_registers_that_fit():
    """float32 keeps 4 chunks of a row in registers where the rest fits
    shared memory, else 8 (the decoder's W_hh share needs both); the most
    k-slices within 512 threads."""
    from forwardtacotron_tpu_torch.kernels.birnn_train import cluster_shape
    f32 = torch.float32
    assert cluster_shape('gru', 512, f32, H100_SMEM, 16, 8)['reg'] == 4
    dec = cluster_shape('lstm', 512, f32, H100_SMEM, 16, 8)
    assert (dec['reg'], dec['splits'], dec['threads']) == (8, 8, 512)
    assert cluster_shape('lstm', 512, f32, dec['smem'] - 1, 16, 8) is None
    assert cluster_shape('lstm', 512, f32, H100_SMEM, 8, 8) is None
    assert cluster_shape('lstm', 512, torch.bfloat16, H100_SMEM, 8,
                         8)['reg'] == 8


def test_forced_forward_paths():
    """`path=` forces a forward's plan, a shape the forced path does not
    take raises; `_cluster_plan(..., cluster)` gives any cluster shape
    that fits (for `launch_forward`), None where it does not."""
    from types import SimpleNamespace
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        _cluster_plan, _forward_plan)
    props = SimpleNamespace(shared_memory_per_block_optin=H100_SMEM,
                            multi_processor_count=H100_SMS)
    bf16, f32 = torch.bfloat16, torch.float32
    assert _forward_plan('lstm', 2, 32, 512, bf16, props)['path'] == 'cluster'
    assert _forward_plan('lstm', 2, 32, 512, bf16, props, 'cooperative') == {
        'path': 'cooperative', 'units': 8}
    forced = _forward_plan('lstm', 2, 32, 512, f32, props, 'cluster')
    assert (forced['path'], forced['cluster'], forced['waves']) == (
        'cluster', 16, 2)
    # the cluster path forced where the batch-split one is planned
    forced = _forward_plan('gru', 2, 32, 128, f32, props, 'cluster')
    assert forced['path'] == 'cluster' and _forward_plan(
        'gru', 2, 32, 128, f32, props)['path'] == 'batch_split'
    forced = _cluster_plan('lstm', 2, 32, 512, bf16, H100_SMEM, H100_SMS,
                           (16, 16))
    assert (forced['cluster'], forced['lanes'], forced['clusters']) == (
        16, 16, 4)
    assert _cluster_plan('lstm', 2, 32, 512, f32, H100_SMEM, H100_SMS,
                         (8, 8)) is None
    with pytest.raises(ValueError, match='cluster path does not'):
        _forward_plan('gru', 2, 32, 30, f32, props, 'cluster')
    with pytest.raises(ValueError, match='batch_split path does not'):
        _forward_plan('lstm', 2, 32, 512, f32, props, 'batch_split')
    with pytest.raises(ValueError, match='unknown path'):
        _forward_plan('lstm', 2, 32, 512, f32, props, 'stream_local')


def test_cluster_plan_is_cached():
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        train_forward_plan)
    args = ('lstm', 2, 32, 512, torch.bfloat16, H100_SMEM, H100_SMS)
    assert train_forward_plan(*args) is train_forward_plan(*args)
    assert train_forward_plan(*args)['path'] == 'cluster'
