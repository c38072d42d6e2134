"""The port's kernel launch plans and build key, on the CPU.

- `kernels/birnn_train.py:train_forward_plan` with an H100's numbers
  (232,448 bytes of shared memory per block, 132 SMs): the training
  step's series-predictor BiGRUs (config.yaml: H=64 duration/energy,
  H=128 pitch) take the batch-split path in float32 and bfloat16; the CBHG
  GRUs (H=256) and the decoder LSTM (H=512) take the cooperative one.
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
    ('gru', 256, torch.float32, 'cooperative'),
    ('gru', 256, torch.bfloat16, 'cooperative'),
    ('lstm', 512, torch.float32, 'cooperative'),
    ('lstm', 512, torch.bfloat16, 'cooperative'),
    ('lstm', 64, torch.float32, 'batch_split'),
    ('lstm', 128, torch.float32, 'cooperative'),
])
def test_train_forward_plan_on_h100(cell, H, dtype, path):
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        BS_MAX_THREADS, train_forward_plan)
    plan = train_forward_plan(cell, 2, 32, H, dtype, H100_SMEM, H100_SMS)
    assert plan['path'] == path
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
