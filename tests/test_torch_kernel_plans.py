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
