"""The port's data parallelism (`forwardtacotron_tpu_torch/parallel/`) on
the CPU: the mesh and its refusals, each rank's rows against the JAX
package's `host_local_batch_to_global`, and steps on two gloo ranks
(`tests/torch_ranks.py`, one spawn for the module) against one process on
the global batch:

- the student's step against JAX's single-device
  `build_forward_train_step`, on a batch whose two halves have unequal
  lengths (so the ranks' mask sums and batch statistics differ), at
  `tests/test_parallel.py`'s tolerances: loss rtol 1e-4, parameters atol
  2e-5; the running statistics at tests/test_torch_train_options.py's
  (rtol 1e-5, atol 1e-6); the two ranks bit-identical. The per-rank
  variant (each rank's loss and statistics over its own rows, only the
  gradients averaged) misses the loss and the statistics by more than
  these tolerances;
- the teacher's, WaveRNN's, HiFi-GAN's, the aligner's and FastPitch's
  steps against the port's own one-process step: losses rtol 1e-4, the
  averaged gradients rtol 1e-4 / atol 1e-6 (measured: 3e-8 at most, on
  gradients up to 5e-2), parameters atol 2e-5 where |g| > 1e-6 and within
  2 lr elsewhere (Adam's first update lr g / (|g| + 1e-8) turns the 1e-10
  float32 difference of a gradient of 4e-9 into 2.4e-5: the teacher's
  conv_project1 measured), running statistics rtol 1e-5 / atol 1e-6;
- a checkpoint directory written by both ranks, and by one process.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import torch_ranks
from test_torch_forward_train import _jax_batch, _state_dict_of
from test_torch_train_options import _adam_mu

LOSS_RTOL, PARAM_ATOL = 1e-4, 2e-5
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _student_weights():
    """The student's weights of tests/test_torch_forward_train.py at
    torch_ranks' widths (random running statistics) as (JAX variables,
    the port's state_dict)."""
    from forwardtacotron_tpu.models.forward_tacotron import (
        ForwardTacotron as JaxFT)
    jmodel = JaxFT(num_chars=torch_ranks.FT_CHARS, n_mels=torch_ranks.FT_MELS,
                   **torch_ranks.FT_TINY)
    batch = torch_ranks.student_batch()
    variables = jax.jit(lambda k: jmodel.init(
        {'params': k}, _jax_batch(batch), train=False))(
            jax.random.PRNGKey(0))
    rng = np.random.RandomState(5)

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else
                (rng.randn(*v.shape) * 0.1 if k == 'mean'
                 else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
                for k, v in tree.items()}
    variables = {'params': jax.tree.map(np.asarray, variables['params']),
                 'batch_stats': fill(variables['batch_stats'])}
    return jmodel, variables, _state_dict_of(variables, torch_ranks.FT_TINY)


def _rows_batch():
    rng = np.random.RandomState(0)
    return {'x': rng.randint(0, 9, (8, 5)).astype(np.int32),
            'mel': rng.randn(8, 12, 4).astype(np.float32),
            'scalar_like': rng.randn(3).astype(np.float32)}   # replicated


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """One spawn of two gloo ranks for the module (torch_ranks.steps_rank):
    (each rank's results, the directory they wrote to, the JAX model and
    variables, the initial state_dict)."""
    out = tmp_path_factory.mktemp('ranks')
    jmodel, variables, sd = _student_weights()
    torch.save({'state_dict': sd, 'batch': torch_ranks.student_batch(),
                'rows_batch': _rows_batch()}, out / 'init.pt')
    torch_ranks.run_ranks(torch_ranks.steps_rank, out, str(out),
                          str(out / 'init.pt'))
    results = [torch.load(out / f'steps_{r}.pt', weights_only=False)
               for r in range(2)]
    return results, out, jmodel, variables, sd


def test_mesh_and_its_refusals():
    from forwardtacotron_tpu.parallel.mesh import make_mesh as jax_mesh
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.parallel import (Mesh, make_mesh,
                                                    mesh_from_config)
    mesh = make_mesh(devices=['cpu', 'cpu'])
    want = jax_mesh(n_data=2, devices=jax.devices()[:2])
    assert isinstance(mesh, Mesh) and mesh.shape == dict(want.shape)
    assert mesh.group is None and mesh.rank == 0 and mesh.size == 2
    assert mesh.devices == [torch.device('cpu')] * 2
    # torch.cuda is unavailable here: every default mesh is the CPU's
    assert make_mesh().devices == [torch.device('cpu')]
    cfg = default_config()
    assert cfg['tpu']['mesh'] == {'data': -1, 'model': 1}
    assert mesh_from_config(cfg, devices=['cpu'] * 3).shape == {
        'data': 3, 'model': 1}
    with pytest.raises(ValueError, match='does not match'):
        make_mesh(n_data=4, devices=['cpu', 'cpu'])
    cfg['tpu']['mesh']['model'] = 2
    with pytest.raises(ValueError, match=r'tpu\.mesh\.model'):
        mesh_from_config(cfg, devices=['cpu'] * 4)
    with pytest.raises(ValueError, match=r'tpu\.mesh\.model'):
        make_mesh(n_data=2, n_model=2, devices=['cpu'] * 4)
    # a trainer's mesh spans the ranks of a process group
    from forwardtacotron_tpu_torch.train import common as tc
    with pytest.raises(ValueError, match='process group'):
        tc.trainer_mesh(default_config(), mesh)


def test_maybe_initialize_is_a_no_op_without_torchrun(monkeypatch):
    from forwardtacotron_tpu_torch.parallel import (is_main_process,
                                                    maybe_initialize,
                                                    training_device)
    for var in ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK',
                'LOCAL_RANK'):
        monkeypatch.delenv(var, raising=False)
    assert maybe_initialize({}) is False
    assert maybe_initialize(None) is False
    assert maybe_initialize({'tpu': {'mesh': {'data': -1}}}) is False
    assert training_device({}, 'cpu') == torch.device('cpu')
    assert not torch.distributed.is_initialized() and is_main_process()


def test_process_slice_and_local_batch_match_jax():
    """At one process: JAX's `host_local_batch_to_global` values and
    `process_slice`; the port's rows of a one-device mesh are the batch."""
    from forwardtacotron_tpu.parallel.distributed import (
        host_local_batch_to_global, process_slice as jax_slice)
    from forwardtacotron_tpu.parallel.mesh import make_mesh as jax_mesh
    from forwardtacotron_tpu_torch.parallel import (local_batch, make_mesh,
                                                    process_slice)
    batch = _rows_batch()
    want = host_local_batch_to_global(jax_mesh(), batch)
    got = local_batch(make_mesh(devices=['cpu']), batch)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert process_slice(8) == jax_slice(8) == slice(0, 8)
    assert process_slice(6) == slice(0, 6)


def test_rank_rows_are_jax_shards(ranks):
    """On two ranks: rank r's rows are the r-th shard of JAX's batch over a
    2-device mesh (leading axes that divide sliced, the rest whole);
    with grad_accum 2 they are rank r's shard of each micro-batch."""
    from forwardtacotron_tpu.parallel.distributed import (
        host_local_batch_to_global)
    from forwardtacotron_tpu.parallel.mesh import make_mesh as jax_mesh
    results = ranks[0]
    batch = _rows_batch()
    want = host_local_batch_to_global(
        jax_mesh(n_data=2, devices=jax.devices()[:2]), batch)
    for r, res in enumerate(results):
        assert res['process_slice'] == slice(4 * r, 4 * r + 4)
        for k, v in want.items():
            shard = np.asarray(v.addressable_shards[r].data)
            np.testing.assert_array_equal(res['rows'][k].numpy(), shard, k)
        micro = np.concatenate([batch['x'][2 * r:2 * r + 2],
                                batch['x'][4 + 2 * r:6 + 2 * r]])
        np.testing.assert_array_equal(res['rows_micro']['x'].numpy(), micro)


def _jax_step(jmodel, variables, batch):
    from forwardtacotron_tpu.train import common as jtc
    optimizer = jtc.make_optimizer(torch_ranks.FT_TRAIN['clip_grad_norm'],
                                   lr=torch_ranks.LR)
    state = jtc.TrainState(params=variables['params'],
                           batch_stats=variables['batch_stats'],
                           opt_state=optimizer.init(variables['params']),
                           step=jnp.asarray(0, jnp.int32), ema_params=None)
    step = jax.jit(jtc.build_forward_train_step(jmodel, optimizer,
                                                torch_ranks.FT_TRAIN))
    state, metrics = step(state, _jax_batch(batch), jax.random.PRNGKey(0))
    after = _state_dict_of(state.variables, torch_ranks.FT_TINY)
    grads = _state_dict_of({'params': jax.tree.map(
        lambda m: np.asarray(m) / 0.1, _adam_mu(state.opt_state)),
        'batch_stats': variables['batch_stats']}, torch_ranks.FT_TINY)
    return {k: float(v) for k, v in metrics.items()}, after, grads


def _misses(metrics, after, want_metrics, want_after):
    """(relative loss miss, max parameter miss, max relative statistics
    miss)."""
    loss = abs(metrics['loss'] - want_metrics['loss']) \
        / abs(want_metrics['loss'])
    params = max(float((after[k] - want_after[k]).abs().max())
                 for k in after if not k.endswith(('running_mean',
                                                   'running_var',
                                                   'num_batches_tracked')))
    stats = max(float(((after[k] - want_after[k]).abs()
                       / want_after[k].abs().clamp(min=1e-3)).max())
                for k in after if k.endswith(('running_mean',
                                              'running_var')))
    return loss, params, stats


def test_two_rank_student_step_matches_jax_single_device(ranks):
    """Two ranks of 2 rows each (x_len 10, 7 and 4, 9) against JAX's one
    device on the 4 rows; the ranks' parameters are bit-identical."""
    results, _, jmodel, variables, _ = ranks
    batch = torch_ranks.student_batch()
    want_metrics, want_after, want_grads = _jax_step(jmodel, variables,
                                                     batch)
    (m0, after0, grads0), (m1, after1, grads1) = (r['student']
                                                  for r in results)
    for k in after0:
        assert torch.equal(after0[k], after1[k]), k
    for k in grads0:
        assert torch.equal(grads0[k], grads1[k]), k
    assert m0 == m1
    for k in ('loss', 'mel_loss', 'dur_loss', 'pitch_loss', 'energy_loss',
              'grad_norm'):
        np.testing.assert_allclose(m0[k], want_metrics[k], rtol=LOSS_RTOL,
                                   err_msg=k)
    stats = [k for k in after0 if k.endswith(('running_mean',
                                              'running_var'))]
    assert len(stats) > 10
    for k, v in after0.items():
        if k.endswith('num_batches_tracked'):
            continue
        if k in stats:
            np.testing.assert_allclose(v.numpy(), want_after[k].numpy(),
                                       rtol=STATS_RTOL, atol=STATS_ATOL,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), want_after[k].numpy(),
                                       atol=PARAM_ATOL, err_msg=k)
    for k, g in grads0.items():
        np.testing.assert_allclose(g.numpy(), want_grads[k].numpy(),
                                   rtol=5e-4, atol=5e-5, err_msg=k)
    loss, params, stats_miss = _misses(m0, after0, want_metrics, want_after)
    print(f'2 ranks against JAX: loss {loss:.3g} relative, parameters '
          f'{params:.3g}, running statistics {stats_miss:.3g} relative')


def test_per_rank_normalization_misses_jax(ranks):
    """The test has teeth: averaging per-rank losses (each rank's masked L1
    over its own mask sum, its batch statistics over its own rows) misses
    JAX's global loss and running statistics by more than the tolerances
    the step is held to."""
    results, _, jmodel, variables, _ = ranks
    want_metrics, want_after, _ = _jax_step(
        jmodel, variables, torch_ranks.student_batch())
    metrics, after, _ = results[0]['per_rank']
    loss, params, stats = _misses(metrics, after, want_metrics, want_after)
    print(f'per-rank normalization against JAX: loss {loss:.3g} relative '
          f'(tolerance {LOSS_RTOL}), parameters {params:.3g} (tolerance '
          f'{PARAM_ATOL}), running statistics {stats:.3g} relative '
          f'(tolerance {STATS_RTOL} + {STATS_ATOL} absolute)')
    assert loss > 10 * LOSS_RTOL
    assert stats > 10 * (STATS_RTOL + STATS_ATOL)


@pytest.mark.parametrize('kind', sorted(torch_ranks.CASES))
def test_two_rank_step_matches_one_process(ranks, kind):
    """Every other trainer's step on two ranks against the port's
    one-process step on the global batch (unequal lengths where the
    trainer has lengths); both ranks bit-identical."""
    results = ranks[0]
    want_metrics, want, want_grads = torch_ranks.case_step(kind)
    (m0, after0, grads0), (m1, after1, _) = (r['cases'][kind]
                                             for r in results)
    assert m0 == m1
    for k in after0:
        assert torch.equal(after0[k], after1[k]), (kind, k)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(m0[k], v, rtol=LOSS_RTOL, err_msg=k)
    assert set(grads0) == set(want_grads) and grads0
    for k, g in want_grads.items():
        np.testing.assert_allclose(grads0[k].numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
        delta = (after0[k] - want[k]).abs()
        assert float(delta.max()) <= 2 * torch_ranks.LR + 1e-6, k
        decided = g.abs() > 1e-6
        assert decided.any(), k
        assert float(delta[decided].max()) <= PARAM_ATOL, k
    for k, v in want.items():
        if not v.is_floating_point():
            assert torch.equal(after0[k], v), k
        elif k.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(after0[k].numpy(), v.numpy(),
                                       rtol=STATS_RTOL, atol=STATS_ATOL,
                                       err_msg=k)


def _assert_payload_equal(payload, model_sd, optim_sd):
    for k, v in model_sd.items():
        assert torch.equal(payload['model'][k], v), k
    assert set(payload['optim']['state']) == set(optim_sd['state'])
    for i, st in optim_sd['state'].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(payload['optim']['state'][i][k]),
                               torch.as_tensor(v)), (i, k)


def test_checkpoint_directory_round_trip(ranks, tmp_path):
    """A `.dcp` directory written by the two ranks (each its part) loads
    in one process as the payload it was; one process writes and loads
    one too, and `restore` puts it back into a model and its Adam."""
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.utils.checkpoints import (
        DIRECTORY_FORMAT, load_checkpoint, restore, save_checkpoint)
    out = ranks[1]
    saved = torch.load(out / 'voc_0.pt', weights_only=False)
    parts = sorted(p.name for p in (out / 'voc.dcp' / 'state').iterdir())
    assert '.metadata' in parts and len(parts) >= 2, parts
    payload = load_checkpoint(out / 'voc.dcp')
    assert payload['step'] == 11 and payload['config'] == {'ranks': 2}
    assert payload['format'] == DIRECTORY_FORMAT
    _assert_payload_equal(payload, saved['model'], saved['optim'])

    _, model = torch_ranks._wavernn(None)
    opt = tc.make_optimizer(model)
    model(torch.zeros(2, 256), torch.zeros(2, 8, 20)).sum().backward()
    opt.step()
    save_checkpoint(model, opt, {'ranks': 1}, tmp_path / 'one.dcp', 3)
    one = load_checkpoint(tmp_path / 'one.dcp')
    assert one['step'] == 3 and one['config'] == {'ranks': 1}
    _assert_payload_equal(one, model.state_dict(), opt.state_dict())
    _, fresh = torch_ranks._wavernn(None)
    fresh_opt = tc.make_optimizer(fresh)
    assert restore(fresh, fresh_opt, one) == 3
    _assert_payload_equal({'model': fresh.state_dict(),
                           'optim': fresh_opt.state_dict()},
                          model.state_dict(), opt.state_dict())
