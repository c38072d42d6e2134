"""The mesh's 'model' axis of the port (`parallel/mesh.py:param_spec`,
`parallel/model_axis.py`) on the CPU:

- `param_spec` against the JAX package's `_param_spec` with labelled
  weights: every element of every JAX leaf holds the index of the shard
  `_param_spec` puts it in (-1 where the leaf is replicated), the tree goes
  through `weights.py`'s converter, and each port parameter's chunk k under
  `param_spec` must hold exactly the elements labelled k (the replicated
  ones only -1), for the student, FastPitch, the teacher, WaveRNN, HiFi-GAN
  and its MPD/MSD discriminators, MelGAN and the aligner, over 2 and 4
  ranks, with the number of sharded parameters of each;
- one spawn of 4 gloo ranks (`tests/torch_ranks.py:model_axis_rank`):
  - as data 2 x model 2, the student's step against JAX's single-device
    `build_forward_train_step` at `tests/test_parallel.py`'s tolerances
    (loss rtol 1e-4, parameters atol 2e-5; running statistics rtol 1e-5 /
    atol 1e-6) and against the port's one-process step at the same ones;
    the four ranks bit-identical; each rank's parameters and Adam moments
    between steps the elements `param_spec` leaves it; a `.pt` (rank 0)
    and a `.dcp` (every rank) of the whole state that load with no mesh
    bit-equal to it; a JAX `.fjax`'s Adam state resumed, then sharded; the
    mesh's layout and its refusals;
  - as two worlds of data 1 x model 2, the teacher's, WaveRNN's,
    HiFi-GAN's, the aligner's, FastPitch's and the student's steps against
    one process at `tests/test_torch_parallel.py`'s tolerances (losses rtol
    1e-4, gradients rtol 1e-4 / atol 1e-6, parameters atol 2e-5 where
    |g| > 1e-6 and within 2 lr elsewhere), the two peers bit-identical;
  - `train_forward` under torchrun's environment with `tpu.mesh` data 2 x
    model 2, EMA, grad_accum 2, remat and `plot_every` 2: rank 0's
    checkpoint, its TensorBoard events and audio samples, and its EMA and
    raw weights against the one-process CLI's as
    tests/test_torch_parallel_cli.py holds them (L2 distance at most 1e-3
    of how far the one process moved them).
"""
import functools
import json
import socket

import numpy as np
import pytest

import jax
import torch

import torch_ranks
from test_torch_parallel import (LOSS_RTOL, PARAM_ATOL, STATS_ATOL,
                                 STATS_RTOL, _jax_step, _student_weights)

SPAWN_TIMEOUT_S = 600


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ------------------------------------------- param_spec against JAX's rule

def _labelled(params, n_model):
    """Every leaf of a flax params tree filled with the index of the shard
    JAX's `_param_spec` puts each element in over n_model devices, -1
    where it replicates the leaf."""
    from forwardtacotron_tpu.parallel.mesh import _param_spec

    def label(path, leaf):
        spec = tuple(_param_spec(path, leaf, n_model))
        shape = np.shape(leaf)
        if 'model' not in spec:
            return np.full(shape, -1.0)
        axis = spec.index('model')
        index = np.arange(shape[axis]) // (shape[axis] // n_model)
        view = [1] * len(shape)
        view[axis] = shape[axis]
        return np.broadcast_to(index.reshape(view).astype(np.float64),
                               shape).copy()
    return jax.tree_util.tree_map_with_path(label, params)


def _melgan():
    from forwardtacotron_tpu.train.hifigan_trainer import (
        make_generator as jax_generator)
    from forwardtacotron_tpu_torch.models.hifigan import make_generator
    from forwardtacotron_tpu_torch.weights import hifigan_state_dict
    cfg = {'dsp': {'num_mels': 8}, 'hifigan': {'model': {
        'generator_type': 'melgan', 'upsample_initial_channel': 32,
        'upsample_rates': [4, 4]}}}
    jgen = jax_generator(cfg)
    variables = jax.tree.map(np.asarray, jax.jit(jgen.init)(
        jax.random.PRNGKey(0), jax.numpy.zeros((1, 6, 8))))
    return variables, lambda v: hifigan_state_dict(v, cfg), \
        make_generator(cfg)


@functools.lru_cache(maxsize=1)
def _models():
    """{model: (flax variables, converter, the port's model)}: the
    converters the trainers use, at the widths of the tests that hold them
    against JAX."""
    import test_torch_fast_pitch as fp
    import test_torch_forward_train as ft
    import test_torch_gan_train_step as gs
    import test_torch_optim_state as optim
    import test_torch_tacotron as taco
    import test_torch_voc_train as voc
    from forwardtacotron_tpu_torch.weights import (aligner_state_dict,
                                                   fast_pitch_state_dict,
                                                   hifigan_state_dict,
                                                   tacotron_state_dict)
    return {
        'forward_tacotron': (ft._variables(),
                             lambda v: ft._state_dict_of(v, ft.NO_DROPOUT),
                             ft._models(ft.NO_DROPOUT)[2]),
        'fast_pitch': (fp._variables('nd'),
                       lambda v: fast_pitch_state_dict(v, fp.NO_DROPOUT),
                       fp._port_model(fp.NO_DROPOUT)),
        'tacotron': (taco._variables(),
                     lambda v: tacotron_state_dict(v, taco.CFG),
                     taco._port_model()),
        'wavernn': (voc._variables('RAW'),
                    lambda v: voc._state_dict(v, 'RAW'),
                    voc._models('RAW')[2]),
        'aligner': (optim._aligner()[1], aligner_state_dict,
                    optim._aligner_port()),
        'hifigan': (gs._gen_variables()[1],
                    lambda v: hifigan_state_dict(v, gs.CONFIG),
                    gs._port_generator(gs._gen_variables()[1])),
        'discriminators': (gs._discs()[1], gs._disc_state, gs._discs()[2]),
        'melgan': _melgan()}


# the parameters `param_spec` shards at the tests' widths, over 2 and 4
SHARDED = {
    'forward_tacotron': (101, 88), 'fast_pitch': (71, 69),
    'tacotron': (63, 60), 'wavernn': (12, 12), 'aligner': (14, 14),
    'hifigan': (32, 22), 'discriminators': (48, 48), 'melgan': (42, 42)}


@pytest.mark.parametrize('n_model', (2, 4))
@pytest.mark.parametrize('kind', sorted(SHARDED))
def test_param_spec_shards_what_jax_shards(kind, n_model):
    from forwardtacotron_tpu_torch.parallel.mesh import param_specs
    variables, to_sd, model = _models()[kind]
    sd = to_sd(dict(variables, params=_labelled(variables['params'],
                                                n_model)))
    specs = param_specs(model, n_model)
    assert set(specs) == {n for n, _ in model.named_parameters()}
    for name, dim in specs.items():
        labels = sd[name]
        if dim is None:
            assert bool((labels == -1).all()), (name, 'replicated')
            continue
        for k, chunk in enumerate(labels.chunk(n_model, dim)):
            assert bool((chunk == k).all()), (name, dim, k)
    n_sharded = sum(dim is not None for dim in specs.values())
    print(f'{kind} over {n_model}: {n_sharded} of {len(specs)} parameters '
          'sharded')
    assert n_sharded == SHARDED[kind][(2, 4).index(n_model)]


# ------------------------------------------------------- the 4-rank spawn

def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


CLI_STEPS = 4


def _cli_config(tmp_path, data, mesh):
    """tests/test_torch_parallel_cli.py's tiny student as a `.json`
    config, `CLI_STEPS` steps at batch 4 with EMA, grad_accum 2 and remat,
    plots every 2 steps, `tpu.mesh` `mesh` (data, model)."""
    from forwardtacotron_tpu_torch.config import default_config
    from test_torch_train_pipeline import TINY_MODEL
    cfg = default_config()
    cfg['data_path'] = str(data)
    cfg['tts_model_id'] = 'axis_tts'
    cfg['forward_tacotron']['model'] = dict(TINY_MODEL)
    cfg['forward_tacotron']['training'].update(
        schedule=[f'1e-3, {CLI_STEPS}, 4'], checkpoint_every=1000,
        plot_every=2, ema_decay=0.9, grad_accum=2, remat=True)
    cfg['tpu']['mesh'] = {'data': mesh[0], 'model': mesh[1]}
    path = tmp_path / f'axis_{mesh[0]}x{mesh[1]}.json'
    path.write_text(json.dumps(cfg))
    return path


def _jax_fjax(jmodel, variables, path):
    """A `.fjax` of the tiny student after one JAX step, with its Adam
    state, as the JAX trainer writes it."""
    from forwardtacotron_tpu.train import common as jtc
    from forwardtacotron_tpu.utils.checkpoints import save_checkpoint
    from test_torch_forward_train import _jax_batch
    optimizer = jtc.make_optimizer(torch_ranks.FT_TRAIN['clip_grad_norm'],
                                   lr=torch_ranks.LR)
    state = jtc.TrainState(params=variables['params'],
                           batch_stats=variables['batch_stats'],
                           opt_state=optimizer.init(variables['params']),
                           step=jax.numpy.asarray(0, jax.numpy.int32),
                           ema_params=None)
    step = jax.jit(jtc.build_forward_train_step(jmodel, optimizer,
                                                torch_ranks.FT_TRAIN))
    state, _ = step(state, _jax_batch(torch_ranks.student_batch(seed=3)),
                    jax.random.PRNGKey(1))
    save_checkpoint(jax.tree.map(np.asarray, state.variables),
                    {'tiny': True}, path, opt_state=state.opt_state, step=1)


@pytest.fixture(scope='module')
def axis(tmp_path_factory):
    """One spawn of four gloo ranks for the module
    (`torch_ranks.model_axis_rank`): (the directory they wrote to, the
    JAX model and variables, the CLI's dataset)."""
    from test_torch_train_pipeline import _make_dataset
    out = tmp_path_factory.mktemp('axis')
    jmodel, variables, sd = _student_weights()
    _jax_fjax(jmodel, variables, out / 'axis.fjax')
    torch.save({'state_dict': sd, 'batch': torch_ranks.student_batch(),
                'fjax': str(out / 'axis.fjax')}, out / 'init.pt')
    data = out / 'data'
    _make_dataset(data)
    torch_ranks.run_ranks(torch_ranks.model_axis_rank, out, str(out),
                          str(out / 'init.pt'), _free_port(),
                          str(_cli_config(out, data, (2, 2))), world=4,
                          timeout=SPAWN_TIMEOUT_S)
    return out, jmodel, variables, data


def _load(out, what, rank):
    return torch.load(out / f'{what}_{rank}.pt', weights_only=False)


def test_mesh_layout_and_refusals(axis):
    """Global rank r at data index r // 2 and model index r % 2; the data
    groups join the ranks of one model index, the model groups those of
    one data index; a shape that does not multiply to the 4 ranks is
    refused, and without a group a 'model' axis is refused by name."""
    from forwardtacotron_tpu_torch.parallel import make_mesh
    out = axis[0]
    for r in range(4):
        layout = _load(out, 'grid', r)['layout']
        assert layout['shape'] == {'data': 2, 'model': 2}
        assert (layout['rank'], layout['model_rank']) == divmod(r, 2)
        assert layout['devices'] == 2
        assert layout['data_group'] == [r % 2, r % 2 + 2]
        assert layout['model_group'] == [r - r % 2, r - r % 2 + 1]
        assert len(layout['refusals']) == 3
        assert all('does not match' in e for e in layout['refusals'])
    with pytest.raises(ValueError, match=r'tpu\.mesh\.model'):
        make_mesh(n_data=1, n_model=2, devices=['cpu'] * 2)


def test_student_step_over_data_and_model_matches_jax(axis):
    """The 2 x 2 student step against JAX's single device on the 4 rows
    and against the port's one-process step; the four ranks
    bit-identical."""
    out, jmodel, variables, _ = axis
    batch = torch_ranks.student_batch()
    want_metrics, want_after, _ = _jax_step(jmodel, variables, batch)
    init = torch.load(out / 'init.pt', weights_only=False)
    one_metrics, one_after, _ = torch_ranks.student_step(
        init['state_dict'], batch)
    steps = [_load(out, 'grid', r)['student']['step'] for r in range(4)]
    m0, after0, _ = steps[0]
    for m, after, _ in steps[1:]:
        assert m == m0
        for k in after0:
            assert torch.equal(after[k], after0[k]), k
    for want_m, want_a in ((want_metrics, want_after),
                           (one_metrics, one_after)):
        for k in ('loss', 'mel_loss', 'dur_loss', 'pitch_loss',
                  'energy_loss', 'grad_norm'):
            np.testing.assert_allclose(m0[k], want_m[k], rtol=LOSS_RTOL,
                                       err_msg=k)
        for k, v in after0.items():
            if not v.is_floating_point():
                continue          # the counters (`step`: the checkpoints')
            if k.endswith(('running_mean', 'running_var')):
                np.testing.assert_allclose(v.numpy(), want_a[k].numpy(),
                                           rtol=STATS_RTOL, atol=STATS_ATOL,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(v.numpy(), want_a[k].numpy(),
                                           atol=PARAM_ATOL, err_msg=k)
    worst = max(float((after0[k] - want_after[k]).abs().max())
                for k in after0 if after0[k].is_floating_point())
    print(f'2 x 2 against JAX: loss {m0["loss"]:.7g} vs '
          f'{want_metrics["loss"]:.7g}, state after {worst:.3g}')


def test_storage_between_steps_is_sharded(axis):
    """Between steps each rank holds the parameters and Adam moments that
    `param_spec` leaves it: a sharded parameter's 1/2, a replicated one
    whole; at least a third fewer elements than the whole model."""
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.parallel.mesh import param_specs
    out = axis[0]
    model = ForwardTacotron(num_chars=torch_ranks.FT_CHARS,
                            n_mels=torch_ranks.FT_MELS, **torch_ranks.FT_TINY)
    specs = param_specs(model, 2)
    whole = sum(p.numel() for p in model.parameters())
    share = sum(p.numel() // (1 if specs[n] is None else 2)
                for n, p in model.named_parameters())
    for r in range(4):
        params, moments = _load(out, 'grid', r)['student']['storage']
        assert params == share and moments == 2 * share, (r, params, share)
    print(f'student: {share} of {whole} parameter elements a rank')
    assert share < 2 * whole / 3


def _payload_equal(payload, model_sd, optim_sd):
    for k, v in model_sd.items():
        assert torch.equal(payload['model'][k], v), k
    assert set(payload['optim']['state']) == set(optim_sd['state'])
    for i, st in optim_sd['state'].items():
        for k, v in st.items():
            got = payload['optim']['state'][i][k]
            assert torch.equal(torch.as_tensor(got), torch.as_tensor(v)), \
                (i, k)


def test_checkpoints_under_the_axis_load_without_a_mesh(axis):
    """The `.pt` rank 0 wrote and the `.dcp` every rank wrote from the
    whole state load in one process bit-equal to the ranks' whole
    parameters and Adam state, into a model without a mesh; a JAX
    `.fjax`'s Adam state resumed under the axis is cut into the ranks'
    shards along `param_spec`'s dims."""
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.utils.checkpoints import (load_checkpoint,
                                                             restore)
    out = axis[0]
    ranks = [_load(out, 'grid', r)['student'] for r in range(4)]
    state = dict(ranks[0]['step'][1], step=torch.ones(1, dtype=torch.long))
    for path in (out / 'axis.pt', out / 'axis.dcp'):
        payload = load_checkpoint(path)
        _payload_equal(payload, {k: v for k, v in state.items()
                                 if k != 'step'}, ranks[0]['optim'])
        model = ForwardTacotron(num_chars=torch_ranks.FT_CHARS,
                                n_mels=torch_ranks.FT_MELS,
                                **torch_ranks.FT_TINY)
        opt = tc.make_optimizer(model)
        assert restore(model, opt, payload) == 1
        for k, v in model.state_dict().items():
            if k != 'step':
                assert torch.equal(v, state[k]), (path.name, k)
    from forwardtacotron_tpu_torch.parallel.mesh import param_specs
    specs = param_specs(model, 2)
    for res in ranks:
        assert {n: d for n, (d, _) in res['restored_shards'].items()} == {
            n: d for n, d in specs.items() if d is not None}
        for name, (dim, moments) in res['restored_shards'].items():
            for got, full in zip(moments, res['full_moments'][name]):
                assert torch.equal(got, full.chunk(2, dim)[res['model_rank']])


ONE_BY_TWO = ('teacher', 'wavernn', 'hifigan', 'aligner', 'fast_pitch',
              'student')


@pytest.mark.parametrize('kind', ONE_BY_TWO)
def test_one_by_two_step_matches_one_process(axis, kind):
    """Each trainer's step on data 1 x model 2 (the whole batch on both
    peers, the weights in shards) against the port's one-process step;
    the peers bit-identical, each peer's gradient shards the one
    process's chunks."""
    out = axis[0]
    pair = 0 if kind in ('teacher', 'wavernn', 'hifigan') else 1
    peers = [_load(out, 'pair', 2 * pair + k)[kind] for k in range(2)]
    if kind == 'student':
        init = torch.load(out / 'init.pt', weights_only=False)
        want_metrics, want, want_grads = torch_ranks.student_step(
            init['state_dict'], torch_ranks.student_batch())
    else:
        want_metrics, want, want_grads = torch_ranks.case_step(kind)
    (m0, after0, grads0), (m1, after1, grads1) = peers
    assert m0 == m1
    for k in after0:
        assert torch.equal(after0[k], after1[k]), (kind, k)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(m0[k], v, rtol=LOSS_RTOL, err_msg=k)
    n_sharded = 0
    for k, g in want_grads.items():
        for peer, grads in enumerate((grads0, grads1)):
            got = grads[k]
            if got.shape != g.shape:
                dim = [a != b for a, b in zip(got.shape, g.shape)].index(True)
                g_peer = g.chunk(2, dim)[peer]
                n_sharded += peer == 0
            else:
                g_peer = g
            np.testing.assert_allclose(got.numpy(), g_peer.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        delta = (after0[k] - want[k]).abs()
        assert float(delta.max()) <= 2 * torch_ranks.LR + 1e-6, k
        decided = g.abs() > 1e-6
        if decided.any():
            assert float(delta[decided].max()) <= PARAM_ATOL, k
    assert n_sharded > 0
    for k, v in want.items():
        if not v.is_floating_point():
            assert torch.equal(after0[k], v), k
        elif k.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(after0[k].numpy(), v.numpy(),
                                       rtol=STATS_RTOL, atol=STATS_ATOL,
                                       err_msg=k)
    print(f'{kind}: {n_sharded} of {len(want_grads)} gradients in shards')


def test_train_forward_cli_over_data_and_model(axis, tmp_path, monkeypatch):
    """`train_forward` under torchrun's environment on 4 ranks with
    `tpu.mesh` data 2 x model 2: every rank ends at CLI_STEPS; rank 0
    alone writes latest_model.pt, TensorBoard events under forward_log and
    the plots' audio samples; the weights are the one-process CLI's within
    tests/test_torch_parallel_cli.py's bound."""
    from forwardtacotron_tpu_torch import train_forward
    from forwardtacotron_tpu_torch.utils.checkpoints import load_checkpoint
    out, _, _, data = axis
    for r in range(4):
        assert _load(out, 'cli', r) == {'step': CLI_STEPS, 'world': 4}
    ckpt_dir = out / 'cli' / 'checkpoints' / 'axis_tts.forward'
    assert sorted(p.name for p in ckpt_dir.glob('*.pt')) == [
        'latest_model.pt']
    logs = ckpt_dir / 'logs'
    assert list(logs.glob('events.out.tfevents.*'))
    wavs = sorted(p.name for p in (logs / 'audio').glob('*.wav'))
    assert wavs == sorted(f'{tag}_step{s}.wav' for s in (2, 4) for tag in (
        'Ground_Truth_Aligned_target_wav', 'Ground_Truth_Aligned_postnet_wav',
        'Generated_postnet_wav'))

    for var in ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK',
                'LOCAL_RANK'):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv('FTT_BASE', str(tmp_path))
    one_cfg = _cli_config(tmp_path, data, (-1, 1))
    assert train_forward.main(['--config', str(one_cfg),
                               '--device', 'cpu']) == CLI_STEPS
    ranks = load_checkpoint(ckpt_dir / 'latest_model.pt')
    alone = load_checkpoint(tmp_path / 'checkpoints' / 'axis_tts.forward'
                            / 'latest_model.pt')
    assert ranks['step'] == alone['step'] == CLI_STEPS
    from forwardtacotron_tpu_torch.config import read_config
    from forwardtacotron_tpu_torch.utils.checkpoints import init_tts_model
    torch.manual_seed(train_forward.SEED)
    init = init_tts_model(read_config(one_cfg)).state_dict()
    for what in ('model', 'raw_model'):        # the EMA's, the raw
        apart = moved = 0.0
        for k, v in alone[what].items():
            if v.is_floating_point():
                apart += float(((ranks[what][k] - v) ** 2).sum())
                moved += float(((v - init[k]) ** 2).sum())
            else:
                assert torch.equal(ranks[what][k], v), k
        print(f'2 x 2 CLI against one process after {CLI_STEPS} steps, '
              f'{what}: {apart ** 0.5:.3g} (L2); the one process moved '
              f'{moved ** 0.5:.3g}')
        assert moved > 0 and apart ** 0.5 <= 1e-3 * moved ** 0.5, what
