"""Two gloo ranks on the CPU for the port's data-parallel tests
(tests/test_torch_parallel*.py): `run_ranks` spawns them with
`torch.multiprocessing` over a `file://` store and fails if they do not
all finish within the timeout; the functions the ranks run, and the tiny
one-step cases of every trainer (`CASES`), which the tests also run in
one process. Imports no JAX: the ranks need only torch and the port."""
from __future__ import annotations

import contextlib
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOIN_TIMEOUT_S = 120
LR = 1e-3


def _entry(rank, fn, world, store, args):
    torch.set_num_threads(1)
    if store is not None:
        dist.init_process_group('gloo', init_method=f'file://{store}',
                                rank=rank, world_size=world)
    try:
        fn(rank, *args)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, tmp_path: Path, *args, world: int = 2,
              timeout: float = JOIN_TIMEOUT_S, group: bool = True) -> None:
    """fn(rank, *args) on `world` spawned processes, each rank of a gloo
    group over a `file://` store under `tmp_path` (`group` False: no
    group, fn brings up its own); raises if a rank fails or if they have
    not all finished within `timeout` seconds."""
    store = str(Path(tmp_path) / f'store_{time.monotonic_ns()}') \
        if group else None
    ctx = mp.start_processes(_entry, args=(fn, world, store, args),
                             nprocs=world, join=False, start_method='spawn')
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f'{fn.__name__}: ranks still running '
                                   f'after {timeout} s')
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)


def cpu_mesh():
    from forwardtacotron_tpu_torch.parallel import make_mesh
    return make_mesh(devices=['cpu'] * dist.get_world_size())


# ------------------------------------------ one step of every trainer

FT_TINY = {
    'embed_dims': 16, 'series_embed_dims': 8,
    'durpred_conv_dims': 12, 'durpred_rnn_dims': 4, 'durpred_dropout': 0.0,
    'pitch_conv_dims': 12, 'pitch_rnn_dims': 6, 'pitch_dropout': 0.0,
    'pitch_strength': 1.0,
    'energy_conv_dims': 12, 'energy_rnn_dims': 3, 'energy_dropout': 0.0,
    'energy_strength': 0.7,
    'rnn_dims': 12, 'prenet_dims': 8, 'prenet_k': 3, 'prenet_dropout': 0.0,
    'prenet_num_highways': 2, 'postnet_dims': 8, 'postnet_k': 2,
    'postnet_num_highways': 1, 'postnet_dropout': 0.0,
}
FT_CHARS, FT_MELS = 40, 6
FT_TRAIN = {'dur_loss_factor': 0.1, 'pitch_loss_factor': 0.1,
            'energy_loss_factor': 0.1, 'pitch_zoneout': 0.0,
            'energy_zoneout': 0.0, 'clip_grad_norm': 0.05}
# unequal lengths: rank 0 takes the first two rows, rank 1 the last two,
# and their mask sums and batch statistics differ
FT_X_LENS = (10, 7, 4, 9)


def student_batch(seed=0, x_lens=FT_X_LENS, tx=12, tm=40):
    rng = np.random.RandomState(seed)
    B = len(x_lens)
    x = np.zeros((B, tx), np.int64)
    dur = np.zeros((B, tx), np.float32)
    for i, n in enumerate(x_lens):
        x[i, :n] = rng.randint(1, FT_CHARS, n)
        dur[i, :n] = rng.randint(0, 5, n)
    mel_len = dur.sum(1).astype(np.int64)
    mel = rng.randn(B, tm, FT_MELS).astype(np.float32)
    mel[np.arange(tm)[None, :] >= mel_len[:, None]] = -11.5129
    return {'x': x, 'x_len': np.asarray(x_lens, np.int64), 'mel': mel,
            'mel_len': mel_len, 'dur': dur,
            'pitch': rng.randn(B, tx).astype(np.float32),
            'energy': rng.randn(B, tx).astype(np.float32)}


def _tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _shard(mesh, *pairs):
    """Each (module, optimizer) kept in shards over `mesh`'s 'model' axis
    from here on (nothing without one)."""
    from forwardtacotron_tpu_torch.parallel.model_axis import shard_module
    for module, opt in pairs:
        shard_module(module, mesh, [opt])


def _whole(model):
    """Every sharded module of `model` whole again, with its optimizer
    state (a collective of the model group)."""
    from forwardtacotron_tpu_torch.parallel.model_axis import unshard
    for m in model.modules():
        unshard(m)


def student_step(state_dict, batch, mesh=None, per_rank=False, after=None):
    """One `train_step` of the tiny ForwardTacotron from `state_dict` on
    the global `batch` (numpy), on this rank's rows inside
    `data_parallel(mesh)` where a mesh is given, the weights in shards over
    its 'model' axis where it has one (`after(model, optimizer)` runs
    before they are made whole again). `per_rank`: the step a plain
    gradient average would take, each rank's loss and batch statistics
    over its own rows, only the gradients averaged. Returns (metrics,
    state_dict after, gradients)."""
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.parallel import data_parallel, local_rows
    from forwardtacotron_tpu_torch.train import common as tc
    model = ForwardTacotron(num_chars=FT_CHARS, n_mels=FT_MELS, **FT_TINY)
    model.load_state_dict(state_dict)
    opt = tc.make_optimizer(model, lr=LR)
    _shard(mesh, (model, opt))
    rows = _tensors(local_rows(mesh, batch))
    gen = torch.Generator().manual_seed(0)
    if per_rank:
        model.train()
        b = tc.forward_step_batch(rows, gen, FT_TRAIN)
        loss, metrics, _ = tc.forward_micro_loss(model, FT_TRAIN)(b)
        loss.backward()
        with data_parallel(mesh):
            tc.apply_update(model, opt, metrics, FT_TRAIN['clip_grad_norm'])
    else:
        with data_parallel(mesh):
            metrics = tc.train_step(model, opt, rows, gen, FT_TRAIN)
    if after is not None:
        after(model, opt)
    _whole(model)
    return ({k: float(v) for k, v in metrics.items()}, _copy(model),
            {k: p.grad.clone() for k, p in model.named_parameters()})


def _copy(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@contextlib.contextmanager
def _keep_all():
    """Every draw of torch.rand is 1: the teacher's fixed-rate dropout
    keeps everything and its zoneout never fires, so one process and two
    ranks draw the same (the ranks draw from seed + rank otherwise)."""
    saved = torch.rand

    def rand(*size, generator=None, device=None, **kw):
        shape = size[0] if len(size) == 1 and not isinstance(size[0], int) \
            else size
        return torch.ones(shape, device=device)
    torch.rand = rand
    try:
        yield
    finally:
        torch.rand = saved


def _teacher(mesh):
    from forwardtacotron_tpu_torch.models.tacotron import Tacotron
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.taco_trainer import taco_train_step
    torch.manual_seed(1)
    model = Tacotron(num_chars=30, n_mels=6, embed_dims=16,
                     encoder_dims=128, decoder_dims=256, postnet_dims=8,
                     encoder_k=2, lstm_dims=32, postnet_k=3, num_highways=1,
                     dropout=0.5, stop_threshold=-11)
    rng = np.random.RandomState(2)
    x_lens, mel_lens = (9, 6, 4, 7), (20, 14, 9, 16)
    x = np.zeros((4, 9), np.int64)
    for i, n in enumerate(x_lens):
        x[i, :n] = rng.randint(1, 30, n)
    mel = np.full((4, 20, 6), -4.0, np.float32)
    for i, n in enumerate(mel_lens):
        mel[i, :n] = rng.randn(n, 6)
    batch = {'x': x, 'mel': mel, 'mel_len': np.asarray(mel_lens)}
    opt = tc.make_optimizer(model, lr=LR)
    _shard(mesh, (model, opt))
    from forwardtacotron_tpu_torch.parallel import data_parallel, local_rows
    with _keep_all(), data_parallel(mesh):
        metrics, _ = taco_train_step(
            model, opt, _tensors(local_rows(mesh, batch)), 2,
            torch.Generator().manual_seed(0), {'clip_grad_norm': 1.0})
    return metrics, model


def _wavernn(mesh):
    from forwardtacotron_tpu_torch.models.wavernn import WaveRNN
    from forwardtacotron_tpu_torch.parallel import data_parallel, local_rows
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.voc_trainer import voc_train_step
    torch.manual_seed(2)
    model = WaveRNN(rnn_dims=32, fc_dims=32, bits=9, pad=2,
                    upsample_factors=(4, 4, 4), feat_dims=20, compute_dims=8,
                    res_out_dims=8, res_blocks=2, hop_length=64,
                    sample_rate=8000, mode='RAW')
    rng = np.random.RandomState(3)
    batch = {'x': rng.uniform(-1, 1, (4, 256)).astype(np.float32),
             'mel': rng.randn(4, 8, 20).astype(np.float32),
             'y': rng.randint(0, 512, (4, 256))}
    opt = tc.make_optimizer(model, lr=LR)
    _shard(mesh, (model, opt))
    with data_parallel(mesh):
        metrics = voc_train_step(model, opt,
                                 _tensors(local_rows(mesh, batch)), 'RAW',
                                 1.0)
    return metrics, model


def _hifigan(mesh):
    from forwardtacotron_tpu_torch.dsp import stft
    from forwardtacotron_tpu_torch.models.gan_discriminators import (
        HiFiGANDiscriminators)
    from forwardtacotron_tpu_torch.models.hifigan import make_generator
    from forwardtacotron_tpu_torch.parallel import data_parallel, local_rows
    from forwardtacotron_tpu_torch.train.hifigan_trainer import (
        gan_train_step, make_gan_optimizer)
    torch.manual_seed(3)
    gen = make_generator({'dsp': {'num_mels': 20}, 'hifigan': {'model': {
        'generator_type': 'hifigan', 'resblock': '1',
        'upsample_rates': [8, 8, 2, 2],
        'upsample_kernel_sizes': [16, 16, 4, 4],
        'upsample_initial_channel': 32, 'resblock_kernel_sizes': [3],
        'resblock_dilation_sizes': [[1, 3]]}}})
    disc = HiFiGANDiscriminators((2, 3), 2)
    rng = np.random.RandomState(4)
    t = np.arange(1024) / 22050.0
    y = 0.5 * np.sin(2 * np.pi * rng.uniform(100, 400, (4, 1)) * t)
    batch = {'mel': (rng.randn(4, 4, 20) - 3).astype(np.float32),
             'audio': (y + 0.05 * rng.randn(4, 1024)).astype(np.float32)}
    basis = torch.from_numpy(stft.mel_filterbank(22050, 1024, 20, 0, 8000))
    g_opt, d_opt = make_gan_optimizer(gen, LR), make_gan_optimizer(disc, LR)
    _shard(mesh, (gen, g_opt), (disc, d_opt))
    with data_parallel(mesh):
        metrics = gan_train_step(
            gen, disc, g_opt, d_opt, _tensors(local_rows(mesh, batch)),
            lambda w: stft.wav_to_mel(w, basis, 1024, 256, 1024))
    return metrics, torch.nn.ModuleDict({'gen': gen, 'disc': disc})


def _aligner(mesh):
    from forwardtacotron_tpu_torch.align.aligner import Aligner
    from forwardtacotron_tpu_torch.parallel import data_parallel, local_rows
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.aligner_trainer import (
        aligner_train_step)
    torch.manual_seed(4)
    model = Aligner(vocab_size=12, n_mels=8, embed_dims=16, conv_dims=16,
                    key_dims=8, n_text_convs=2, n_mel_convs=1, dropout=0.0,
                    prior_width=4.0)
    rng = np.random.RandomState(5)
    x_lens, mel_lens = np.array([9, 5, 3, 7]), np.array([30, 17, 9, 24])
    x = np.zeros((4, 9), np.int64)
    for b, n in enumerate(x_lens):
        x[b, :n] = rng.randint(1, 12, n)
    batch = {'x': x, 'mel': rng.randn(4, 30, 8).astype(np.float32),
             'x_len': x_lens, 'mel_len': mel_lens}
    opt = tc.make_optimizer(model, lr=LR)
    _shard(mesh, (model, opt))
    with data_parallel(mesh):
        metrics = aligner_train_step(
            model, opt, _tensors(local_rows(mesh, batch)),
            torch.Generator().manual_seed(0), 1.0)
    return metrics, model


def _fast_pitch(mesh):
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.models.fast_pitch import FastPitch
    from forwardtacotron_tpu_torch.parallel import data_parallel, local_rows
    from forwardtacotron_tpu_torch.text.symbols import phonemes
    from forwardtacotron_tpu_torch.train import common as tc
    cfg = default_config()
    cfg['dsp']['num_mels'] = FT_MELS
    cfg['fast_pitch']['model'] = {
        'durpred_dropout': 0.0, 'durpred_d_model': 8, 'durpred_n_heads': 2,
        'durpred_layers': 1, 'durpred_d_fft': 8,
        'pitch_dropout': 0.0, 'pitch_d_model': 8, 'pitch_n_heads': 2,
        'pitch_layers': 1, 'pitch_d_fft': 8,
        'energy_dropout': 0.0, 'energy_d_model': 8, 'energy_n_heads': 2,
        'energy_layers': 1, 'energy_d_fft': 8,
        'pitch_strength': 1.0, 'energy_strength': 1.0,
        'd_model': 16, 'conv1_kernel': 9, 'conv2_kernel': 1,
        'prenet_layers': 1, 'prenet_heads': 2, 'prenet_fft': 16,
        'prenet_dropout': 0.0, 'postnet_layers': 1, 'postnet_heads': 2,
        'postnet_fft': 16, 'postnet_dropout': 0.0}
    torch.manual_seed(5)
    model = FastPitch.from_config(cfg)
    batch = student_batch(seed=6)
    batch['x'] = batch['x'] % len(phonemes)
    opt = tc.make_optimizer(model, lr=LR)
    _shard(mesh, (model, opt))
    with data_parallel(mesh):
        metrics = tc.train_step(model, opt, _tensors(local_rows(mesh, batch)),
                                torch.Generator().manual_seed(0), FT_TRAIN)
    return metrics, model


CASES = {'teacher': _teacher, 'wavernn': _wavernn, 'hifigan': _hifigan,
         'aligner': _aligner, 'fast_pitch': _fast_pitch}


def case_step(kind, mesh=None):
    """One step of trainer `kind` at a tiny width from a seeded model on a
    seeded global batch with unequal lengths, on this rank's rows under
    `mesh` (the weights in shards over its 'model' axis, whole again
    after): (metrics as floats, state_dict after, the gradients the
    optimizer took, this rank's shards of the sharded ones)."""
    metrics, model = CASES[kind](mesh)
    _whole(model)
    return ({k: float(v) for k, v in metrics.items()}, _copy(model),
            {k: p.grad.clone() for k, p in model.named_parameters()
             if p.grad is not None})


# ------------------------------------------------------- the rank bodies

def steps_rank(rank, out_dir, init_path):
    """Rank body of tests/test_torch_parallel.py: the student's step and
    its per-rank variant, one step of every trainer in CASES, this rank's
    rows of a batch and `process_slice`, a checkpoint directory written by
    both ranks; each result saved to out_dir/<what>_<rank>.pt."""
    from forwardtacotron_tpu_torch.parallel import (local_batch,
                                                    process_slice)
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.utils.checkpoints import save_checkpoint
    out_dir = Path(out_dir)
    mesh = cpu_mesh()
    init = torch.load(init_path, weights_only=False)
    results = {
        'student': student_step(init['state_dict'], init['batch'], mesh),
        'per_rank': student_step(init['state_dict'], init['batch'], mesh,
                                 per_rank=True),
        'cases': {kind: case_step(kind, mesh) for kind in CASES},
        'rows': local_batch(mesh, init['rows_batch']),
        'rows_micro': local_batch(mesh, init['rows_batch'], micro=2),
        'process_slice': process_slice(8)}
    torch.save(results, out_dir / f'steps_{rank}.pt')
    model = _wavernn(mesh)[1]
    opt = tc.make_optimizer(model)
    model(torch.zeros(2, 256), torch.zeros(2, 8, 20)).sum().backward()
    opt.step()
    save_checkpoint(model, opt, {'ranks': 2}, out_dir / 'voc.dcp', 11)
    torch.save({'model': _copy(model), 'optim': opt.state_dict()},
               out_dir / f'voc_{rank}.pt')


def cli_rank(rank, base, config_path, port):
    """Rank body of tests/test_torch_parallel_cli.py: train_forward's
    CLI as torchrun starts it (its environment set here, rank `rank` of
    2 on localhost:`port`) under $FTT_BASE=`base`."""
    import os
    os.environ.update({'MASTER_ADDR': '127.0.0.1', 'MASTER_PORT': str(port),
                       'WORLD_SIZE': '2', 'RANK': str(rank),
                       'LOCAL_RANK': str(rank), 'FTT_BASE': str(base)})
    from forwardtacotron_tpu_torch import train_forward
    step = train_forward.main(['--config', str(config_path),
                               '--device', 'cpu'])
    torch.save({'step': step, 'world': dist.get_world_size(),
                'backend': dist.get_backend()},
               Path(base) / f'cli_{rank}.pt')


# ------------------------------------------------ the mesh's 'model' axis

def _storage(model, opt):
    """(parameter elements, Adam moment elements) this rank holds."""
    params = sum(p.numel() for p in model.parameters())
    moments = sum(t.numel() for state in opt.state.values()
                  for k, t in state.items() if k in ('exp_avg', 'exp_avg_sq'))
    return params, moments


def _axis_student(rank, out_dir, init, mesh):
    """The student's step over `mesh` (2 x 2): its results, what each rank
    stores between steps, a `.pt` written by rank 0 and a `.dcp` by every
    rank from the whole state, and a JAX `.fjax`'s weights and Adam state
    resumed as `train_forward` resumes them, then sharded."""
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.parallel.model_axis import (shard_module,
                                                               whole_state)
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.utils.checkpoints import save_checkpoint
    from forwardtacotron_tpu_torch.weights import (
        forward_tacotron_state_dict, load_fjax, load_optimizer_state)
    seen = {}

    def after(model, opt):
        seen['storage'] = _storage(model, opt)
        with whole_state([model]):
            if rank == 0:
                save_checkpoint(model, opt, {}, out_dir / 'axis.pt', 1)
            save_checkpoint(model, opt, {}, out_dir / 'axis.dcp', 1)
            seen['optim'] = opt.state_dict()
    results = student_step(init['state_dict'], init['batch'], mesh,
                           after=after)
    payload = load_fjax(init['fjax'], use_ema=False)

    def to_sd(variables):
        return forward_tacotron_state_dict(variables, FT_TINY)
    model = ForwardTacotron(num_chars=FT_CHARS, n_mels=FT_MELS, **FT_TINY)
    model.load_state_dict(to_sd(payload['model']))
    opt = tc.make_optimizer(model, lr=LR)
    assert load_optimizer_state(payload, [(opt, model, payload['model'],
                                           to_sd)])
    full = {name: [opt.state[p][k].clone() for k in ('exp_avg',
                                                      'exp_avg_sq')]
            for name, p in model.named_parameters() if p in opt.state}
    shards = shard_module(model, mesh, [opt])
    restored = {name: (dim, [opt.state[p][k].clone()
                             for k in ('exp_avg', 'exp_avg_sq')])
                for name, p, dim in shards.sharded}
    return {'step': results, 'storage': seen['storage'],
            'optim': seen['optim'], 'full_moments': full,
            'restored_shards': restored, 'model_rank': mesh.model_rank}


def _init_world(store, rank, world):
    dist.init_process_group('gloo', init_method=f'file://{store}',
                            rank=rank, world_size=world)


def model_axis_rank(rank, out_dir, init_path, port, cli_config):
    """Rank body of tests/test_torch_parallel_model.py, in three worlds:

    - the spawn's 4 ranks as data 2 x model 2: the student's step
      (`_axis_student`), the mesh's layout and its refusals;
    - ranks {0, 1} and {2, 3} as two worlds of data 1 x model 2: one step
      of every trainer in CASES, and the student's, in shards;
    - `train_forward` under torchrun's environment on 4 ranks with
      `tpu.mesh` data 2 x model 2 (localhost:`port`, $FTT_BASE out_dir/cli).
    Each world's results saved to out_dir/<world>_<rank>.pt."""
    import os
    from forwardtacotron_tpu_torch.parallel import make_mesh
    out_dir = Path(out_dir)
    init = torch.load(init_path, weights_only=False)
    mesh = make_mesh(n_data=2, n_model=2, devices=['cpu'] * 4)
    refusals = []
    for shape in ((3, 2), (2, 3), (4, 2)):
        try:
            make_mesh(*shape, devices=['cpu'] * 4)
        except ValueError as e:
            refusals.append(str(e))
    layout = {'shape': mesh.shape, 'rank': mesh.rank,
              'model_rank': mesh.model_rank, 'devices': len(mesh.devices),
              'data_group': dist.get_process_group_ranks(mesh.group),
              'model_group': dist.get_process_group_ranks(mesh.model_group),
              'refusals': refusals}
    torch.save({'layout': layout,
                'student': _axis_student(rank, out_dir, init, mesh)},
               out_dir / f'grid_{rank}.pt')
    dist.destroy_process_group()

    pair, peer = divmod(rank, 2)
    _init_world(out_dir / f'pair_store_{pair}', peer, 2)
    mesh = make_mesh(n_data=1, n_model=2, devices=['cpu'] * 2)
    kinds = (('teacher', 'wavernn', 'hifigan'),
             ('aligner', 'fast_pitch'))[pair]
    results = {kind: case_step(kind, mesh) for kind in kinds}
    if pair == 1:
        results['student'] = student_step(init['state_dict'], init['batch'],
                                          mesh)
    torch.save(results, out_dir / f'pair_{rank}.pt')
    dist.destroy_process_group()

    os.environ.update({'MASTER_ADDR': '127.0.0.1', 'MASTER_PORT': str(port),
                       'WORLD_SIZE': '4', 'RANK': str(rank),
                       'LOCAL_RANK': str(rank),
                       'FTT_BASE': str(out_dir / 'cli')})
    from forwardtacotron_tpu_torch import train_forward
    step = train_forward.main(['--config', str(cli_config),
                               '--device', 'cpu'])
    torch.save({'step': step, 'world': dist.get_world_size()},
               out_dir / f'cli_{rank}.pt')
