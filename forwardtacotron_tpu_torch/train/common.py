"""Training machinery: the forward model's loss and step, the options
every trainer shares, the session helpers, top-k and preemption.

Mirrors the JAX package's `train/common.py`: the masked-L1 loss with
0.1-weighted duration/pitch/energy terms, pitch/energy zoneout, global-
norm clipping with optax's formula, then Adam with torch's (= optax's)
defaults, the schedule sessions' helpers (the vocoders' `VocSession`
too), the top-k checkpoint tracker every trainer keeps, and graceful
preemption. A step is forward, `loss.backward()`, clip,
`optimizer.step()`; the student's (`train_step`) runs as one CUDA graph
per batch shape where it can (`StepGraphs`), every other step eagerly.
While a profiler records, `train_step` is the span `ftt.train.step`
(with the `path` it took), each forward and backward of `accumulate` the
spans `ftt.train.forward` and `ftt.train.backward`, and `apply_update` the
span `ftt.train.update` (`utils/profiling.py:annotate`); a graph's replay
records none of the last three.

The trainers' options, as the JAX package runs them (`:213-400`):

- `precision: bf16` casts at the boundary: the float32 parameters and the
  float32 inputs go into the model as bfloat16 (`forward_model`, through
  `torch.func.functional_call`), the whole forward runs in bfloat16 (the
  BiRNN kernels too: `ops/rnn.py:follow_dtype`), the predictions come back
  as float32 (`full`) for a loss against the float32 targets, and the
  gradients flow back to the float32 masters through the casts. BatchNorm
  statistics and Adam stay float32. Not `torch.autocast`, which casts per
  op and keeps reductions in float32.
- `ema_decay` > 0 keeps `EMA` weights, `decay * e + (1 - decay) * p`
  after every update; evaluation and served files use them.
- `grad_accum` k splits the batch on its leading axis into k micro-batches
  of the padded length (`accumulate`): the mean-loss gradients are summed
  and divided by k, BatchNorm statistics move in micro-batch order, the
  metrics are averaged, and clipping sees the averaged gradient.
- `remat` recomputes the model's forward in the backward
  (`torch.utils.checkpoint`, non-reentrant), with the same dropout masks
  (the global RNG by `preserve_rng_state`, an explicit generator restored
  here) and without a second move of the running statistics.

Each trainer honours what its JAX counterpart honours (`HONOURED`) and
refuses the rest by name (`check_supported`).

Data parallelism (`parallel/`): a trainer given a mesh (or, with a
process group of more than one rank up, the mesh of `config['tpu']`) runs
its step on this rank's rows of the global batch inside
`parallel.data_parallel` (`Ranks`). `apply_update` then averages the
gradients and the metrics over the data axis before the clip (once a
step, after every micro-batch of `grad_accum`), so the step is the
one-process step on the global batch and every rank keeps the same
parameters. Over a 'model' axis (`Ranks.shard`, `parallel.model_axis`)
each rank keeps its shards of the parameters, of Adam's moments and of the
EMA between steps; `forward_model` gathers the weights whole before the
forward, `apply_update` keeps the rank's slice of the gradients and clips
by the whole norm, and `Ranks.whole` gathers everything on every rank for
evaluation, plots and checkpoints. Global rank 0 alone prints, evaluates,
plots and writes files; the other ranks wait at a barrier. Dropout and
zoneout draw from seed + data index (JAX draws one global mask), so the
peers of a model group draw the same.

The trainers' TensorBoard writer (`Logging`): the `writer=` given, else on
rank 0 a tensorboardX `SummaryWriter` under the run's log path, made at
first use (without tensorboardX, scalars go to stdout only). Figures are
skipped, with a note, where matplotlib cannot be imported.
"""
from __future__ import annotations

import contextlib
import os
import signal
import threading
import time
import weakref
from pathlib import Path
from typing import (Any, Callable, Dict, Iterable, List, NamedTuple,
                    Optional, Sequence, Tuple, Union)

import torch
from torch.utils.checkpoint import checkpoint

from forwardtacotron_tpu_torch import resolve_device
from forwardtacotron_tpu_torch.models.layers import frozen_running_stats
from forwardtacotron_tpu_torch.ops.masking import masked_l1
from forwardtacotron_tpu_torch.parallel import (Mesh, active_mesh,
                                                broadcast_state,
                                                data_parallel, local_rows,
                                                mesh_from_config,
                                                reduce_gradients,
                                                reduce_metrics)
from forwardtacotron_tpu_torch.parallel.model_axis import (gather_weights,
                                                           shard_module,
                                                           shards_of,
                                                           unshard,
                                                           whole_state)
from forwardtacotron_tpu_torch.utils.async_ckpt import (AsyncCheckpointWriter,
                                                     map_tensors)
from forwardtacotron_tpu_torch.utils.display import can_plot
from forwardtacotron_tpu_torch.utils.files import (pickle_binary,
                                                   unpickle_binary)
from forwardtacotron_tpu_torch.utils.profiling import (annotate,
                                                       captured_launches,
                                                       replayed)

# the options each JAX trainer runs (its step builder reads them); the
# port's trainer of the same name honours these and refuses the others
HONOURED = {
    'forward': ('precision', 'ema_decay', 'grad_accum', 'remat'),
    'tacotron': ('precision', 'grad_accum', 'remat'),
    'wavernn': ('precision', 'remat'),
    'gan': ('precision',),
    'aligner': (),
}
OPTION_ON = {
    'precision': lambda v: str(v).lower() not in ('f32', 'float32', 'fp32'),
    'ema_decay': lambda v: float(v or 0) > 0,
    'grad_accum': lambda v: int(v or 1) > 1,
    'remat': bool,
}


def check_supported(train_cfg: Dict[str, Any], trainer: str,
                    section: str = 'training') -> None:
    """Refuse, by name (`section`.key), an option that the JAX `trainer`
    does not run, and an unknown precision (`half_dtype`)."""
    for key, is_on in OPTION_ON.items():
        if key in train_cfg and key not in HONOURED[trainer] \
                and is_on(train_cfg[key]):
            raise ValueError(f'{section}.{key}={train_cfg[key]!r}: the JAX '
                             f'{trainer} trainer has no such option')
    half_dtype(train_cfg)


def half_dtype(train_cfg: Dict[str, Any]) -> Optional[torch.dtype]:
    """training.precision: 'bf16' (or 'bfloat16', 'mixed') computes the
    forward and backward in bfloat16; 'f32' (the default, or 'float32',
    'fp32') is None. Other names raise."""
    name = str(train_cfg.get('precision', 'f32')).lower()
    if name in ('bf16', 'bfloat16', 'mixed'):
        return torch.bfloat16
    if name in ('f32', 'float32', 'fp32'):
        return None
    raise ValueError(f'Unknown training precision: {name}')


def cast_half(tree, half: Optional[torch.dtype]):
    """The float32 tensors of a tree (dicts, lists, tuples) cast to
    `half`; other tensors and values as they are."""
    if half is None:
        return tree
    return map_tensors(tree, lambda t: t.to(half)
                        if t.dtype == torch.float32 else t)


def full(tree):
    """The bfloat16 tensors of a tree cast back to float32."""
    return map_tensors(tree, lambda t: t.float()
                        if t.dtype == torch.bfloat16 else t)


def _flat_tensors(args) -> List[torch.Tensor]:
    out = []
    map_tensors(args, out.append)
    return out


@contextlib.contextmanager
def _replay(generators: Sequence[torch.Generator], states) -> Iterable:
    """The recompute of a rematerialised forward: the explicit generators
    draw again from where the forward began, and the running statistics
    stay where the forward left them."""
    saved = [g.get_state() for g in generators]
    for g, state in zip(generators, states):
        g.set_state(state)
    try:
        with frozen_running_stats():
            yield
    finally:
        for g, state in zip(generators, saved):
            g.set_state(state)


def forward_model(model: torch.nn.Module, *args,
                  half: Optional[torch.dtype] = None, remat: bool = False,
                  generators: Sequence[torch.Generator] = ()):
    """model(*args) as the JAX step applies it. With `half`, the
    parameters and the float32 tensors of args go in cast to it (the
    buffers stay as they are) and the outputs come back in it. With
    `remat`, the forward is recomputed in the backward; `generators` are
    the explicit generators the forward draws from, replayed for the
    recompute. A model sharded over the mesh's 'model' axis is gathered
    whole first (`parallel.model_axis`)."""
    gather_weights(model)
    if half is None and not remat:
        return model(*args)
    params = None
    if half is not None:
        params = {n: p.to(half) for n, p in model.named_parameters()}
        args = cast_half(args, half)

    def run(*_):
        if params is None:
            return model(*args)
        return torch.func.functional_call(model, params, args)
    if not remat:
        return run()
    states = [g.get_state() for g in generators]
    # the input tensors go in positionally so that checkpoint saves and
    # restores the global RNG of their device for the recompute
    return checkpoint(run, *_flat_tensors(args), use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _replay(generators, states)))


class EMA:
    """Exponential moving average of a model's parameters (the JAX
    package's `ema_params`): a float32 copy of the parameters at the
    start, then `decay * e + (1 - decay) * p` after every optimizer
    update, rounded as JAX's `ema_update` rounds it."""

    def __init__(self, model: torch.nn.Module, decay: float) -> None:
        self.decay = float(decay)
        self.params = {n: p.detach().clone()
                       for n, p in model.named_parameters()}

    @torch.no_grad()
    def update(self, model: torch.nn.Module) -> None:
        live = dict(model.named_parameters())
        ema = list(self.params.values())
        torch._foreach_mul_(ema, self.decay)
        torch._foreach_add_(ema, torch._foreach_mul(
            [live[n].detach() for n in self.params], 1.0 - self.decay))

    @torch.no_grad()
    def load(self, stored: Optional[Dict[str, torch.Tensor]],
             model: torch.nn.Module) -> None:
        """The EMA weights of a checkpoint's state_dict, or a copy of the
        model's parameters where `stored` is None."""
        for n, p in model.named_parameters():
            src = p if stored is None else stored[n]
            self.params[n] = src.detach().to(p.device, p.dtype).clone()


@contextlib.contextmanager
def swapped_params(model: torch.nn.Module,
                   params: Optional[Dict[str, torch.Tensor]]) -> Iterable:
    """Within it, the model's parameters hold `params` (by name; the EMA
    weights), for calls other than `forward`; nothing where None."""
    if params is None:
        yield
        return
    saved = {n: p.data for n, p in model.named_parameters()}
    try:
        for n, p in model.named_parameters():
            p.data = params[n]
        yield
    finally:
        for n, p in model.named_parameters():
            p.data = saved[n]


def make_ema(model: torch.nn.Module, train_cfg: Dict[str, Any]
             ) -> Optional[EMA]:
    decay = float(train_cfg.get('ema_decay', 0) or 0)
    return EMA(model, decay) if decay > 0 else None


def accumulate(micro_loss: Callable, batch: Dict[str, Any], k: int,
               model: torch.nn.Module):
    """Backward of `micro_loss(b) -> (loss, metrics, aux)` over the batch
    or, for k > 1, over its k micro-batches (its leading axis split in k,
    every tensor at its padded length) in order, with the summed gradients
    divided by k. Returns (metrics, aux): for k > 1 the metrics averaged
    and the tensor aux joined on the leading axis."""
    if k <= 1:
        with annotate('ftt.train.forward'):
            loss, metrics, aux = micro_loss(batch)
        with annotate('ftt.train.backward'):
            loss.backward()
        return metrics, aux
    (B,) = {v.shape[0] for v in batch.values() if torch.is_tensor(v)}
    assert B % k == 0, f'batch size {B} not divisible by grad_accum={k}'
    m = B // k
    ms, auxs = [], []
    for part in ({key: v[i * m:(i + 1) * m] if torch.is_tensor(v) else v
                  for key, v in batch.items()} for i in range(k)):
        with annotate('ftt.train.forward'):
            loss, metrics, aux = micro_loss(part)
        with annotate('ftt.train.backward'):
            loss.backward()
        ms.append(metrics)
        auxs.append(aux)
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    torch._foreach_div_(grads, float(k))
    metrics = {key: torch.stack([m[key] for m in ms]).mean(0)
               for key in ms[0]}
    aux = None if auxs[0] is None else torch.cat(auxs)
    return metrics, aux


def apply_update(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 metrics: Dict[str, torch.Tensor],
                 clip: Optional[float], ema: Optional[EMA] = None) -> None:
    """Inside `parallel.data_parallel`, the gradients and the metrics
    averaged over the data axis's ranks (in place), and of a model sharded
    over the 'model' axis this rank's shards kept (`ModelShards.
    shard_grads`); then the global-norm clip (where `clip` is set, with
    the norm before clipping in metrics['grad_norm']), the optimizer's
    step, the EMA."""
    with annotate('ftt.train.update'):
        reduce_gradients(model.parameters())
        metrics.update(reduce_metrics(metrics))
        shards = shards_of(model)
        if shards is not None:
            shards.shard_grads()
        if clip is not None:
            metrics['grad_norm'] = clip_by_global_norm(
                model.parameters(), float(clip), shards)
        optimizer.step()
        if ema is not None:
            ema.update(model)


class Preemption:
    """Graceful stop on SIGTERM/SIGINT: while active (`with`), the
    signals set a flag that the step loop polls, so the trainer saves
    `latest_model` and returns; the resume path continues the run on the
    next invocation. A second SIGINT raises KeyboardInterrupt. The
    previous handlers are restored on exit. Outside the main thread the
    signals are left alone and only `request()` sets the flag."""

    def __init__(self) -> None:
        self._event = threading.Event()
        self._saved = {}

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def request(self) -> None:
        self._event.set()

    def _handler(self, signum, frame) -> None:
        if self._event.is_set() and signum == signal.SIGINT:
            raise KeyboardInterrupt
        self._event.set()

    def __enter__(self) -> 'Preemption':
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._saved[sig] = signal.signal(sig, self._handler)
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._saved.items():
            signal.signal(sig, prev)
        self._saved = {}


class NoWriter:
    """The checkpoint writer of a rank that writes nothing (every rank
    but 0): `save` drops the payload, `wait` returns."""

    def save(self, payload, path, on_complete=None) -> None:
        return None

    def wait(self) -> None:
        return None


def trainer_mesh(config: Dict[str, Any], mesh: Optional[Mesh] = None
                 ) -> Optional[Mesh]:
    """A trainer's mesh: `mesh` where given, else the mesh of `config`
    when a process group of more than one rank is up (the JAX trainers'
    rule: more than one device), else None. A mesh of one process's
    devices cannot train (one process runs one rank)."""
    if mesh is None and torch.distributed.is_available() \
            and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        mesh = mesh_from_config(config)
    if mesh is not None and mesh.group is None and mesh.size > 1:
        raise ValueError(f'{mesh}: a trainer\'s mesh spans the ranks of a '
                         'process group, one device each (torchrun)')
    return mesh


class Ranks:
    """A trainer's place among the data-parallel ranks of `mesh` (None:
    the one process there is). Every method that talks to the other
    ranks must be called by all of them at the same point."""

    def __init__(self, mesh: Optional[Mesh]) -> None:
        self.mesh = mesh
        self.modules: List[torch.nn.Module] = []

    @property
    def main(self) -> bool:
        """Global rank 0 (or no mesh): the rank that prints, evaluates and
        writes."""
        return self.mesh is None or self.mesh.global_rank == 0

    @property
    def rank(self) -> int:
        """The data index: the peers of a model group take the same rows
        and draw the same masks."""
        return 0 if self.mesh is None else self.mesh.rank

    def device(self, device) -> torch.device:
        """The trainer's device: this rank's under a mesh, else `device`
        (`resolve_device`)."""
        return self.mesh.device if self.mesh is not None \
            else resolve_device(device)

    def step(self):
        """The context of a training step: `parallel.data_parallel`."""
        return data_parallel(self.mesh)

    def rows(self, batch: Dict[str, Any], micro: int = 1
             ) -> Dict[str, Any]:
        """This rank's rows of the global batch (`parallel.local_rows`)."""
        return local_rows(self.mesh, batch, micro)

    def generator(self, device, seed: int, step: int) -> torch.Generator:
        """The step's generator, seeded (seed + rank, step): at one process
        and at rank 0 the one-process trainer's."""
        return torch.Generator(device=device).manual_seed(
            (seed + self.rank) * 1_000_003 + step)

    def start(self, modules: Sequence[torch.nn.Module],
              seed: Optional[int] = None) -> None:
        """At a run's start over more than one rank: global rank 0's
        weights on every rank, and the global RNG (ForwardTacotron's
        dropout) seeded with seed + data index where a seed is given."""
        if self.mesh is None \
                or self.mesh.size * self.mesh.shape['model'] == 1:
            return
        for m in modules:
            broadcast_state(m, self.mesh)
        if seed is not None:
            torch.manual_seed(seed + self.rank)

    def shard(self, modules: Sequence[torch.nn.Module],
              optimizers: Sequence[torch.optim.Optimizer] = (),
              ema: Optional[EMA] = None) -> None:
        """Over a 'model' axis, each module kept in shards from now on
        (`parallel.model_axis`), with its state in `optimizers` and, for
        the first module, `ema`; nothing without one."""
        for i, m in enumerate(modules):
            if shard_module(m, self.mesh, optimizers,
                            ema if i == 0 else None) is not None:
                self.modules.append(m)

    def whole(self):
        """The context in which the modules sharded over the 'model' axis
        are whole on every rank, with their optimizer state and EMA (every
        rank enters it together): evaluation, plots and checkpoints."""
        return whole_state(self.modules)

    def finish(self) -> None:
        """At a run's end: the sharded modules whole again for good (every
        rank calls it together)."""
        for m in self.modules:
            unshard(m)
        self.modules = []

    def stop(self, preemption: 'Preemption') -> bool:
        """Whether to stop: the preemption flag, agreed over the ranks
        (any rank's request stops them all, at the same step)."""
        if self.mesh is None or self.mesh.group is None:
            return preemption.requested
        flag = torch.tensor([int(preemption.requested)])
        torch.distributed.all_reduce(flag, torch.distributed.ReduceOp.MAX,
                                     group=self.mesh.host_group)
        if flag.item():
            preemption.request()
        return bool(flag.item())

    def barrier(self) -> None:
        """Wait for every rank (rank 0's evaluation and files)."""
        if self.mesh is not None and self.mesh.group is not None:
            torch.distributed.barrier(group=self.mesh.host_group)

    def writer(self):
        """The checkpoint writer: rank 0's, `NoWriter` elsewhere."""
        return AsyncCheckpointWriter() if self.main else NoWriter()

    @contextlib.contextmanager
    def output(self) -> Iterable:
        """stdout as it is on rank 0, silenced on the others."""
        if self.main:
            yield
            return
        with open(os.devnull, 'w') as sink, contextlib.redirect_stdout(sink):
            yield


def summary_writer(log_dir: Union[str, Path]):
    """A tensorboardX `SummaryWriter(log_dir)` (JAX's trainers' default
    writer), or None, after a one-line note, where tensorboardX is not
    installed."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        print(f'| tensorboardX is not installed: scalars go to stdout only, '
              f'and no event files are written to {log_dir}', flush=True)
        return None
    return SummaryWriter(log_dir=str(log_dir))


class Logging:
    """The TensorBoard writer of a trainer (`ranks`, `log_dir`): the
    `writer` assigned (the trainers' `writer=`), else on the main rank a
    `summary_writer(log_dir)` made at first use; None on the other
    ranks."""
    ranks: 'Ranks'
    log_dir: Path
    _writer: Any = None
    _writer_made = False
    _plots_noted = False

    @property
    def writer(self):
        if not self.ranks.main:
            return None
        if self._writer is None and not self._writer_made:
            self._writer_made = True
            self._writer = summary_writer(self.log_dir)
        return self._writer

    @writer.setter
    def writer(self, writer) -> None:
        self._writer = writer
        self._writer_made = writer is not None

    def _scalar(self, tag: str, value: float, step: int) -> None:
        writer = self.writer
        if writer is not None:
            writer.add_scalar(tag, value, step)

    def _add_figure(self, tag: str, plot: Callable, data, step: int
                    ) -> None:
        """writer.add_figure(tag, plot(data), step) (tensors as float32
        arrays); nothing without a writer, nor, after a one-time note,
        where matplotlib cannot be imported."""
        writer = self.writer
        if writer is None:
            return
        if not can_plot():
            if not self._plots_noted:
                print('| matplotlib is not installed: the figures are '
                      'skipped, the audio samples are written', flush=True)
                self._plots_noted = True
            return
        if torch.is_tensor(data):
            data = data.detach().float().cpu().numpy()
        writer.add_figure(tag, plot(data), step)

    def _flush_writer(self) -> None:
        """The writer's events on disk (the end of a run)."""
        flush = getattr(self._writer, 'flush', None)
        if flush is not None and self.ranks.main:
            flush()


class Averager:
    def __init__(self) -> None:
        self.count = 0
        self.val = 0.0

    def add(self, val: float) -> None:
        self.val += float(val)
        self.count += 1

    def reset(self) -> None:
        self.val, self.count = 0.0, 0

    def get(self) -> float:
        return self.val / self.count if self.count > 0 else 0.0


class TTSSession:
    def __init__(self, index: int, r: int, lr: float, max_step: int,
                 bs: int, train_set, val_set, start_step: int = 0) -> None:
        self.index = index
        self.r = r
        self.lr = lr
        self.max_step = max_step
        self.bs = bs
        self.train_set = train_set
        self.val_set = val_set
        self.start_step = start_step
        # the batch `generate_plots` draws from (JAX `TTSSession`)
        self.val_sample = val_set.first_batch() if hasattr(
            val_set, 'first_batch') else None


class VocSession:
    def __init__(self, index: int, lr: float, max_step: int, bs: int,
                 train_set, val_set, val_set_samples,
                 start_step: int = 0) -> None:
        self.index = index
        self.lr = lr
        self.max_step = max_step
        self.bs = bs
        self.train_set = train_set
        self.val_set = val_set
        self.val_set_samples = val_set_samples
        self.start_step = start_step


class TopKTracker:
    """The k best checkpoints by score (lower is better) in `directory`,
    with their index in `<directory>/top_k.pkl`: a list of (score, step,
    file name), best first, which a resumed run reads and continues (the
    JAX package's `train/common.py:TopKTracker`). A score that makes the
    top k is saved; once its file is on disk, the files pushed out are
    deleted and the index is written, listing only files on disk. A
    replayed step (an exact resume re-offers it) replaces its entry."""

    def __init__(self, directory: Union[str, Path], k: int,
                 prefix: str) -> None:
        self.directory = Path(directory)
        self.k = int(k)
        self.prefix = prefix
        self.index_path = self.directory / 'top_k.pkl'
        self.entries = []
        if self.index_path.exists():
            self.entries = unpickle_binary(self.index_path)

    def update(self, score: float, step: int,
               save: Callable[[Path, Callable[[], None]], None]) -> bool:
        """Offer the checkpoint of `step`; where it makes the top k,
        `save(path, on_disk)` writes it and calls `on_disk()` once the
        file is there (at once, or on a writer thread:
        `AsyncCheckpointWriter.save(..., on_complete=on_disk)`). Returns
        whether it was kept."""
        if self.k <= 0:
            return False
        if len(self.entries) >= self.k \
                and score >= max(e[0] for e in self.entries):
            return False
        name = f'{self.prefix}_step{step}_score{score:.5f}.pt'
        ranked = sorted([e for e in self.entries if e[2] != name]
                        + [(float(score), int(step), name)],
                        key=lambda e: e[0])
        pruned = [old for _, _, old in ranked[self.k:]]
        self.entries = kept = ranked[:self.k]
        directory, index_path = self.directory, self.index_path

        def on_disk() -> None:
            for old in pruned:
                try:
                    os.remove(directory / old)
                except FileNotFoundError:
                    pass
            pickle_binary([e for e in kept if (directory / e[2]).exists()],
                          index_path)

        save(self.directory / name, on_disk)
        return True


class DeferredFlush:
    """One-iteration-late metric fetch: the trainer queues step k+1 on
    the device before it reads step k's metrics (which waits for the
    device), so host logging overlaps device work. Holds the one pending
    item and flushes each exactly once."""

    def __init__(self, flush_fn) -> None:
        self._fn = flush_fn
        self._pending = None

    def push(self, *item) -> None:
        if self._pending is not None:
            self._fn(*self._pending)
        self._pending = item

    def flush(self) -> None:
        if self._pending is not None:
            self._fn(*self._pending)
            self._pending = None


def resume_position(current_step: int, session_start: int,
                    iters_per_epoch: int) -> Tuple[int, int]:
    """(epoch, batch offset) of step `current_step` in a session that
    began at `session_start`: every step consumes one batch, so with the
    epoch-seeded batch plans a resumed run continues the data stream of
    an uninterrupted one."""
    done = max(int(current_step) - int(session_start), 0)
    iters = max(int(iters_per_epoch), 1)
    return done // iters, done % iters


def make_optimizer(model: torch.nn.Module, lr: float = 1e-4
                   ) -> torch.optim.Adam:
    """Adam with torch's defaults, which equal optax's (betas 0.9/0.999,
    eps 1e-8 outside the square root). Clipping is `clip_by_global_norm`,
    applied by `train_step` before the update."""
    return torch.optim.Adam(model.parameters(), lr=lr)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every group's learning rate; a rate held in a tensor (the step
    graphs' Adam, `StepGraphs`) is filled in place, so that the next
    replay reads it."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group['lr']):
            group['lr'].fill_(lr)
        else:
            group['lr'] = lr


def clip_by_global_norm(params: Iterable[torch.Tensor],
                        max_norm: float, shards=None) -> torch.Tensor:
    """Scale the gradients in place by min(1, max_norm / ||g||), ||g|| the
    norm of all of them together: optax's `clip_by_global_norm`.
    `torch.nn.utils.clip_grad_norm_` divides by ||g|| + 1e-6 instead.
    With `shards` (the params' `ModelShards`), ||g|| is that of the whole
    gradients (`grad_norm`). Returns ||g|| before clipping; no host
    synchronisation."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = shards.grad_norm() if shards is not None else \
        torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def forward_loss(pred: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                 pitch_target: torch.Tensor, energy_target: torch.Tensor,
                 train_cfg: Dict[str, Any]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """ForwardTacotron / FastPitch loss (the reference's
    forward_trainer.py:86-96): both mels, FastPitch's being one tensor."""
    m1 = masked_l1(pred['mel'], batch['mel'], batch['mel_len'])
    m2 = masked_l1(pred['mel_post'], batch['mel'], batch['mel_len'])
    dur_loss = masked_l1(pred['dur'], batch['dur'], batch['x_len'])
    pitch_loss = masked_l1(pred['pitch'], pitch_target, batch['x_len'])
    energy_loss = masked_l1(pred['energy'], energy_target, batch['x_len'])
    loss = (m1 + m2
            + train_cfg['dur_loss_factor'] * dur_loss
            + train_cfg['pitch_loss_factor'] * pitch_loss
            + train_cfg['energy_loss_factor'] * energy_loss)
    metrics = {'loss': loss, 'mel_loss': m1 + m2, 'dur_loss': dur_loss,
               'pitch_loss': pitch_loss, 'energy_loss': energy_loss}
    return loss, {k: v.detach() for k, v in metrics.items()}


def _zoneout(batch, generator, train_cfg):
    """Pitch/energy inputs with each value zeroed at the configured
    rate, drawn from `generator` (the reference's forward_trainer.py:76-82);
    the loss keeps the unmasked targets."""
    out = dict(batch)
    for key in ('pitch', 'energy'):
        rate = float(train_cfg.get(f'{key}_zoneout', 0.0))
        if rate > 0:
            keep = torch.rand(batch[key].shape, generator=generator,
                              device=batch[key].device) > rate
            out[key] = batch[key] * keep
    return out


def grad_accum(train_cfg: Dict[str, Any]) -> int:
    return int(train_cfg.get('grad_accum', 1) or 1)


def forward_step_batch(batch: Dict[str, torch.Tensor],
                       generator: torch.Generator, train_cfg: Dict[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """The batch a student step trains on: pitch and energy zoned out
    (`_zoneout`), their true values beside them as the loss's targets."""
    return dict(_zoneout(batch, generator, train_cfg),
                pitch_target=batch['pitch'], energy_target=batch['energy'])


def forward_micro_loss(model: torch.nn.Module, train_cfg: Dict[str, Any],
                       generator: Optional[torch.Generator] = None
                       ) -> Callable:
    """The student step's `micro_loss(b) -> (loss, metrics, None)` for
    `accumulate`, `b` a (micro-)batch of `forward_step_batch`: the
    teacher-forced forward under `train_cfg`'s precision and remat, its
    predictions in float32, the loss against the true targets. The model
    is given `generator` for its dropout draws (FastPitch draws from it,
    ForwardTacotron's `nn.Dropout` from the global RNG)."""
    half = half_dtype(train_cfg)
    remat = bool(train_cfg.get('remat', False))
    gens = () if generator is None else (generator,)

    def micro_loss(b):
        pred = full(forward_model(model, b, *gens, half=half, remat=remat,
                                  generators=gens))
        loss, metrics = forward_loss(pred, b, b['pitch_target'],
                                     b['energy_target'], train_cfg)
        return loss, metrics, None
    return micro_loss


def _step_body(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor], generator: torch.Generator,
               train_cfg: Dict[str, Any], ema: Optional[EMA]
               ) -> Dict[str, torch.Tensor]:
    """The student step after its zero_grad: zoneout, forward, loss,
    backward, clip, Adam, the EMA; its metrics."""
    metrics, _ = accumulate(
        forward_micro_loss(model, train_cfg, generator),
        forward_step_batch(batch, generator, train_cfg),
        grad_accum(train_cfg), model)
    apply_update(model, optimizer, metrics, train_cfg.get('clip_grad_norm'),
                 ema)
    return metrics


def _eager_step(model, optimizer, batch, generator, train_cfg, ema=None):
    """`train_step` run eagerly, whatever the graph path would do (the
    tests' reference for it)."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    return _step_body(model, optimizer, batch, generator, train_cfg, ema)


# what of train_cfg the student step reads: a change captures anew
STEP_OPTIONS = ('precision', 'grad_accum', 'remat', 'clip_grad_norm',
                'pitch_zoneout', 'energy_zoneout', 'dur_loss_factor',
                'pitch_loss_factor', 'energy_loss_factor')


class _Graph(NamedTuple):
    """One captured step: its graph, static inputs (by batch key), metric
    names and their packed output, the gradient each parameter holds after
    a replay (None: it gets none) and the launches it holds."""
    graph: Any
    static: Dict[str, torch.Tensor]
    keys: List[str]
    packed: torch.Tensor
    grads: List[Optional[torch.Tensor]]
    launches: List[tuple]


def _make_capturable(optimizer: torch.optim.Adam, trained, device) -> None:
    """Adam as the graphs run it: capturable (its step counts on the
    card), each group's `lr` a float32 tensor on the card that
    `set_learning_rate` fills, and the state of each parameter in
    `trained` made as its first step would make it (zeros, step 0) or its
    step count moved to the card. The update is torch's capturable Adam:
    optax's formula, as the eager step's. Done at the first capture, not
    in `make_optimizer`, which every trainer shares and only the student's
    step captures."""
    trained = {id(p) for p in trained}
    for group in optimizer.param_groups:
        group['capturable'] = True
        if not torch.is_tensor(group['lr']):
            group['lr'] = torch.tensor(float(group['lr']),
                                       dtype=torch.float32, device=device)
        moments = ('exp_avg', 'exp_avg_sq') + (
            ('max_exp_avg_sq',) if group['amsgrad'] else ())
        for p in (p for p in group['params'] if id(p) in trained):
            state = optimizer.state[p]
            if not state:
                state['step'] = torch.zeros((), dtype=torch.float32,
                                            device=p.device)
                for k in moments:
                    state[k] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
            elif state['step'].device != p.device:
                state['step'] = state['step'].to(p.device, torch.float32)


class StepGraphs:
    """The student step of one (model, optimizer, EMA) as CUDA graphs, one
    per batch key: the batch's keys, shapes and dtypes and the step's
    options (`STEP_OPTIONS`, the EMA's decay). All graphs draw their
    memory from one pool, so what they hold follows the largest shape, not
    the number of shapes; the gradients and Adam's state are one set
    outside it.

    At a new key (`_capture`): one forward and backward of the batch with
    no update on a side stream, everything it moved put back (`_warm_up`);
    Adam made capturable (`_make_capturable`); the whole step captured
    (zero the gradients, zoneout, forward, loss, backward, clip, Adam, the
    EMA) into the pool; then replayed for this very step, as every later
    step of the key is (`_replay`): the batch copied into the graph's
    static inputs on the card, the graph's step generator set to the
    state of the `generator` given (so that a replay draws what the eager
    step draws, in the same order; the global CUDA generator, which
    ForwardTacotron's dropout draws from, is registered by the capture
    itself), the given generator advanced as the eager step would, each
    parameter's `.grad` set to the gradient the graph clipped.

    Kernels #2/#3's counters (`kernels/birnn_train.py`) count their
    wrappers' calls: a new key's warm-up and its capture each call them
    once a launch, a replay not at all; a profiler counts the launches the
    card ran (`utils/profiling.py:kernel_launches`), and the step spans'
    `path` says which steps were which.

    A change of what the graphs hold (`fits`: another model or EMA, a
    parameter or EMA tensor moved, the optimizer's state or groups
    replaced, as `load_state_dict` does) drops them all."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, ema: Optional[EMA],
                 device: torch.device) -> None:
        self.model, self.ema, self.device = model, ema, device
        self.params = list(model.parameters())
        self.ptrs = self._ptrs()
        self.opt_state = optimizer.state
        self.groups = list(optimizer.param_groups)
        self.pool = torch.cuda.graph_pool_handle()
        self.gen = torch.Generator(device=device)
        self.grads: Dict[int, torch.Tensor] = {}
        self.lrs: List[Any] = []
        self.graphs: Dict[tuple, _Graph] = {}

    def _ptrs(self) -> tuple:
        ema = () if self.ema is None else self.ema.params.values()
        return tuple(t.data_ptr() for t in self.params) + \
            tuple(t.data_ptr() for t in ema)

    def fits(self, model, optimizer, ema) -> bool:
        return model is self.model and ema is self.ema \
            and optimizer.state is self.opt_state \
            and len(optimizer.param_groups) == len(self.groups) \
            and all(a is b for a, b in zip(optimizer.param_groups,
                                           self.groups)) \
            and self._ptrs() == self.ptrs

    def step(self, optimizer, batch, generator, train_cfg):
        key = (tuple((k, v.shape, v.dtype) for k, v in batch.items()),
               tuple(repr(train_cfg.get(k)) for k in STEP_OPTIONS),
               None if self.ema is None else self.ema.decay)
        graph = self.graphs.get(key)
        with annotate('ftt.train.step',
                      path='replay' if graph is not None else 'capture'):
            self.model.train()
            if graph is None:
                graph = self.graphs[key] = self._capture(
                    optimizer, batch, generator, train_cfg)
            return self._replay(graph, optimizer, batch, generator)

    def _warm_up(self, batch, generator, train_cfg) -> List[bool]:
        """Forward and backward of `batch` with no update, on a side
        stream (the first use of each cuDNN, cuBLAS and kernel shape stays
        out of the capture), then `.grad`, the model's buffers (BatchNorm's
        running statistics), the global CUDA generator and `generator` put
        back. Returns which parameters got a gradient."""
        model, dev = self.model, self.device
        saved = [p.grad for p in self.params]
        buffers = [b.detach().clone() for b in model.buffers()]
        rng = torch.cuda.get_rng_state(dev)
        gen_state = generator.get_state()
        for p in self.params:
            p.grad = None
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            accumulate(forward_micro_loss(model, train_cfg, generator),
                       forward_step_batch(batch, generator, train_cfg),
                       grad_accum(train_cfg), model)
        torch.cuda.current_stream(dev).wait_stream(side)
        trained = [p.grad is not None for p in self.params]
        for p, grad in zip(self.params, saved):
            p.grad = grad
        with torch.no_grad():
            for b, value in zip(model.buffers(), buffers):
                b.copy_(value)
        torch.cuda.set_rng_state(rng, dev)
        generator.set_state(gen_state)
        return trained

    def _capture(self, optimizer, batch, generator, train_cfg) -> _Graph:
        static = {k: v.clone() for k, v in batch.items()}
        trained = self._warm_up(static, generator, train_cfg)
        _make_capturable(optimizer, [p for p, t in zip(self.params, trained)
                                     if t], self.device)
        self.lrs = [g['lr'] for g in optimizer.param_groups]
        grads = []
        for i, (p, t) in enumerate(zip(self.params, trained)):
            if t and i not in self.grads:
                self.grads[i] = torch.zeros_like(p)
            grads.append(self.grads[i] if t else None)
            p.grad = grads[-1]
        live = [g for g in grads if g is not None]
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.gen)
        with captured_launches() as launches, torch.cuda.graph(
                graph, pool=self.pool, capture_error_mode='thread_local'):
            if live:
                torch._foreach_zero_(live)
            metrics = _step_body(self.model, optimizer, static, self.gen,
                                 train_cfg, self.ema)
            keys = list(metrics)
            packed = torch.stack([metrics[k].float() for k in keys])
        return _Graph(graph, static, keys, packed, grads, list(launches))

    def _replay(self, g: _Graph, optimizer, batch, generator):
        torch._foreach_copy_(list(g.static.values()), list(batch.values()))
        for group, lr in zip(optimizer.param_groups, self.lrs):
            if group['lr'] is not lr:       # a float put there directly
                lr.fill_(float(group['lr']))
                group['lr'] = lr
        self.gen.set_state(generator.get_state())
        start = time.perf_counter_ns()
        g.graph.replay()
        end = time.perf_counter_ns()
        generator.set_state(self.gen.get_state())
        for p, grad in zip(self.params, g.grads):
            if p.grad is not grad:
                p.grad = grad
        replayed(g.launches, start, end)
        return dict(zip(g.keys, g.packed.clone().unbind(0)))


# the step graphs of each optimizer (dropped with it)
_GRAPHS: 'weakref.WeakKeyDictionary[torch.optim.Optimizer, StepGraphs]' = \
    weakref.WeakKeyDictionary()


def _graph_device(model, optimizer, batch, generator, train_cfg,
                  graphs: Optional[StepGraphs]) -> Optional[torch.device]:
    """The CUDA device on which `train_step` runs as a graph (that of
    `graphs`, the optimizer's step graphs where they still fit), or None
    where it runs eagerly (`train_step`'s list of cases)."""
    if not torch.cuda.is_available() or train_cfg.get('remat') \
            or generator is None or generator.device.type != 'cuda' \
            or active_mesh() is not None or shards_of(model) is not None \
            or (torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1) \
            or type(optimizer) is not torch.optim.Adam \
            or any(g.get('fused') or g.get('differentiable')
                   for g in optimizer.param_groups):
        return None
    devices = {graphs.device} if graphs is not None \
        else {p.device for p in model.parameters()}
    if len(devices) != 1:
        return None
    (dev,) = devices
    if dev.type != 'cuda' or generator.device.index not in (None, dev.index) \
            or any(not torch.is_tensor(v) or v.device != dev
                   for v in batch.values()):
        return None
    return dev


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor], generator: torch.Generator,
               train_cfg: Dict[str, Any], ema: Optional[EMA] = None
               ) -> Dict[str, torch.Tensor]:
    """One optimization step in train mode (the JAX package's
    `build_forward_train_step`, ForwardTacotron or FastPitch):
    teacher-forced forward on the zoned-out batch, loss against the true
    targets, backward, global-norm clip, Adam, the EMA, with the options of
    `train_cfg` (precision, grad_accum, remat). `generator` draws the
    zoneout, then FastPitch's dropout. The clipped gradients stay in
    `.grad`. Returns the step's metrics (device tensors, including the norm
    before clipping).

    Where the parameters are on one CUDA device, the step replays the CUDA
    graph of its batch key (`StepGraphs`; captured at the key's first
    step, which is a replay too) and makes the optimizer capturable Adam
    for good. It runs eagerly for CPU tensors, `remat` (its recompute
    sets generator states, which a capture cannot), inside
    `parallel.data_parallel` with a mesh of any size or with a process
    group of more than one rank up, over a 'model' axis, for an optimizer
    other than torch's Adam (or a fused or differentiable one), without a
    CUDA `generator` on the parameters' device, and where a batch value is
    not a tensor on that device. While a profiler records, the step's span
    `ftt.train.step` has `path` 'replay', 'capture' or 'eager'."""
    graphs = _GRAPHS.get(optimizer)
    if graphs is not None and not graphs.fits(model, optimizer, ema):
        del _GRAPHS[optimizer]
        graphs = None
    dev = _graph_device(model, optimizer, batch, generator, train_cfg,
                        graphs)
    if dev is None:
        with annotate('ftt.train.step', path='eager'):
            return _eager_step(model, optimizer, batch, generator,
                               train_cfg, ema)
    if graphs is None:
        graphs = _GRAPHS[optimizer] = StepGraphs(model, optimizer, ema, dev)
    return graphs.step(optimizer, batch, generator, train_cfg)


@torch.no_grad()
def eval_step(model: torch.nn.Module, batch: Dict[str, torch.Tensor],
              train_cfg: Dict[str, Any],
              params: Optional[Dict[str, torch.Tensor]] = None
              ) -> Dict[str, torch.Tensor]:
    """Loss metrics of the teacher-forced forward in eval mode (running
    BN statistics, no dropout), with `params` (the EMA weights) in place
    of the model's own where given; the model's mode is restored."""
    was_training = model.training
    model.eval()
    try:
        pred = model(batch) if params is None else \
            torch.func.functional_call(model, params, (batch,))
    finally:
        model.train(was_training)
    return forward_loss(pred, batch, batch['pitch'], batch['energy'],
                        train_cfg)[1]
