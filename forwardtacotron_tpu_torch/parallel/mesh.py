"""The ('data', 'model') mesh of the port, and the global sums of a
data-parallel training step.

The JAX package's `parallel/mesh.py` builds a `jax.sharding.Mesh` from
`config.yaml`'s `tpu.mesh` and lets GSPMD shard the batch over 'data' and
the wide parameters over 'model' (`_param_spec`): the sharded step is
exactly the one-device step on the global batch. The port does the same
with torch's process groups, one process a device:

- `Mesh` is the shape {'data': n_data, 'model': n_model}, the devices of
  its data axis (one a rank of the group, or the devices of one process
  that `vocode_batch` shards utterances over; a device may appear twice)
  and its process groups. Global rank r sits at data index r // n_model
  and model index r % n_model (JAX reshapes its devices so). `group` joins
  the ranks of one model index (the data axis), `model_group` those of one
  data index (the 'model' axis).
- A trainer runs its step inside `data_parallel(mesh)`. There
  `models/layers.py:batch_norm` takes its mean and variance over the
  global batch (`global_sum`, differentiable), `ops/masking.py:masked_l1`
  divides by the global count (`sum_over_ranks`), and
  `train/common.py:apply_update` averages the gradients and the metrics
  over the data axis (`reduce_gradients`, `reduce_metrics`) before the
  clip. Each rank's loss is then its share such that the ranks' mean is
  the global loss, so the averaged gradient is the global batch's.
- The 'model' axis shards the storage, not the arithmetic
  (`parallel/model_axis.py`): between steps each rank keeps its shard
  (`param_spec`, JAX's `_param_spec` in torch's layout) of the parameters,
  of Adam's moments and of the EMA, and a step gathers the whole weights
  over `model_group` before the forward. The peers of a model group take
  the same rows and compute the same step. A mesh of one process's
  devices has no 'model' axis.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist


class Mesh:
    """A ('data', 'model') mesh: `shape`, `devices` (the data axis's, one
    a data index), `group` (the process group of the data axis, None for
    the devices of one process), `host_group` (a gloo group over every
    rank of the mesh, for host-side agreement: flags, barriers) and, where
    'model' > 1, `model_group` (this rank's peers on the 'model' axis).
    `all_devices` lists every rank's device, data-major."""

    def __init__(self, devices: Sequence, group=None, host_group=None,
                 n_model: int = 1, model_group=None) -> None:
        self.all_devices: List[torch.device] = [torch.device(d)
                                                for d in devices]
        n_data = len(self.all_devices) // n_model
        self.shape: Dict[str, int] = {'data': n_data, 'model': n_model}
        self.group = group
        self.host_group = host_group
        self.model_group = model_group
        self.devices: List[torch.device] = [
            self.all_devices[d * n_model + self.model_rank]
            for d in range(n_data)]

    @property
    def size(self) -> int:
        """The data axis's size."""
        return self.shape['data']

    @property
    def global_rank(self) -> int:
        return 0 if self.group is None else dist.get_rank()

    @property
    def rank(self) -> int:
        """This process's index on the data axis (0 without a group)."""
        return self.global_rank // self.shape['model']

    @property
    def model_rank(self) -> int:
        """This process's index on the 'model' axis."""
        return self.global_rank % self.shape['model']

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.all_devices[self.global_rank]

    def __repr__(self) -> str:
        where = 'one process' if self.group is None else \
            f'{dist.get_backend(self.group)} group, rank {self.global_rank}'
        return (f'Mesh({self.shape}, devices='
                f'{[str(d) for d in self.all_devices]}, {where})')


def _rank_device(rank: int) -> torch.device:
    """The device of `rank` on one host: cuda:LOCAL_RANK for this process
    under torchrun, cuda:(rank mod the device count) for the others, the
    CPU without CUDA."""
    if not torch.cuda.is_available():
        return torch.device('cpu')
    if rank == dist.get_rank() and 'LOCAL_RANK' in os.environ:
        return torch.device('cuda', int(os.environ['LOCAL_RANK']))
    return torch.device('cuda', rank % torch.cuda.device_count())


_HOST_GROUPS: Dict[Any, Any] = {}


def host_group(group):
    """A gloo group over `group`'s ranks (made once: every rank must call
    this together the first time), or `group` where it is gloo."""
    if dist.get_backend(group) == 'gloo':
        return group
    if group not in _HOST_GROUPS:
        _HOST_GROUPS[group] = dist.new_group(backend='gloo')
    return _HOST_GROUPS[group]


_AXIS_GROUPS: Dict[tuple, tuple] = {}


def _axis_groups(n_data: int, n_model: int) -> tuple:
    """(data group, model group) of this rank in a world laid out as
    (n_data, n_model): the ranks of its model index, and those of its data
    index. Made once a shape and default group; every rank must call this
    together the first time."""
    key = (dist.group.WORLD, n_data, n_model)
    if key not in _AXIS_GROUPS:
        data, _ = dist.new_subgroups_by_enumeration(
            [list(range(m, n_data * n_model, n_model))
             for m in range(n_model)])
        model, _ = dist.new_subgroups_by_enumeration(
            [list(range(d * n_model, (d + 1) * n_model))
             for d in range(n_data)])
        _AXIS_GROUPS[key] = (data, model)
    return _AXIS_GROUPS[key]


def make_mesh(n_data: int = -1, n_model: int = 1, devices=None) -> Mesh:
    """A ('data', 'model') mesh (JAX `make_mesh`). With `torch.distributed`
    up, the mesh spans the default group's ranks, one device each
    (`devices` a rank's, default cuda:LOCAL_RANK), rank r at data index
    r // n_model and model index r % n_model; n_data -1 takes every rank,
    and n_data x n_model must match them. Without a group, the `devices`
    of this process (default every CUDA device, else the CPU) make the
    data axis: n_model > 1 raises ValueError there."""
    n_model = int(n_model)
    up = dist.is_available() and dist.is_initialized()
    if n_model < 1 or (n_model > 1 and not up):
        raise ValueError(
            f'tpu.mesh.model={n_model}: the mesh\'s \'model\' axis spans '
            'the ranks of a process group, one device each (torchrun); a '
            'mesh of one process\'s devices has tpu.mesh.model: 1')
    if devices is None:
        if up:
            devices = [_rank_device(r) for r in range(dist.get_world_size())]
        elif torch.cuda.is_available():
            devices = [torch.device('cuda', i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [torch.device('cpu')]
    devices = list(devices)
    if n_data == -1:
        n_data = len(devices) // n_model
    if n_data * n_model != len(devices):
        raise ValueError(f'mesh {n_data}x{n_model} does not match '
                         f'{len(devices)} devices')
    if not up:
        return Mesh(devices)
    if n_data * n_model != dist.get_world_size():
        raise ValueError(f'mesh {n_data}x{n_model} does not match the '
                         f'{dist.get_world_size()} ranks of the group')
    world = dist.group.WORLD
    if n_model == 1:
        return Mesh(devices, world, host_group(world))
    data, model = _axis_groups(n_data, n_model)
    return Mesh(devices, data, host_group(world), n_model, model)


def mesh_from_config(config: Dict[str, Any], devices=None) -> Mesh:
    """The mesh of `config['tpu']['mesh']` (data -1 and model 1 where
    absent), JAX `mesh_from_config`."""
    mesh_cfg = (config.get('tpu') or {}).get('mesh') or {}
    return make_mesh(n_data=int(mesh_cfg.get('data', -1)),
                     n_model=int(mesh_cfg.get('model', 1)), devices=devices)


# ------------------------------------------------- the 'model' axis's rule

GATE_LEAVES = ('w_ih', 'w_hh', 'b_ih', 'b_hh')


def param_spec(leaf: str, shape: Sequence[int], dim: Optional[int],
               n_model: int) -> Optional[int]:
    """The dim of a parameter of `shape` (torch layout) to shard over
    n_model ranks, or None to replicate it: JAX's `_param_spec` for the
    JAX `leaf` the parameter is converted from, `dim` the torch dim of
    the axis that rule looks at (`weights.jax_layout`). Packed gates shard
    their gate axis where n_model divides it; a kernel, an embedding or a
    bias its last (output-feature) axis where n_model divides it and it
    holds at least 2 n_model; the rest (scales, batch statistics, scalars,
    leaves named otherwise) is replicated."""
    if n_model <= 1 or len(shape) == 0 or dim is None:
        return None
    size = int(shape[dim])
    if leaf in GATE_LEAVES:
        return dim if size % n_model == 0 else None
    if leaf in ('kernel', 'embedding', 'bias'):
        return dim if size % n_model == 0 and size >= 2 * n_model else None
    return None


def param_specs(model: torch.nn.Module, n_model: int
                ) -> Dict[str, Optional[int]]:
    """{parameter name: `param_spec`} of every parameter of `model`."""
    from forwardtacotron_tpu_torch.weights import jax_layout
    layout = jax_layout(model)
    return {name: param_spec(layout[name][0], p.shape, layout[name][1],
                             n_model)
            for name, p in model.named_parameters()}


# ----------------------------------------------------- the training step

_ACTIVE: List[Optional[Mesh]] = [None]


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]) -> Iterator[None]:
    """Within it, the global sums below run over `mesh`'s group (None:
    nothing changes). Process-wide, not per thread: the backward, and a
    rematerialised forward's recompute, may run on autograd's threads."""
    before = _ACTIVE[0]
    _ACTIVE[0] = mesh
    try:
        yield
    finally:
        _ACTIVE[0] = before


def active_mesh() -> Optional[Mesh]:
    """The mesh of the `data_parallel` context open now (of any size), or
    None."""
    return _ACTIVE[0]


def spans_ranks() -> Optional[Mesh]:
    """The active mesh where its data axis spans more than one rank of a
    process group."""
    mesh = _ACTIVE[0]
    return mesh if mesh is not None and mesh.group is not None \
        and mesh.size > 1 else None


class _SumOverRanks(torch.autograd.Function):
    """y = the sum of x over the group's ranks; the gradient of x is the
    sum of y's gradients over the ranks (each rank's loss depends on
    every rank's x through y)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the active mesh's ranks, differentiable; x itself
    where no mesh spans more than one rank."""
    mesh = spans_ranks()
    return x if mesh is None else _SumOverRanks.apply(x, mesh.group)


def sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """x (no gradient) summed over the active mesh's ranks."""
    mesh = spans_ranks()
    if mesh is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=mesh.group)
    return y


def _mean_over_ranks(tensors: List[torch.Tensor], mesh: Mesh
                     ) -> List[torch.Tensor]:
    """The tensors averaged over the ranks, through one flat buffer per
    dtype."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.size)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


def reduce_gradients(params: Iterable[torch.Tensor]) -> None:
    """The gradients of `params` averaged in place over the active mesh's
    ranks (at one rank too: the sum of one is the tensor itself). No-op
    outside `data_parallel`."""
    mesh = _ACTIVE[0]
    if mesh is None or mesh.group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if grads:
        torch._foreach_copy_(grads, _mean_over_ranks(grads, mesh))


def reduce_metrics(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """The tensor metrics averaged over the active mesh's ranks (each a
    rank's share of the global value, so the mean is the global one),
    other values as they are."""
    mesh = _ACTIVE[0]
    if mesh is None or mesh.group is None:
        return metrics
    keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
    if not keys:
        return metrics
    means = _mean_over_ranks([metrics[k].detach().float() for k in keys],
                             mesh)
    return {**metrics, **dict(zip(keys, means))}


def broadcast_state(module: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """Global rank 0's parameters and buffers copied to every rank of
    `mesh` (both axes), as DistributedDataParallel does at its start."""
    if mesh is None or mesh.group is None \
            or mesh.size * mesh.shape['model'] == 1:
        return
    with torch.no_grad():
        for t in module.state_dict().values():
            dist.broadcast(t, src=0)
