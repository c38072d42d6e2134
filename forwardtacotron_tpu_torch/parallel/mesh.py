"""The ('data', 'model') mesh of the port, and the global sums of a
data-parallel training step.

The JAX package's `parallel/mesh.py` builds a `jax.sharding.Mesh` from
`config.yaml`'s `tpu.mesh` and lets GSPMD shard the batch over 'data':
the sharded step is exactly the one-device step on the global batch. The
port does the same with torch's process groups, one process a device:

- `Mesh` is the shape {'data': n, 'model': 1}, its devices (one a rank
  of the group, or the devices of one process that `vocode_batch` shards
  utterances over; a device may appear twice) and its process group.
- A trainer runs its step inside `data_parallel(mesh)`. There
  `models/layers.py:batch_norm` takes its mean and variance over the
  global batch (`global_sum`, differentiable), `ops/masking.py:masked_l1`
  divides by the global count (`sum_over_ranks`), and
  `train/common.py:apply_update` averages the gradients and the metrics
  over the ranks (`reduce_gradients`, `reduce_metrics`) before the clip.
  Each rank's loss is then its share such that the ranks' mean is the
  global loss, so the averaged gradient is the global batch's.

The 'model' axis (tensor parallelism) is not ported: `n_model` > 1 is
refused by name (`tpu.mesh.model`).
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist


class Mesh:
    """A data-parallel mesh: `shape` {'data': n, 'model': 1}, `devices`
    (n of them) and `group`, the process group whose ranks the data axis
    spans (None for the devices of one process). `host_group` is a gloo
    group over the same ranks for host-side agreement (flags, barriers):
    the group itself where it is gloo."""

    def __init__(self, devices: Sequence, group=None, host_group=None
                 ) -> None:
        self.devices: List[torch.device] = [torch.device(d)
                                            for d in devices]
        self.group = group
        self.host_group = host_group
        self.shape: Dict[str, int] = {'data': len(self.devices), 'model': 1}

    @property
    def size(self) -> int:
        return self.shape['data']

    @property
    def rank(self) -> int:
        """This process's index on the data axis (0 without a group)."""
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.devices[self.rank]

    def __repr__(self) -> str:
        where = 'one process' if self.group is None else \
            f'{dist.get_backend(self.group)} group, rank {self.rank}'
        return (f'Mesh({self.shape}, devices={[str(d) for d in self.devices]}'
                f', {where})')


def _refuse_model_axis(n_model: int) -> None:
    if int(n_model) != 1:
        raise ValueError(
            f'tpu.mesh.model={n_model}: the mesh\'s \'model\' axis (tensor '
            'parallelism) is not ported; the port shards the batch over '
            '\'data\' only (tpu.mesh.model: 1)')


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


def make_mesh(n_data: int = -1, n_model: int = 1, devices=None) -> Mesh:
    """A ('data', 'model') mesh (JAX `make_mesh`). With `torch.distributed`
    up, the data axis spans the default group's ranks, one device each
    (`devices` a rank's, default cuda:LOCAL_RANK); without it, the
    `devices` of this process (default every CUDA device, else the CPU).
    n_data -1 takes every device; another value must match them.
    n_model > 1 raises ValueError."""
    _refuse_model_axis(n_model)
    group = dist.group.WORLD if dist.is_available() \
        and dist.is_initialized() else None
    if devices is None:
        if group is not None:
            devices = [_rank_device(r) for r in range(dist.get_world_size())]
        elif torch.cuda.is_available():
            devices = [torch.device('cuda', i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [torch.device('cpu')]
    devices = list(devices)
    if n_data == -1:
        n_data = len(devices)
    if n_data != len(devices):
        raise ValueError(f'mesh {n_data}x{n_model} does not match '
                         f'{len(devices)} devices')
    if group is not None and n_data != dist.get_world_size():
        raise ValueError(f'mesh data axis {n_data} does not match the '
                         f'{dist.get_world_size()} ranks of the group')
    return Mesh(devices, group,
                None if group is None else host_group(group))


def mesh_from_config(config: Dict[str, Any], devices=None) -> Mesh:
    """The mesh of `config['tpu']['mesh']` (data -1 and model 1 where
    absent), JAX `mesh_from_config`."""
    mesh_cfg = (config.get('tpu') or {}).get('mesh') or {}
    return make_mesh(n_data=int(mesh_cfg.get('data', -1)),
                     n_model=int(mesh_cfg.get('model', 1)), devices=devices)


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
    """Rank 0's parameters and buffers copied to every rank of `mesh`, as
    DistributedDataParallel does at its start."""
    if mesh is None or mesh.group is None or mesh.size == 1:
        return
    with torch.no_grad():
        for t in module.state_dict().values():
            dist.broadcast(t, src=dist.get_global_rank(mesh.group, 0),
                           group=mesh.group)
