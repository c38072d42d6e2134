"""Bringing up `torch.distributed`, and each rank's rows of a global batch.

The JAX package's `parallel/distributed.py` brings up the multi-host
runtime and feeds each host its rows of a seed-deterministic global
batch. The port runs one process a GPU, launched by `torchrun`
(`python -m torch.distributed.run --nproc_per_node N -m
forwardtacotron_tpu_torch.train_forward`):

- `maybe_initialize(config, backend)` brings up the default process group
  from torchrun's environment (MASTER_ADDR / MASTER_PORT, WORLD_SIZE,
  RANK, LOCAL_RANK), or where `tpu.multihost` asks for it; without either
  it returns False and nothing changes.
- Every rank builds the same global batch (the batchers are seeded by
  epoch) and keeps its own rows: `local_rows` slices the collated batch,
  so every rank keeps the global padding, and `local_batch` also moves
  the rows to the rank's device.
"""
from __future__ import annotations

import atexit
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from forwardtacotron_tpu_torch.parallel.mesh import Mesh, host_group

TORCHRUN_ENV = ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK')


def maybe_initialize(config: Optional[Dict[str, Any]] = None,
                     backend: Optional[str] = None) -> bool:
    """Bring up the default process group when torchrun's environment is
    set or `config['tpu']['multihost']` asks for it; True if the group is
    (already) up. `backend` is the caller's: 'nccl' for CUDA, 'gloo' for
    the CPU (None: 'nccl' where CUDA is available, else 'gloo'). Under
    NCCL the process's device is set to cuda:LOCAL_RANK first. A failure
    raises; there is no other backend to fall back to."""
    if dist.is_available() and dist.is_initialized():
        return True
    want = bool(((config or {}).get('tpu') or {}).get('multihost')) \
        or all(k in os.environ for k in TORCHRUN_ENV)
    if not want:
        return False
    if not dist.is_available():
        raise RuntimeError('torch.distributed is not available in this '
                           'build of torch')
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    if backend == 'nccl':
        torch.cuda.set_device(int(os.environ.get('LOCAL_RANK', 0)))
    dist.init_process_group(backend=backend, init_method='env://')
    return True


def local_device(device='cuda') -> torch.device:
    """cuda:LOCAL_RANK under torchrun for a CUDA `device`, else
    `device`."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None \
            and 'LOCAL_RANK' in os.environ:
        return torch.device('cuda', int(os.environ['LOCAL_RANK']))
    return device


def training_device(config: Dict[str, Any], device) -> torch.device:
    """The device of a training CLI: `device` as it is, or, under
    torchrun, with the default group brought up (`maybe_initialize`: NCCL
    for a CUDA device, gloo for the CPU; destroyed when the process
    exits) and cuda:LOCAL_RANK for CUDA. A group already up is kept."""
    device = torch.device(device)
    if dist.is_available() and dist.is_initialized():
        return local_device(device)
    if not maybe_initialize(config,
                            'nccl' if device.type == 'cuda' else 'gloo'):
        return device
    atexit.register(_destroy_group)
    device = local_device(device)
    print(f'| torch.distributed: {dist.get_backend()}, rank '
          f'{dist.get_rank()} of {dist.get_world_size()}, {device}',
          flush=True)
    return device


def _destroy_group() -> None:
    """At exit: the group `training_device` brought up, where it is still
    up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_main_process() -> bool:
    """Rank 0 of the default group, or the one process there is."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def wait_for_all() -> None:
    """A barrier of the default group's ranks (on its gloo host group),
    where a group is up: every rank calls it together."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier(group=host_group(dist.group.WORLD))


def process_slice(global_batch_size: int) -> slice:
    """This process's rows of a global batch (JAX `process_slice`):
    contiguous, global_batch_size / world size of them."""
    up = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if up else 1
    idx = dist.get_rank() if up else 0
    per = global_batch_size // n
    if per * n != global_batch_size:
        raise ValueError(f'global batch {global_batch_size} not divisible '
                         f'by {n} processes')
    return slice(idx * per, (idx + 1) * per)


def _is_rows(v) -> bool:
    return isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim > 0


def local_rows(mesh: Optional[Mesh], batch: Dict[str, Any],
               micro: int = 1) -> Dict[str, Any]:
    """This rank's rows of a collated global batch: every array or tensor
    whose leading axis divides by the mesh's data size is sliced (JAX
    `batch_shardings`), the rest (and every other value) is kept whole,
    as JAX replicates it. With `micro` = k > 1 (grad_accum), the rows are
    this rank's shard of each of the k micro-batches in turn, so that
    `accumulate` splitting them in k gives each micro-batch's shard. The
    batch as it is without a mesh or at one rank."""
    if mesh is None or mesh.size == 1:
        return batch
    n, r = mesh.size, mesh.rank
    out = {}
    for k, v in batch.items():
        if not _is_rows(v) or v.shape[0] % (n * micro) != 0:
            out[k] = v
            continue
        per = v.shape[0] // (n * micro)
        if micro == 1:
            out[k] = v[r * per:(r + 1) * per]
            continue
        rows = np.concatenate([np.arange(i * n * per + r * per,
                                         i * n * per + (r + 1) * per)
                               for i in range(micro)])
        out[k] = v[torch.from_numpy(rows) if torch.is_tensor(v) else rows]
    return out


def local_batch(mesh: Mesh, batch: Dict[str, Any],
                micro: int = 1) -> Dict[str, Any]:
    """`local_rows` with every array and tensor moved to the rank's
    device (JAX `host_local_batch_to_global`)."""
    return {k: (torch.as_tensor(v).to(mesh.device, non_blocking=True)
                if isinstance(v, (np.ndarray, torch.Tensor)) else v)
            for k, v in local_rows(mesh, batch, micro).items()}
