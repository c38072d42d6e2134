"""The mesh's 'model' axis as sharded storage: the port of the JAX
package's `param_shardings`, `opt_shardings`, `state_shardings` and
`gan_state_shardings` (`parallel/mesh.py:44-142`).

Between steps each rank of a model group holds only its shard of every
parameter that `mesh.param_spec` shards (chunk `model_rank` of n_model
along the spec's dim), and of the optimizer state and the EMA weights of
that parameter; the rest is replicated. A step works on whole weights:

- `gather_weights(module)` (called by `train/common.py:forward_model`
  before a forward) all-gathers the shards over the model group, so the
  kernels see the weights they see at one process;
- after the backward and the data axis's gradient average,
  `ModelShards.shard_grads` keeps each rank's slice of every sharded
  gradient and frees the whole weights, and gives every peer model index
  0's replicated gradients and floating-point buffers (bit-equal peers);
- the global-norm clip takes the one-process norm (`grad_norm`: the
  shards' squares summed over the model group, the replicated ones once),
  and the optimizer and the EMA update the shards.

`whole_state(modules)` gathers the parameters, the optimizer state and the
EMA on every rank for what runs on whole tensors alone (evaluation, plots,
a checkpoint of whole tensors) and slices them back after. The peers of a
model group take the same rows and draw the same masks, so they compute
the same step; JAX's GSPMD splits the arithmetic too, which gives the same
step."""
from __future__ import annotations

import contextlib
import weakref
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

from forwardtacotron_tpu_torch.parallel.mesh import Mesh, param_specs

_SHARDED: 'weakref.WeakKeyDictionary[torch.nn.Module, ModelShards]' = \
    weakref.WeakKeyDictionary()


def _flat_by_dtype(tensors: Sequence[torch.Tensor]) -> Dict[Any, List[int]]:
    by_dtype: Dict[Any, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault((t.dtype, t.device), []).append(i)
    return by_dtype


class ModelShards:
    """The 'model'-axis storage of one module: `sharded` [(name, param,
    dim)], `replicated` [param], its optimizers and EMA, and whether the
    parameters are `whole` now."""

    def __init__(self, module: torch.nn.Module, mesh: Mesh) -> None:
        self.mesh = mesh
        self.n = mesh.shape['model']
        self.k = mesh.model_rank
        specs = param_specs(module, self.n)
        named = list(module.named_parameters())
        self.sharded = [(name, p, specs[name]) for name, p in named
                        if specs[name] is not None]
        self.replicated = [p for name, p in named if specs[name] is None]
        self.buffers = [b for b in module.buffers() if b.is_floating_point()]
        self.optimizers: List[torch.optim.Optimizer] = []
        self.ema = None
        # the parameters, and their optimizer state and EMA, whole now
        self.whole = self.state_whole = True
        self.depth = 0

    def own(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's chunk of a whole tensor, a copy of its own."""
        return t.chunk(self.n, dim)[self.k].clone()

    def gather(self, shards: Sequence[torch.Tensor], dims: Sequence[int]
               ) -> List[torch.Tensor]:
        """The whole tensors of `shards` (each cut along its dim), one
        all-gather over the model group a dtype and device."""
        out: List[Optional[torch.Tensor]] = [None] * len(shards)
        for idx in _flat_by_dtype(shards).values():
            flat = torch.cat([shards[i].reshape(-1) for i in idx])
            parts = [torch.empty_like(flat) for _ in range(self.n)]
            dist.all_gather(parts, flat, group=self.mesh.model_group)
            offset = 0
            for i in idx:
                n = shards[i].numel()
                out[i] = torch.cat([part[offset:offset + n].view_as(shards[i])
                                    for part in parts], dims[i])
                offset += n
        return out

    def _state_entries(self) -> List[tuple]:
        """(holder, key, dim) of every sharded tensor beside the
        parameters: the optimizers' per-parameter moments (the tensors of
        the parameter's rank; not Adam's 0-d `step`) and the EMA weights,
        in an order every peer shares."""
        entries = []
        for opt in self.optimizers:
            for _, p, dim in self.sharded:
                state = opt.state.get(p, {})
                for key in sorted(state):
                    t = state[key]
                    if torch.is_tensor(t) and t.dim() == p.dim() > 0:
                        entries.append((state, key, dim))
        if self.ema is not None:
            for name, _, dim in self.sharded:
                entries.append((self.ema.params, name, dim))
        return entries

    # ------------------------------------------------------------ storage

    def attach(self, optimizers: Iterable[torch.optim.Optimizer] = (),
               ema=None) -> None:
        """Keep these optimizers' state and this EMA of the sharded
        parameters in shards too (from the next `release`)."""
        for opt in optimizers:
            if all(opt is not known for known in self.optimizers):
                self.optimizers.append(opt)
        if ema is not None:
            self.ema = ema

    def gather_params(self) -> None:
        """Whole parameters on every peer (a collective of the model
        group); nothing where they are whole."""
        if self.whole:
            return
        full = self.gather([p.data for _, p, _ in self.sharded],
                           [dim for _, _, dim in self.sharded])
        for (_, p, _), t in zip(self.sharded, full):
            p.data = t
        self.whole = True

    def release(self) -> None:
        """The parameters, optimizer state and EMA as this rank's shards
        (local)."""
        if self.state_whole:
            for holder, key, dim in self._state_entries():
                holder[key] = self.own(holder[key], dim)
            self.state_whole = False
        if self.whole:
            for _, p, dim in self.sharded:
                p.data = self.own(p.data, dim)
            self.whole = False

    def shard_grads(self) -> None:
        """After the backward and the data axis's average: this rank's
        slice of every sharded gradient, its shard of the parameters (the
        whole weights freed), and model index 0's replicated gradients and
        floating-point buffers on every peer."""
        if not self.whole:
            raise RuntimeError('shard_grads: the parameters are not whole; '
                               'the forward did not gather them '
                               '(train/common.py:forward_model)')
        for _, p, dim in self.sharded:
            g, p.grad = p.grad, None
            p.data = self.own(p.data, dim)
            if g is not None:
                p.grad = self.own(g, dim)
        self.whole = False
        common = [p.grad for p in self.replicated if p.grad is not None] \
            + self.buffers
        src = dist.get_global_rank(self.mesh.model_group, 0)
        for idx in _flat_by_dtype(common).values():
            flat = torch.cat([common[i].reshape(-1) for i in idx])
            dist.broadcast(flat, src=src, group=self.mesh.model_group)
            offset = 0
            for i in idx:
                n = common[i].numel()
                common[i].copy_(flat[offset:offset + n].view_as(common[i]))
                offset += n

    def grad_norm(self) -> torch.Tensor:
        """||g|| of the whole gradients: the squares of the shards summed
        over the model group, those of the replicated gradients once."""
        sharded = [p.grad for _, p, _ in self.sharded if p.grad is not None]
        common = [p.grad for p in self.replicated if p.grad is not None]
        device = (sharded + common)[0].device
        sq = torch.zeros((), dtype=torch.float32, device=device)
        for g in sharded:
            sq = sq + g.float().square().sum()
        dist.all_reduce(sq, group=self.mesh.model_group)
        for g in common:
            sq = sq + g.float().square().sum()
        return sq.sqrt()

    def gather_state(self) -> None:
        """Whole parameters, optimizer state and EMA on every peer (one
        collective of the model group where any is sharded); nested calls
        gather nothing."""
        self.depth += 1
        if self.depth > 1:
            return
        params = [] if self.whole else self.sharded
        entries = [] if self.state_whole else self._state_entries()
        full = self.gather([p.data for _, p, _ in params]
                           + [holder[key] for holder, key, _ in entries],
                           [dim for _, _, dim in params]
                           + [dim for _, _, dim in entries])
        for (_, p, _), t in zip(params, full):
            p.data = t
        for (holder, key, _), t in zip(entries, full[len(params):]):
            holder[key] = t
        self.whole = self.state_whole = True

    def release_state(self) -> None:
        """`release` when the outermost `gather_state` ends."""
        self.depth -= 1
        if self.depth == 0:
            self.release()


def shards_of(module: torch.nn.Module) -> Optional[ModelShards]:
    """The 'model'-axis storage of `module`, where it is sharded."""
    return _SHARDED.get(module)


def shard_module(module: torch.nn.Module, mesh: Optional[Mesh],
                 optimizers: Iterable[torch.optim.Optimizer] = (),
                 ema=None) -> Optional[ModelShards]:
    """Keep `module`'s parameters (with their state in `optimizers` and
    `ema`) in shards over `mesh`'s 'model' axis from now on; None, and
    nothing changes, without a 'model' axis. Every peer calls it with
    equal whole tensors."""
    if mesh is None or mesh.shape['model'] == 1:
        return None
    shards = _SHARDED.get(module)
    if shards is None:
        shards = _SHARDED[module] = ModelShards(module, mesh)
    shards.attach(optimizers, ema)
    shards.release()
    return shards


def gather_weights(module: torch.nn.Module) -> None:
    """`module`'s whole parameters before a forward (every peer of its
    model group calls it at the same point); nothing where it is not
    sharded or already whole."""
    shards = _SHARDED.get(module)
    if shards is not None:
        shards.gather_params()


@contextlib.contextmanager
def whole_state(modules: Iterable[torch.nn.Module]) -> Iterator[None]:
    """Within it, the sharded modules' parameters, optimizer state and EMA
    are whole on every rank (all ranks enter it together; nested entries
    gather nothing)."""
    shards = [s for s in (_SHARDED.get(m) for m in modules) if s is not None]
    for s in shards:
        s.gather_state()
    try:
        yield
    finally:
        for s in shards:
            s.release_state()


def unshard(module: torch.nn.Module) -> None:
    """`module`, its optimizer state and EMA whole again for good (every
    peer calls it together)."""
    shards = _SHARDED.pop(module, None)
    if shards is not None:
        shards.gather_state()
