"""Training machinery of the forward model: loss, optimizer, one step.

Mirrors the JAX package's `train/common.py`: the masked-L1 loss with
0.1-weighted duration/pitch/energy terms, pitch/energy zoneout, global-
norm clipping with optax's formula, then Adam with torch's (= optax's)
defaults, the schedule sessions' helpers (the vocoders' `VocSession`
too), the top-k checkpoint tracker every trainer keeps, and graceful
preemption. A step runs eagerly: forward, `loss.backward()`, clip,
`optimizer.step()`.
"""
from __future__ import annotations

import os
import signal
import threading
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Tuple, Union

import torch

from forwardtacotron_tpu_torch.ops.masking import masked_l1
from forwardtacotron_tpu_torch.utils.files import (pickle_binary,
                                                   unpickle_binary)

# options of the JAX trainer that the port does not run yet
NOT_PORTED = {
    'precision': lambda v: str(v).lower() not in ('f32', 'float32', 'fp32'),
    'ema_decay': lambda v: float(v or 0) > 0,
    'grad_accum': lambda v: int(v or 1) > 1,
    'remat': bool,
}


def check_supported(train_cfg: Dict[str, Any]) -> None:
    """Reject the training options the port has not ported yet."""
    for key, is_on in NOT_PORTED.items():
        if key in train_cfg and is_on(train_cfg[key]):
            raise ValueError(f'training.{key}={train_cfg[key]!r} is not '
                             'ported yet')


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
    JAX package's `train/common.py:TopKTracker`, synchronous). A score
    that makes the top k is saved, the files pushed out are deleted, and
    the index is written after the file, listing only files on disk. A
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
               save: Callable[[Path], None]) -> bool:
        """Offer the checkpoint of `step`; `save(path)` writes it where it
        makes the top k. Returns whether it was kept."""
        if self.k <= 0:
            return False
        if len(self.entries) >= self.k \
                and score >= max(e[0] for e in self.entries):
            return False
        name = f'{self.prefix}_step{step}_score{score:.5f}.pt'
        save(self.directory / name)
        ranked = sorted([e for e in self.entries if e[2] != name]
                        + [(float(score), int(step), name)],
                        key=lambda e: e[0])
        for _, _, old in ranked[self.k:]:
            try:
                os.remove(self.directory / old)
            except FileNotFoundError:
                pass
        self.entries = [e for e in ranked[:self.k]
                        if (self.directory / e[2]).exists()]
        pickle_binary(self.entries, self.index_path)
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
    for group in optimizer.param_groups:
        group['lr'] = lr


def clip_by_global_norm(params: Iterable[torch.Tensor],
                        max_norm: float) -> torch.Tensor:
    """Scale the gradients in place by min(1, max_norm / ||g||), ||g|| the
    norm of all of them together: optax's `clip_by_global_norm`.
    `torch.nn.utils.clip_grad_norm_` divides by ||g|| + 1e-6 instead.
    Returns ||g|| before clipping; no host synchronisation."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def forward_loss(pred: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                 pitch_target: torch.Tensor, energy_target: torch.Tensor,
                 train_cfg: Dict[str, Any]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """ForwardTacotron loss (the reference's forward_trainer.py:86-96)."""
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


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor], generator: torch.Generator,
               train_cfg: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """One optimization step in train mode: teacher-forced forward on the
    zoned-out batch, loss against the true targets, backward, global-norm
    clip, Adam. The clipped gradients stay in `.grad`. Returns the step's
    metrics (device tensors, including the norm before clipping)."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    pred = model(_zoneout(batch, generator, train_cfg))
    loss, metrics = forward_loss(pred, batch, batch['pitch'],
                                 batch['energy'], train_cfg)
    loss.backward()
    clip = train_cfg.get('clip_grad_norm')
    if clip is not None:
        metrics['grad_norm'] = clip_by_global_norm(model.parameters(),
                                                   float(clip))
    optimizer.step()
    return metrics


@torch.no_grad()
def eval_step(model: torch.nn.Module, batch: Dict[str, torch.Tensor],
              train_cfg: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Loss metrics of the teacher-forced forward in eval mode (running
    BN statistics, no dropout); the model's mode is restored."""
    was_training = model.training
    model.eval()
    try:
        pred = model(batch)
    finally:
        model.train(was_training)
    return forward_loss(pred, batch, batch['pitch'], batch['energy'],
                        train_cfg)[1]
