"""Checkpoint writes off the training step loop.

Mirrors the JAX package's `utils/async_ckpt.py:AsyncCheckpointWriter`. A
save is split in two:

1. an on-device snapshot of the payload: every tensor cloned on the
   current stream, so the copies are queued before the next
   `optimizer.step()` updates the parameters and Adam's moments in place
   (in torch the hazard is in-place mutation, where in JAX it was buffer
   donation), and a CUDA event recorded after them;
2. on one writer thread: wait for the event, copy to the host,
   `torch.save` to a temporary file and rename it (`save_payload`), then
   run `on_complete`.

At most one save is in flight: `save` snapshots, then waits for the
previous save, so files appear in the order they were asked for and
`latest_model.pt` is always the newest. `wait()` drains it and re-raises
a failure of the background save; the trainers call it at the end of a
session and on the preemption path, so no checkpoint is lost to the
process's exit.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Union

import torch

from forwardtacotron_tpu_torch.utils.checkpoints import save_payload


def map_tensors(tree, fn):
    """`tree` (dicts, lists, tuples, tensors and other values) with every
    tensor t replaced by fn(t)."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(v, fn) for v in tree)
    return tree


class AsyncCheckpointWriter:
    """Background checkpoint writer: one thread, one save in flight."""

    def __init__(self) -> None:
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix='ckpt-writer')
        self._inflight: Optional[Future] = None
        self._lock = threading.Lock()

    def save(self, payload: Dict[str, Any], path: Union[str, Path],
             on_complete: Optional[Callable[[], None]] = None) -> Future:
        """Snapshot `payload` (a tree of dicts, lists and tensors) and
        hand it to the writer thread, which writes it to `path` as
        `save_payload` does; blocks only while a previous save is still
        running. `on_complete` (no arguments) runs on the writer thread
        after the rename, and not at all if the save fails (the failure
        surfaces at the next `wait()` or `save()`)."""
        devices = set()

        def snap(t):
            if t.is_cuda:
                devices.add(t.device)
            return t.detach().clone()
        snapshot = map_tensors(payload, snap)
        events = []
        for dev in devices:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            events.append(event)
        self.wait()

        def job():
            for event in events:
                event.synchronize()
            save_payload(map_tensors(snapshot, lambda t: t.cpu()), path)
            if on_complete is not None:
                on_complete()

        with self._lock:
            self._inflight = self._pool.submit(job)
            return self._inflight

    def wait(self) -> None:
        """Drain the save in flight; re-raise its exception if it
        failed."""
        with self._lock:
            fut, self._inflight = self._inflight, None
        if fut is not None:
            fut.result()

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)
