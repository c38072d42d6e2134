"""Profiling and tracing: the port's spans, `torch.profiler` traces and
the port's kernels counted in a trace (the JAX package's
`utils/profiling.py`).

`annotate(name, **attrs)` is the port's span. Tracing is on exactly while
a `torch.profiler` is recording (`StepTraceController`'s window, `trace()`,
any caller's profile): then a span opens a `record_function` of its name,
which puts it on the profiler's timeline beside the card's kernels, and on
exit appends a `Span` to a bounded in-memory store that `spans()` reads.
Off, `annotate` reads the profiler's flag and returns a shared do-nothing
context: no `record_function`, no record. Every name begins with `ftt.`:

    ftt.data.next         the consumer's wait for `Prefetcher`'s next batch
    ftt.data.to_device    `batch_to_device`'s host-to-device copies
    ftt.train.step        `train_step`'s whole body, and the GAN
                          vocoders' `gan_train_step` (with `B` and
                          `seg_len`); defines `Span.step`; its `path`
                          says how the step ran: `replay` (a CUDA graph of
                          the step, or one of each GAN half), `capture` (a
                          new batch shape: warm-up, capture, replay) or
                          `eager`
    ftt.train.forward     each `micro_loss` of `accumulate` (forward, loss)
    ftt.train.backward    each `loss.backward()` of `accumulate`, and each
                          half's `backward()` of the GAN step
    ftt.train.update      `apply_update`: reduce, shard, clip, step, EMA
    ftt.gan.disc_update   the GAN step's first half, `disc_step` or its
                          graph's replay: the discriminators' update on a
                          detached generation
    ftt.gan.gen_update    its second half, `gen_step` or its graph's
                          replay: the generator's update against the
                          updated discriminators
    ftt.gan.generator     the generator's forward in either half
    ftt.gan.discriminators
                          the MPD and MSD forward over real and generated
                          audio in either half
    ftt.gan.mel           the mel loss (both log-mels, the L1)
    ftt.kernels.birnn_train_fwd / _bwd
                          one launch of kernel #2 / #3, with its `path`,
                          `cell`, `dtype`, `T`, `B`, `S`, `H` and `lengths`
                          (the launch's device tensor, never copied);
                          a replay of a step graph records one for each
                          launch the graph holds (`replayed`), with the
                          attributes of its capture and a copy of this
                          step's `lengths`

A replay does no host work for the forward, the backward or the update,
so it records none of their spans (nor, in the GAN step, the generator's,
the discriminators' or the mel loss's).

A span's `step` is the number of `ftt.train.step` spans recorded before it
began, so the spans of one step share it on any thread (spans outside a
step span, as the teacher's, WaveRNN's and the aligner's `accumulate`
and `apply_update`, carry the count of the last step); its `parent` is
the `id` of the innermost span open on its own thread, so the GAN step's
spans nest as step > disc_update, gen_update > generator,
discriminators, mel, backward, update (autograd's own thread opens none
of them). The store is never cleared: a kernel span's `lengths` keeps its
device tensor alive until 8192 later spans push the record out. `trace()`
records a region with `torch.profiler` (the host's ops, and the card's
kernels where CUDA is available) and writes a Chrome trace, which
Perfetto and TensorBoard's profiler plugin open; `StepTraceController`
traces a window of training steps when `FTT_PROFILE_DIR` is set;
`kernel_launches` counts the port's kernels in a trace (where the
wrappers' Python counters do not tick: the replay of a captured CUDA
graph).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

STEP_SPAN = 'ftt.train.step'
LAUNCH_SPANS = ('ftt.kernels.birnn_train_fwd', 'ftt.kernels.birnn_train_bwd')
STORE_SPANS = 8192


class Span(NamedTuple):
    """One closed span: times from `time.perf_counter_ns()`."""
    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: Optional[int]
    step: int
    attrs: Dict[str, Any]


_store: 'collections.deque[Span]' = collections.deque(maxlen=STORE_SPANS)
_lock = threading.Lock()
_open = threading.local()        # .stack: this thread's open spans
_ids = itertools.count()
_steps = 0                       # ftt.train.step spans recorded
_OFF = contextlib.nullcontext()
# while a step graph is captured: the (name, attrs) of each launch span
_captured: Optional[List[tuple]] = None


class _Span:
    """An open span: a `record_function` of its name, then a `Span`."""

    __slots__ = ('name', 'attrs', 'record', 'id', 'parent', 'step',
                 'start')

    def __init__(self, name: str, attrs: Dict[str, Any]) -> None:
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> '_Span':
        self.record = torch.profiler.record_function(self.name)
        self.record.__enter__()
        stack = getattr(_open, 'stack', None)
        if stack is None:
            stack = _open.stack = []
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self.step = _steps
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        global _steps
        end = time.perf_counter_ns()
        _open.stack.pop()
        self.record.__exit__(*exc)
        span = Span(self.name, self.start, end, threading.get_ident(),
                    self.id, self.parent, self.step, self.attrs)
        with _lock:
            _store.append(span)
            if self.name == STEP_SPAN:
                _steps += 1


def annotate(name: str, **attrs):
    """The port's span named `name` (a `with` context) while a profiler
    records, else a shared context that does nothing. Inside
    `captured_launches`, a launch span's name and attributes are also
    listed, profiler or not."""
    if _captured is not None and name in LAUNCH_SPANS:
        _captured.append((name, attrs))
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs)


@contextlib.contextmanager
def captured_launches():
    """Within it (the capture of a CUDA graph), yields the list to which
    every `LAUNCH_SPANS` span opened appends (name, attrs): the launches
    the graph holds, for `replayed` at each replay."""
    global _captured
    before, _captured = _captured, []
    try:
        yield _captured
    finally:
        _captured = before


def replayed(launches: List[tuple], start_ns: int, end_ns: int) -> None:
    """While a profiler records, store a span for each launch of
    `launches` (as `captured_launches` listed them) that a graph's replay
    ran between `start_ns` and `end_ns`: a child of the innermost span open
    on this thread, in its step, with the attributes of its capture and a
    copy of `lengths` as the replay left it."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    stack = getattr(_open, 'stack', None)
    parent = stack[-1].id if stack else None
    thread = threading.get_ident()
    with _lock:
        for name, attrs in launches:
            _store.append(Span(name, start_ns, end_ns, thread, next(_ids),
                               parent, _steps,
                               dict(attrs, lengths=attrs['lengths'].clone())))


def spans() -> List[Span]:
    """The stored spans, oldest first (the last `STORE_SPANS`)."""
    with _lock:
        return list(_store)


def _profiler() -> torch.profiler.profile:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def _export(prof: torch.profiler.profile, log_dir) -> Path:
    """Write the Chrome trace of `prof` into `log_dir` as
    `<host>_<pid>.<ms>.pt.trace.json` (the name TensorBoard's plugin
    lists)."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    path = log_dir / (f'{os.uname().nodename}_{os.getpid()}.'
                      f'{time.time_ns() // 1_000_000}.pt.trace.json')
    prof.export_chrome_trace(str(path))
    return path


@contextlib.contextmanager
def trace(log_dir):
    """Profile the region and write its Chrome trace into `log_dir`;
    yields the `torch.profiler.profile` (its `key_averages()` too)."""
    prof = _profiler()
    with prof:
        yield prof
    _export(prof, log_dir)


class StepTraceController:
    """Environment-controlled tracing of a training loop, ticked by every
    trainer:

    FTT_PROFILE_DIR=<dir>    enable; the Chrome trace is written there
    FTT_PROFILE_START=<n>    first step to capture (default 20, past the
                             kernels' build and the allocator's warm-up)
    FTT_PROFILE_STEPS=<n>    how many steps to capture (default 10)

    `tick(step)` once a step starts the profiler at START and stops it
    STEPS later, writing the trace; `close()` writes a trace still open
    when the loop ends early. Without FTT_PROFILE_DIR both do nothing."""

    def __init__(self) -> None:
        self.dir = os.environ.get('FTT_PROFILE_DIR')
        self.start = int(os.environ.get('FTT_PROFILE_START', 20))
        self.steps = int(os.environ.get('FTT_PROFILE_STEPS', 10))
        self.path: Optional[Path] = None
        self._prof: Optional[torch.profiler.profile] = None
        self._stop_at = 0
        self._done = False

    def tick(self, step: int) -> None:
        if self.dir is None or self._done:
            return
        if self._prof is None and step >= self.start:
            self._prof = _profiler()
            self._prof.__enter__()
            self._stop_at = step + self.steps
        elif self._prof is not None and step >= self._stop_at:
            self.close()
            print(f'\n[profiler] trace for steps {self.start}..'
                  f'{self._stop_at} written to {self.path}')

    def close(self) -> None:
        if self._prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
            self.path = _export(self._prof, self.dir)
            self._prof = None
            self._done = True


# kernel name (as the profiler reports the CUDA symbol) -> launch count key,
# the keys of the wrappers' counters by path: #1 (`kernels/birnn.py`), #2
# and #3 (`kernels/birnn_train.py`), #4 (`kernels/wavernn_sample.py`)
KERNEL_NAMES = {'birnn_sl_kernel<': 'birnn_stream_local',
                'birnn_kernel<': 'birnn_cooperative',
                'train_fwd_kernel<': 'birnn_train_fwd_cooperative',
                'train_fwd_bs_kernel<': 'birnn_train_fwd_batch_split',
                'train_fwd_cl_kernel<': 'birnn_train_fwd_cluster',
                'train_bwd_kernel<': 'birnn_train_bwd_cooperative',
                'train_bwd_bs_kernel<': 'birnn_train_bwd_batch_split',
                'wavernn_kernel<': 'wavernn_sample'}


def kernel_launches(prof: torch.profiler.profile) -> Dict[str, int]:
    """Launches of every kernel of the port (#1-#3 by path, #4) that
    `prof` recorded on the card, counted by kernel name."""
    counts = dict.fromkeys(KERNEL_NAMES.values(), 0)
    for e in prof.events():
        if not str(e.device_type).endswith('CUDA'):
            continue
        for name, key in KERNEL_NAMES.items():
            if name in e.name:
                counts[key] += 1
    return counts
