"""Profiling and tracing: `torch.profiler` traces, step timing and device
memory (the JAX package's `utils/profiling.py`).

`trace()` records a code region with `torch.profiler` (the host's ops, and
the card's kernels where CUDA is available) and writes a Chrome trace,
which Perfetto and TensorBoard's profiler plugin open; `annotate()` names
a span inside it; `StepTimer` keeps per-step wall times with percentiles;
`StepTraceController` traces a window of training steps when
`FTT_PROFILE_DIR` is set; `device_memory_stats` reads the CUDA caching
allocator; `kernel_launches` counts the port's kernels in a trace (where
the wrappers' Python counters do not tick: the replay of a captured CUDA
graph).
"""
from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch


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


def annotate(name: str):
    """A named span in the trace (`torch.profiler.record_function`)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock step statistics (mean / p50 / p95 / steps per second)
    over the last `window` steps; the caller synchronises the device
    inside the `with` where it wants device time counted."""

    def __init__(self, window: int = 500) -> None:
        self.window = window
        self.times: List[float] = []
        self._start: Optional[float] = None

    def __enter__(self) -> 'StepTimer':
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.times.append(time.perf_counter() - self._start)
        if len(self.times) > self.window:
            self.times = self.times[-self.window:]

    def stats(self) -> Dict[str, float]:
        if not self.times:
            return {}
        t = np.asarray(self.times)
        return {'mean_s': float(t.mean()),
                'p50_s': float(np.percentile(t, 50)),
                'p95_s': float(np.percentile(t, 95)),
                'steps_per_sec': float(1.0 / max(t.mean(), 1e-9))}


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


def device_memory_stats(device=None) -> Dict[str, int]:
    """Bytes in use, their peak and the card's total, from the CUDA
    caching allocator; {} without CUDA."""
    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    return {'bytes_in_use': int(stats.get('allocated_bytes.all.current', 0)),
            'peak_bytes_in_use': int(stats.get('allocated_bytes.all.peak',
                                               0)),
            'bytes_limit': int(torch.cuda.get_device_properties(
                device or torch.cuda.current_device()).total_memory)}


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
