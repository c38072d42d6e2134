"""What a traced slice of the window shows of the device, from
`torch.profiler` (CUPTI): the busy time as the union of the kernel
intervals (a copy of chip_smoke.py's `profiled`: kernels that overlap,
as on cuDNN's side streams, count once), device time by kernel name, the
operations that took most time, and the longest idle gaps by what the
host was doing meanwhile."""
from __future__ import annotations

import bisect
import math
import time
from collections import defaultdict
from typing import Any, Dict, List, Tuple

HARNESS_PREFIX = 'perfbench.'


class Slice:
    """A profiled stretch of a run: `start()` and `stop()` bracket it,
    each after a synchronise of the card. With `host_ops` the host's
    operations are recorded too, which slows a host-bound loop: a slice
    for the busy time records the card's activity (and the runtime calls)
    alone."""

    def __init__(self, host_ops: bool = False) -> None:
        self.prof = None
        self.host_ops = host_ops
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        acts = [ProfilerActivity.CUDA]
        if self.host_ops:
            acts.append(ProfilerActivity.CPU)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def summary(self) -> Dict[str, Any]:
        return summarize(self.prof, self.t1 - self.t0)


def _device_events(prof) -> List[Any]:
    """The kernels and copies on the card; the ranges that record_function
    mirrors onto the card's timeline (user annotations) are not work."""
    return [e for e in prof.events()
            if str(e.device_type).endswith('CUDA')
            and not getattr(e, 'is_user_annotation', False)
            and not e.name.startswith(HARNESS_PREFIX)]


def summarize(prof, wall_s: float) -> Dict[str, Any]:
    events = _device_events(prof)
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    merged: List[Tuple[float, float]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    busy_us = sum(b - a for a, b in merged)
    by_name: Dict[str, float] = defaultdict(float)
    for e in events:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {'busy_s': busy_us / 1e6, 'window_s': wall_s,
            'kernel_s': dict(by_name),
            'device_ops': [[name[:120], s] for name, s in top],
            'idle_gaps': _idle_gaps(prof, merged)}


def _host_label(mid: float, ours, ops, starts) -> str:
    """What the host was doing at time `mid`: the innermost of its
    operations then running (among the last hundred begun), else the
    innermost of the harness's ranges, else nothing recorded."""
    best, label = math.inf, None
    end = bisect.bisect_right(starts, mid)
    for e in ops[max(0, end - 100):end]:
        length = e.time_range.end - e.time_range.start
        if e.time_range.end >= mid and length < best:
            best, label = length, e.name
    if label is not None:
        return label
    for e in ours:
        length = e.time_range.end - e.time_range.start
        if e.time_range.start <= mid <= e.time_range.end and length < best:
            best, label = length, e.name
    return label or 'no host operation'


def _idle_gaps(prof, merged: List[Tuple[float, float]],
               longest: int = 2000) -> List[list]:
    """The `longest` idle stretches between the merged kernel intervals,
    summed by what the host was doing at each one's midpoint
    (`_host_label`)."""
    gaps = sorted(((b0 - a1, a1, b0) for (_, a1), (b0, _)
                   in zip(merged, merged[1:]) if b0 > a1), reverse=True)
    if not gaps:
        return []
    host = sorted((e for e in prof.events()
                   if not str(e.device_type).endswith('CUDA')
                   and e.time_range.end > e.time_range.start),
                  key=lambda e: e.time_range.start)
    ours = [e for e in host if e.name.startswith(HARNESS_PREFIX)]
    ops = [e for e in host if not e.name.startswith(HARNESS_PREFIX)]
    starts = [e.time_range.start for e in ops]
    totals: Dict[str, float] = defaultdict(float)
    for _, a1, b0 in gaps[:longest]:
        mid = (a1 + b0) / 2
        totals[_host_label(mid, ours, ops, starts)] += (b0 - a1) / 1e6
    return [[name[:120], s] for name, s in
            sorted(totals.items(), key=lambda kv: -kv[1])[:10]]


def kernel_seconds(summary: Dict[str, Any], needles) -> float:
    """Device seconds of the kernels whose names contain any of
    `needles`."""
    return sum(s for name, s in summary['kernel_s'].items()
               if any(n in name for n in needles))
