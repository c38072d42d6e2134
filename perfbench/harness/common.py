"""What every cell's run shares: the benchmark's file, the caches'
directories, the card check, the guard against JAX in the process, the
statistics, and the result line."""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

BENCH_DIR = Path(__file__).resolve().parent.parent     # perfbench/
ROOT = BENCH_DIR.parent                                 # the checkout
CACHE_DIR = BENCH_DIR / '.cache'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'forwardtacotron_tpu')


def set_cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout, so that only a
    checkout's first run builds (the port's nvcc build already lives in
    forwardtacotron_tpu_torch/build/)."""
    os.environ['TRITON_CACHE_DIR'] = str(CACHE_DIR / 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = str(CACHE_DIR / 'torch_extensions')
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'


def load_benchmark() -> Dict[str, Any]:
    return json.loads((ROOT / 'BENCHMARK.json').read_text())


def read_json(relative: str) -> Dict[str, Any]:
    return json.loads((BENCH_DIR / relative).read_text())


def cell_of(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in bench['workloads']:
        if w['name'] == name:
            return w
    raise SystemExit(f'perfbench: no workload {name!r} in BENCHMARK.json')


def metrics_of(bench: Dict[str, Any], cell: str, kind: str
               ) -> List[Dict[str, Any]]:
    """The `end_to_end` or `per_layer` metrics that `cell` reports: those
    that list it, and those without a list whose moved metric it reports."""
    e2e = [m for m in bench['end_to_end']
           if 'workloads' not in m or cell in m['workloads']]
    if kind == 'end_to_end':
        return e2e
    moved = {m['name'] for m in e2e}
    return [m for m in bench['per_layer']
            if (cell in m['workloads'] if 'workloads' in m
                else m['moves'] in moved)]


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole."""
    tops = {name.split('.', 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def require_cards(n: int) -> None:
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < n:
        sys.stderr.write(f'perfbench: needs {n} CUDA device(s); found '
                         f'{found}\n')
        raise SystemExit(3)


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    order statistics; infinite values (misses) sort last."""
    xs = sorted(values)
    if not xs:
        return math.inf
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def nvidia_smi_line() -> str:
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return 'nvidia-smi not available'


def device_block(count: int, trace: Optional[Dict[str, float]] = None
                 ) -> Dict[str, Any]:
    import torch
    out = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
           'count': count,
           'memory_peak_bytes': int(max(torch.cuda.max_memory_allocated(i)
                                        for i in range(count)))}
    if trace is not None:
        out.update(busy_s=trace['busy_s'], window_s=trace['window_s'])
    return out


def emit(result: Dict[str, Any], check: Dict[str, Dict[str, float]],
         notes: Sequence[str]) -> None:
    """The run's lines: notes and the compared numbers beside their limits
    last on standard error, the result as the last line of standard
    output with the compared numbers under its last key."""
    for line in notes:
        sys.stderr.write(line + '\n')
    for name, row in check.items():
        sys.stderr.write(f'check {name} {row["value"]!r} limit '
                         f'{row["limit"]!r}\n')
    sys.stderr.flush()
    result = dict(result)
    # a compared number that is not finite (a NaN loss) goes out as text
    result['check'] = {
        name: {k: v if not isinstance(v, float) or math.isfinite(v)
               else repr(v) for k, v in row.items()}
        for name, row in check.items()}
    print(json.dumps(result, allow_nan=False), flush=True)
