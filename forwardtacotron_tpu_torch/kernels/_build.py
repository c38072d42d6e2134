"""Build and load the CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
for `sm_90a` into `build/lib<name>-<hash>.so` beside the package (the
directory is git-ignored), then loaded with ctypes. The hash covers the
source, every other source and header under `csrc/` (a source may
include another) and the flags, so an edited source or header is rebuilt
and an unchanged one is loaded as it is. Nothing here runs at import
time, and nothing falls back: a missing `nvcc` or a failed build raises.

Setting `PROBE = True` selects the probe build (`-DFTT_PROBE`, a library
of its own): its kernels time their phases on the card
(`csrc/probe.cuh`), and `probe_read` returns what they measured.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / 'csrc'
BUILD_DIR = PKG_DIR / 'build'
NVCC_FLAGS = ['-gencode=arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v']

PROBE = False          # build and load the per-phase timing variant
PROBE_PHASES = 8       # csrc/probe.cuh kProbePhases

_LOADED: Dict[tuple, ctypes.CDLL] = {}


def nvcc_path() -> str:
    candidates = [shutil.which('nvcc')]
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root:
            candidates.append(str(Path(root) / 'bin' / 'nvcc'))
    for c in candidates:
        if c and Path(c).exists():
            return c
    raise RuntimeError('nvcc not found: the CUDA kernels are built from '
                       'csrc/ at first use and need the CUDA toolkit')


def _flags() -> list:
    return NVCC_FLAGS + (['-DFTT_PROBE'] if PROBE else [])


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f'{name}.cu').read_bytes())
    # every other file a source may include: the headers, and the sources
    # (csrc/birnn_train_staged.cu and birnn_train_tf32.cu include
    # csrc/birnn_train.cu)
    for other in sorted(p for p in CSRC.iterdir()
                        if p.suffix in ('.cu', '.cuh', '.h')
                        and p.name != f'{name}.cu'):
        digest.update(other.name.encode() + other.read_bytes())
    digest.update(' '.join(_flags()).encode())
    return BUILD_DIR / f'lib{name}-{digest.hexdigest()[:16]}.so'


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that is not built yet, all `nvcc`
    processes at once. Returns {name: ptxas report} of what was built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [nvcc_path(), *_flags(), '-o', str(tmp),
               str(CSRC / f'{name}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    reports = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'--- {name} ---\n{log}')
            continue
        tmp.replace(out)
        reports[name] = log
    if failed:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _LOADED.get((name, PROBE))
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.ftt_error_string.argtypes = [ctypes.c_int]
        lib.ftt_error_string.restype = ctypes.c_char_p
        _LOADED[(name, PROBE)] = lib
    return lib


def probe_read(name: str) -> Dict[str, float]:
    """Phase times of the probe build of csrc/<name>.cu summed over its
    launches since the last read, and reset: {'phase<i>': ns, ...,
    'run_ns': ns} from thread 0 of block 0 (SM cycles scaled to ns by the
    run's own %globaltimer span)."""
    lib = load(name)
    out = (ctypes.c_ulonglong * (PROBE_PHASES + 2))()
    lib.ftt_probe_read.argtypes = [ctypes.c_void_p]
    lib.ftt_probe_read.restype = ctypes.c_int
    check(lib, lib.ftt_probe_read(out), 'probe read')
    ns, cycles = out[PROBE_PHASES], out[PROBE_PHASES + 1]
    scale = ns / cycles if cycles else 0.0
    res = {f'phase{i}': out[i] * scale for i in range(PROBE_PHASES)}
    res['run_ns'] = float(ns)
    return res


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.ftt_error_string(code).decode()
        raise RuntimeError(f'{what} failed: CUDA error {code} ({msg})')
