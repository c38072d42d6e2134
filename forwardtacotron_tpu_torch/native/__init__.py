"""Build and load the port's host library: the C++ sources beside this file.

`audio_io.cc` decodes and encodes wavs, resamples linearly and quantizes
(`utils/native_audio.py` binds it); `batch_loader.cc` assembles padded
mel batches and reads the vocoders' windows from .npy files with a pool
of threads (`data/native_loader.py`). Each is compiled by `g++` with
`-O3 -fPIC -std=c++17 -Wall -shared` at first use into
`build/lib<name>-<hash>.so` beside the package (git-ignored), the hash
covering the source and the flags, and loaded with ctypes. Nothing is
built at import time, and nothing falls back: a missing `g++` or a failed
build raises. Processes that build at once each write a file of their own
and rename it into place.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / 'build'
CXX_FLAGS = ['-O3', '-fPIC', '-std=c++17', '-Wall', '-shared']
LINK = {'audio_io': ['-lm'], 'batch_loader': ['-lpthread']}

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def cxx_path() -> str:
    path = shutil.which('g++')
    if path is None:
        raise RuntimeError('g++ not found: the host library is built from '
                           f'{SRC_DIR} at first use and needs a C++ compiler')
    return path


def lib_path(name: str) -> Path:
    digest = hashlib.sha256((SRC_DIR / f'{name}.cc').read_bytes())
    digest.update(' '.join(CXX_FLAGS + LINK[name]).encode())
    return BUILD_DIR / f'lib{name}-{digest.hexdigest()[:16]}.so'


def build(name: str) -> Path:
    """Compile `<name>.cc` unless its library is built; its path."""
    out = lib_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.{threading.get_ident()}.tmp')
    cmd = [cxx_path(), *CXX_FLAGS, '-o', str(tmp), str(SRC_DIR / f'{name}.cc'),
           *LINK[name]]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'g++ failed on {name}.cc:\n{proc.stdout}')
    tmp.replace(out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `<name>.cc`, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
        return lib
