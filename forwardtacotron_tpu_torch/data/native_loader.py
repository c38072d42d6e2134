"""Batch assembly over the port's C++ loader
(`forwardtacotron_tpu_torch/native/batch_loader.cc`, built by g++ at first
use).

A pool of threads maps the float32 (n_mels, T) .npy mels of a batch and
writes them transposed and padded into one (B, max_t, n_mels) array, and
reads only the windows the vocoders' collator draws: one pass where numpy
loads, pads, stacks, transposes and casts. Each function returns `None`
when any file fails validation (missing, truncated, another dtype,
Fortran order, a shape that does not fit), and the caller assembles that
batch with numpy instead, as the JAX package's binding does.
"""
from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from forwardtacotron_tpu_torch import native

_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = native.load('batch_loader')
    f32_arr = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
    i64_arr = np.ctypeslib.ndpointer(np.int64, flags='C_CONTIGUOUS')
    paths_t = ctypes.POINTER(ctypes.c_char_p)
    lib.ftt_load_mel_batch.argtypes = [
        paths_t, ctypes.c_int32, f32_arr, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float,
        np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS'),
        ctypes.c_int32]
    lib.ftt_load_mel_batch.restype = ctypes.c_int
    lib.ftt_npy_lengths.argtypes = [paths_t, ctypes.c_int32, ctypes.c_char_p,
                                    i64_arr, ctypes.c_int32]
    lib.ftt_npy_lengths.restype = ctypes.c_int
    lib.ftt_load_mel_windows.argtypes = [
        paths_t, ctypes.c_int32, i64_arr, ctypes.c_int64, ctypes.c_int64,
        f32_arr, ctypes.c_int32]
    lib.ftt_load_mel_windows.restype = ctypes.c_int
    lib.ftt_load_i64_windows.argtypes = [
        paths_t, ctypes.c_int32, i64_arr, ctypes.c_int64, i64_arr,
        ctypes.c_int32]
    lib.ftt_load_i64_windows.restype = ctypes.c_int
    _lib = lib
    return lib


def _n_threads(n_items: int) -> int:
    env = os.environ.get('FTT_LOADER_THREADS')
    if env:
        return max(1, int(env))
    return max(1, min(8, os.cpu_count() or 1, n_items))


def _encode(paths: Sequence[Path]) -> 'ctypes.Array':
    encoded = [str(p).encode() for p in paths]
    return (ctypes.c_char_p * len(paths))(*encoded)


def load_mel_batch(paths: Sequence[Path], max_t: int, n_mels: int,
                   fill: float) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(n_mels, T) float32 .npy files as one (B, max_t, n_mels) float32
    array padded with `fill`, and their int64 lengths T."""
    lib = _load()
    n = len(paths)
    out = np.empty((n, max_t, n_mels), dtype=np.float32)
    lens = np.empty(n, dtype=np.int32)
    rc = lib.ftt_load_mel_batch(_encode(paths), n, out, max_t, n_mels,
                                ctypes.c_float(fill), lens, _n_threads(n))
    if rc != 0:
        return None
    return out, lens.astype(np.int64)


def npy_lengths(paths: Sequence[Path],
                descr: str = '<f4') -> Optional[np.ndarray]:
    """The last dimension of each .npy from its header (a float32 2-D
    file's T, an int64 1-D file's n, as `descr` says)."""
    lib = _load()
    out = np.empty(len(paths), dtype=np.int64)
    rc = lib.ftt_npy_lengths(_encode(paths), len(paths), descr.encode(),
                             out, _n_threads(len(paths)))
    return None if rc != 0 else out


def load_mel_windows(paths: Sequence[Path], starts: Sequence[int],
                     win: int, n_mels: int) -> Optional[np.ndarray]:
    """Column windows [start, start + win) of (n_mels, T) float32 .npy
    files, time-major (B, win, n_mels); reads only the windows."""
    lib = _load()
    n = len(paths)
    out = np.empty((n, win, n_mels), dtype=np.float32)
    starts_arr = np.ascontiguousarray(starts, dtype=np.int64)
    rc = lib.ftt_load_mel_windows(_encode(paths), n, starts_arr, win,
                                  n_mels, out, _n_threads(n))
    return None if rc != 0 else out


def load_i64_windows(paths: Sequence[Path], starts: Sequence[int],
                     count: int) -> Optional[np.ndarray]:
    """Element windows [start, start + count) of 1-D int64 .npy files
    (the quantized waveform labels) as a (B, count) array."""
    lib = _load()
    n = len(paths)
    out = np.empty((n, count), dtype=np.int64)
    starts_arr = np.ascontiguousarray(starts, dtype=np.int64)
    rc = lib.ftt_load_i64_windows(_encode(paths), n, starts_arr, count,
                                  out, _n_threads(n))
    return None if rc != 0 else out
