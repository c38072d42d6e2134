"""Host audio I/O and quantizers over the port's C++ library
(`forwardtacotron_tpu_torch/native/audio_io.cc`, built by g++ at first
use).

The same functions and buffer sizing as the JAX package's binding: wavs
are decoded (16/24/32-bit PCM and 32-bit float, any channel count, mixed
to mono in float64) to float32 in [-1, 1] and resampled linearly; written
as 16-bit mono PCM rounded to nearest (`lrintf(v * 32767)` after clipping
to [-1, 1]). A file the reader refuses (8-bit PCM, a broken header)
raises `IOError`.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np

from forwardtacotron_tpu_torch import native

_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = native.load('audio_io')
    c_char_p, c_i32, c_i64 = ctypes.c_char_p, ctypes.c_int32, ctypes.c_int64
    f32_p = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
    i32_p = np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')
    lib.wav_num_frames.argtypes = [c_char_p]
    lib.wav_num_frames.restype = c_i64
    lib.wav_sample_rate.argtypes = [c_char_p]
    lib.wav_sample_rate.restype = c_i32
    lib.wav_read_float.argtypes = [c_char_p, f32_p, c_i64]
    lib.wav_read_float.restype = c_i64
    lib.wav_write_pcm16.argtypes = [c_char_p, f32_p, c_i64, c_i32]
    lib.wav_write_pcm16.restype = ctypes.c_int
    lib.resample_linear.argtypes = [f32_p, c_i64, c_i32, c_i32, f32_p]
    lib.resample_linear.restype = c_i64
    lib.encode_mu_law.argtypes = [f32_p, c_i64, c_i32, i32_p]
    lib.encode_mu_law.restype = None
    lib.float_to_label.argtypes = [f32_p, c_i64, c_i32, i32_p]
    lib.float_to_label.restype = None
    lib.peak_normalize.argtypes = [f32_p, c_i64, ctypes.c_int]
    lib.peak_normalize.restype = ctypes.c_float
    _lib = lib
    return lib


def read_wav(path, target_sr: Optional[int] = None
             ) -> Tuple[np.ndarray, int]:
    """Decode a wav to float32 mono in [-1, 1], resampled to `target_sr`
    when given; (samples, sample rate)."""
    lib = _load()
    path_b = str(path).encode()
    n = lib.wav_num_frames(path_b)
    sr = lib.wav_sample_rate(path_b)
    if n < 0 or sr < 0:
        raise IOError(f'cannot decode wav: {path}')
    out = np.empty(n, dtype=np.float32)
    got = lib.wav_read_float(path_b, out, n)
    if got != n:
        raise IOError(f'short read on wav: {path}')
    if target_sr is not None and target_sr != sr:
        m = int(math.floor(n * target_sr / sr))
        res = np.empty(m + 1, dtype=np.float32)
        m = lib.resample_linear(out, n, sr, target_sr, res)
        out, sr = res[:m].copy(), target_sr
    return out, sr


def write_wav(path, data: np.ndarray, sample_rate: int) -> None:
    """Write float audio as 16-bit mono PCM."""
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.float32)
    rc = lib.wav_write_pcm16(str(path).encode(), data, len(data),
                             sample_rate)
    if rc != 0:
        raise IOError(f'cannot write wav: {path}')


def encode_mu_law(x: np.ndarray, mu: int) -> np.ndarray:
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(len(x), dtype=np.int32)
    lib.encode_mu_law(x, len(x), mu, out)
    return out


def float_to_label(x: np.ndarray, bits: int) -> np.ndarray:
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(len(x), dtype=np.int32)
    lib.float_to_label(x, len(x), bits, out)
    return out


def peak_normalize(x: np.ndarray, always: bool = False) -> float:
    """Divide x by its peak in place (a float32 C-contiguous array; other
    input is normalised in a copy) when the peak exceeds 1 or `always`;
    returns the peak."""
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float32)
    return float(lib.peak_normalize(x, len(x), int(always)))
