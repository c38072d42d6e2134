"""Kernels #1 and #4 as PyTorch custom ops.

- `ftt::birnn_recurrence`: the inference BiRNN recurrence
  (`kernels/birnn.py`, csrc/birnn.cu);
- `ftt::wavernn_sample`: the WaveRNN sampler (`kernels/wavernn_sample.py`,
  csrc/wavernn_sample.cu), its seed an int64 scalar tensor.

Each op has a CUDA implementation, the kernel's ctypes launcher (which
counts its launches), and a CPU implementation, the kernel's plain
version; no other device is taken. The fake implementations give the
output shapes, so `torch.export` records the ops in its graph (a ctypes
launch cannot be traced: a fake tensor has no `data_ptr()`). An exported
program then runs the kernels on the card and the plain versions on the
CPU. The wrappers (`birnn.recurrence`, `wavernn_sample.sample`) call the
launchers directly on plain CUDA tensors, eager or under CUDA graph
capture, where the dispatcher would only add host time (30-55 µs a call
of #1 on an H100 host, `tools/torch_kernel_probe.py --only dispatch`);
the ops serve fake tensors (export), exported programs and the CPU.
Importing this module (done
by importing `forwardtacotron_tpu_torch.kernels`) registers the ops; it
builds nothing.

Kernels #2/#3 (training) stay `torch.autograd.Function`s
(`ops/rnn.py:BiRNNTrain`).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from forwardtacotron_tpu_torch.kernels import birnn as _birnn
from forwardtacotron_tpu_torch.kernels import wavernn_sample as _ws
from forwardtacotron_tpu_torch.ops.rnn import birnn_recurrence as _plain


@torch.library.custom_op('ftt::birnn_recurrence', mutates_args=(),
                         device_types='cpu')
def birnn_recurrence(cell: str, gi: torch.Tensor, w_hh: torch.Tensor,
                     b_hh: torch.Tensor, lengths: torch.Tensor,
                     compute_dtype: torch.dtype, path: Optional[str] = None,
                     cluster: Optional[int] = None) -> torch.Tensor:
    """y (T, B, S, H) float32 of the BiRNN recurrence
    (`ops/rnn.py:birnn_recurrence`); on the CPU the plain version, which
    has one path (`path` and `cluster` are the kernel's)."""
    return _plain(cell, gi, w_hh, b_hh, lengths, compute_dtype)


@birnn_recurrence.register_kernel('cuda')
def _birnn_cuda(cell, gi, w_hh, b_hh, lengths, compute_dtype, path=None,
                cluster=None):
    return _birnn.launch(cell, gi, w_hh, b_hh, lengths, compute_dtype, path,
                         cluster)


@birnn_recurrence.register_fake
def _birnn_fake(cell, gi, w_hh, b_hh, lengths, compute_dtype, path=None,
                cluster=None):
    T, B, S, _ = gi.shape
    return gi.new_empty((T, B, S, w_hh.shape[-1]), dtype=torch.float32)


@torch.library.custom_op('ftt::wavernn_sample', mutates_args=(),
                         device_types='cpu')
def wavernn_sample(cond: torch.Tensor, weights: List[torch.Tensor],
                   seed: torch.Tensor, nr_mix: int, greedy: bool,
                   compute_dtype: torch.dtype) -> torch.Tensor:
    """Samples (T, L) float32 of the WaveRNN sampler
    (`kernels/wavernn_sample.py:sample_plain`) over cond (T, L, C), the
    packed weights in `WEIGHT_KEYS` order and an int64 scalar seed; on the
    CPU the plain version."""
    w = dict(zip(_ws.WEIGHT_KEYS, weights))
    return _ws.sample_plain(cond, w, int(seed), nr_mix, greedy,
                            compute_dtype)


@wavernn_sample.register_kernel('cuda')
def _wavernn_cuda(cond, weights, seed, nr_mix, greedy, compute_dtype):
    return _ws.launch(cond, dict(zip(_ws.WEIGHT_KEYS, weights)), seed,
                      nr_mix, greedy, compute_dtype)


@wavernn_sample.register_fake
def _wavernn_fake(cond, weights, seed, nr_mix, greedy, compute_dtype):
    return cond.new_empty(cond.shape[:2], dtype=torch.float32)
