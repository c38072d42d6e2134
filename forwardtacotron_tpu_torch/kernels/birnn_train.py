"""Training recurrences of the BiRNN as two persistent CUDA kernels.

`train_forward` replaces the Pallas TPU kernel
`forwardtacotron_tpu/kernels/birnn.py:_kernel_train_fwd` (reached through
`_train_fwd_call`): the recurrence plus a stash of 5H values per stream
and step. `train_backward` replaces `_kernel_train_bwd` (through
`_train_bwd_call`): backpropagation through time for every stream in one
reversed walk, giving the gradients of the input gates (dgi) and, for
GRU, of the hidden gates (dgh). Both kernels are `csrc/birnn_train.cu`;
their plain versions are `ops/rnn.py:birnn_train_forward` and
`birnn_train_backward`, with the same signatures, used for tensors on the
CPU. `ops/rnn.py:BiRNNTrain` wraps the pair in one autograd Function.

What bounds them on the card: at the training batch the steps form a
chain of T grid barriers, and the backward's per-step exchange of the
whole B x NG*H gate-gradient vector through L2 is its hot spot (see the
source for the design and what it does about each).
"""
from __future__ import annotations

import ctypes

import torch

from forwardtacotron_tpu_torch.ops.rnn import (birnn_train_backward,
                                               birnn_train_forward, n_gates)

UNITS = (1, 2, 4, 8)   # units per block compiled in csrc/birnn_train.cu


def units_per_block(n_streams: int, hidden: int, n_sms: int) -> int:
    """Smallest compiled U dividing H with one block per SM for all
    S*H/U blocks (a cooperative launch needs every block resident)."""
    for u in UNITS:
        if hidden % u == 0 and n_streams * hidden // u <= n_sms:
            return u
    raise ValueError(f'BiRNN training kernels: {n_streams} streams of '
                     f'H={hidden} do not fit {n_sms} SMs with U in {UNITS}')


def _check(tensors, dev):
    for name, t, dt in tensors:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f'BiRNN training kernel: {name} must be a '
                             f'contiguous {dt} tensor on {dev}, got '
                             f'{t.dtype} on {t.device}')


def _launch(name, what, *args):
    """Call launcher `name` of csrc/birnn_train.cu (built at first use) on
    the current stream of the tensors' device; raise on its error code."""
    from forwardtacotron_tpu_torch.kernels import _build
    lib = _build.load('birnn_train')
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7 \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(lib, fn(*args, torch.cuda.current_stream().cuda_stream),
                 what)


def train_forward(cell: str, gi: torch.Tensor, w_hh: torch.Tensor,
                  b_hh: torch.Tensor, lengths: torch.Tensor,
                  compute_dtype: torch.dtype = torch.float32):
    """(y, stash) of the training forward (see
    `ops/rnn.py:birnn_train_forward` for the contract). CUDA tensors
    launch the kernel; CPU tensors take the plain version."""
    if gi.device.type == 'cpu':
        return birnn_train_forward(cell, gi, w_hh, b_hh, lengths,
                                   compute_dtype)
    if gi.device.type != 'cuda':
        raise ValueError(f'BiRNN training kernel: unsupported device '
                         f'{gi.device}')
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'BiRNN training kernel: compute dtype '
                         f'{compute_dtype}')
    T, B, S, GH = gi.shape
    H = w_hh.shape[-1]
    dev = gi.device
    if GH != n_gates(cell) * H or w_hh.shape != (S, GH, H) \
            or b_hh.shape != (S, GH) or lengths.shape != (B,):
        raise ValueError('BiRNN training kernel: inconsistent shapes '
                         f'gi {tuple(gi.shape)} w_hh {tuple(w_hh.shape)} '
                         f'b_hh {tuple(b_hh.shape)} '
                         f'lengths {tuple(lengths.shape)}')
    _check((('gi', gi, compute_dtype), ('w_hh', w_hh, compute_dtype),
            ('b_hh', b_hh, torch.float32), ('lengths', lengths, torch.int32)),
           dev)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    u = units_per_block(S, H, n_sms)
    y = torch.empty((T, B, S, H), dtype=torch.float32, device=dev)
    stash = torch.empty((T, B, S, 5, H), dtype=compute_dtype, device=dev)
    hbuf = torch.zeros((2, S, B, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch('ftt_birnn_train_fwd', 'BiRNN training forward kernel',
                int(cell == 'lstm'), int(compute_dtype == torch.bfloat16),
                gi.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                lengths.data_ptr(), y.data_ptr(), stash.data_ptr(),
                hbuf.data_ptr(), T, B, S, H, u)
    train_forward.launches += 1
    return y, stash


train_forward.launches = 0


def train_backward(cell: str, stash: torch.Tensor, dy: torch.Tensor,
                   w_hh: torch.Tensor, lengths: torch.Tensor,
                   compute_dtype: torch.dtype = torch.float32):
    """(dgi, dgh) of backpropagation through time (see
    `ops/rnn.py:birnn_train_backward` for the contract; for LSTM the two
    are the same tensor). CUDA tensors launch the kernel; CPU tensors take
    the plain version."""
    if stash.device.type == 'cpu':
        return birnn_train_backward(cell, stash, dy, w_hh, lengths,
                                    compute_dtype)
    if stash.device.type != 'cuda':
        raise ValueError(f'BiRNN training kernel: unsupported device '
                         f'{stash.device}')
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'BiRNN training kernel: compute dtype '
                         f'{compute_dtype}')
    T, B, S, _, H = stash.shape
    GH = n_gates(cell) * H
    dev = stash.device
    if stash.shape[3] != 5 or dy.shape != (T, B, S, H) \
            or w_hh.shape != (S, GH, H) or lengths.shape != (B,):
        raise ValueError('BiRNN training kernel: inconsistent shapes '
                         f'stash {tuple(stash.shape)} dy {tuple(dy.shape)} '
                         f'w_hh {tuple(w_hh.shape)} '
                         f'lengths {tuple(lengths.shape)}')
    _check((('stash', stash, compute_dtype), ('dy', dy, torch.float32),
            ('w_hh', w_hh, compute_dtype), ('lengths', lengths, torch.int32)),
           dev)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    u = units_per_block(S, H, n_sms)
    dgi = torch.empty((T, B, S, GH), dtype=compute_dtype, device=dev)
    dgh = dgi if cell == 'lstm' else torch.empty_like(dgi)
    xbuf = torch.empty((2, S, B, GH), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch('ftt_birnn_train_bwd', 'BiRNN training backward kernel',
                int(cell == 'lstm'), int(compute_dtype == torch.bfloat16),
                stash.data_ptr(), dy.data_ptr(), w_hh.data_ptr(),
                lengths.data_ptr(), dgi.data_ptr(),
                None if cell == 'lstm' else dgh.data_ptr(),
                xbuf.data_ptr(), T, B, S, H, u)
    train_backward.launches += 1
    return dgi, dgh


train_backward.launches = 0
