"""Bidirectional GRU/LSTM recurrence as one persistent CUDA kernel.

Replaces the Pallas TPU kernel `forwardtacotron_tpu/kernels/birnn.py:
_kernel` (reached through `_pallas_birnn`). The kernel is
`csrc/birnn.cu`; its plain version is `ops/rnn.py:birnn_recurrence`,
which has the same signature and is used for tensors on the CPU.

What bounds it: each step is a (B, H) x (H, NG*H) product per stream
that depends on the previous step, so the work is a chain of T tiny
products; at batch 1 the card is bound by the latency of one step (the
grid-wide barrier plus one pass over the resident weights in shared
memory), not by bytes or FLOPs. The design keeps everything that does
not change from step to step on chip: one cooperative launch for the
whole sequence, each block owns U hidden units of one stream and holds
their NG*U rows of W_hh in shared memory for the kernel's lifetime, the
cell state of its units stays in shared memory, and only h (S x B x H
float32, double-buffered) goes through L2 between steps, one grid
barrier per step.
"""
from __future__ import annotations

import ctypes

import torch

from forwardtacotron_tpu_torch.ops.rnn import birnn_recurrence, n_gates

MAX_ROWS = 32          # NG*U rows per block (csrc/birnn.cu kMaxRows)


def units_per_block(n_streams: int, hidden: int, cell: str,
                    n_sms: int) -> int:
    """Smallest U dividing H with one block per SM for all S*H/U blocks
    (a cooperative launch needs every block resident at once)."""
    for u in range(1, hidden + 1):
        if hidden % u == 0 and n_streams * hidden // u <= n_sms:
            if n_gates(cell) * u > MAX_ROWS:
                break
            return u
    raise ValueError(f'BiRNN kernel: {n_streams} streams of H={hidden} do '
                     f'not fit {n_sms} SMs with at most {MAX_ROWS} rows '
                     'per block')


def recurrence(cell: str, gi: torch.Tensor, w_hh: torch.Tensor,
               b_hh: torch.Tensor, lengths: torch.Tensor,
               compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The BiRNN recurrence (see `ops/rnn.py:birnn_recurrence` for the
    contract). CUDA tensors launch the kernel; CPU tensors take the plain
    version. The kernel's output carries no gradient, so CUDA inputs that
    require grad under grad mode raise: the trainable path is
    `ops/rnn.py:BiRNNTrain`, which `grouped_birnn` picks for them."""
    if gi.device.type == 'cpu':
        return birnn_recurrence(cell, gi, w_hh, b_hh, lengths,
                                compute_dtype)
    if gi.device.type != 'cuda':
        raise ValueError(f'BiRNN kernel: unsupported device {gi.device}')
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (gi, w_hh, b_hh)):
        raise RuntimeError('BiRNN kernel: inputs require grad, but the '
                           'inference kernel would cut the graph; use '
                           'ops/rnn.py:BiRNNTrain (kernels #2 and #3)')
    return _launch(cell, gi, w_hh, b_hh, lengths, compute_dtype)


recurrence.launches = 0


def _launch(cell, gi, w_hh, b_hh, lengths, compute_dtype):
    from forwardtacotron_tpu_torch.kernels import _build
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'BiRNN kernel: compute dtype {compute_dtype}')
    T, B, S, GH = gi.shape
    H = w_hh.shape[-1]
    dev = gi.device
    if GH != n_gates(cell) * H or w_hh.shape != (S, GH, H) \
            or b_hh.shape != (S, GH) or lengths.shape != (B,):
        raise ValueError('BiRNN kernel: inconsistent shapes '
                         f'gi {tuple(gi.shape)} w_hh {tuple(w_hh.shape)} '
                         f'b_hh {tuple(b_hh.shape)} '
                         f'lengths {tuple(lengths.shape)}')
    for name, t, dt in (('gi', gi, compute_dtype),
                        ('w_hh', w_hh, compute_dtype),
                        ('b_hh', b_hh, torch.float32),
                        ('lengths', lengths, torch.int32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f'BiRNN kernel: {name} must be a contiguous '
                             f'{dt} tensor on {dev}, got {t.dtype} on '
                             f'{t.device}')
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    u = units_per_block(S, H, cell, n_sms)
    y = torch.empty((T, B, S, H), dtype=torch.float32, device=dev)
    hbuf = torch.zeros((2, S, B, H), dtype=torch.float32, device=dev)
    lib = _build.load('birnn')
    fn = lib.ftt_birnn_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6 \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(int(cell == 'lstm'), int(compute_dtype == torch.bfloat16),
                  gi.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                  lengths.data_ptr(), y.data_ptr(), hbuf.data_ptr(),
                  T, B, S, H, u, stream)
    _build.check(lib, code, 'BiRNN kernel launch')
    recurrence.launches += 1
    return y
