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

The forward has two paths, chosen by `train_forward_plan`: the
cooperative kernel (one block per U units of a stream, a grid barrier per
step) and, where a stream's whole W_hh fits one block, the batch-split
kernel (one block per stream and batch lane, no grid barrier), which the
training step's series-predictor BiGRUs take. The backward has the same
two paths, chosen apart by `train_backward_plan` (the stash layout is the
same on every path): batch-split where W_hh fits one block, cooperative
otherwise. `path='cooperative'` forces the latter on either kernel, so
that both paths can be timed on the same inputs.

What bounds them on the card: the chain of dependent steps, not bytes or
operations. The cooperative kernels pay a grid barrier per step; the
cooperative backward splits its product by gate rows, so that after the
barrier each block sums only its own units' partials (B x H floats a
block a step cross L2, not the stream's B x NG*H gate gradients). The
batch-split paths are bound by each block's per-step chain of product
and gate math (see the source for the design and what it does about
each).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from forwardtacotron_tpu_torch.ops.rnn import (birnn_train_backward,
                                               birnn_train_forward, n_gates)

UNITS = (1, 2, 4, 8)   # units per block compiled in csrc/birnn_train.cu
PATHS = ('cooperative', 'batch_split')
BS_ROWS = 4            # W_hh rows per thread of its product
BS_MAX_THREADS = 512
BS_MAX_SPLITS = 8
BS_BWD_MAX_SPLITS = 32  # row slices of the batch-split backward's product
COOP_MAX_HIDDEN = 768  # W_hh columns the cooperative backward holds


def units_per_block(n_streams: int, hidden: int, n_sms: int) -> int:
    """Smallest compiled U dividing H with one block per SM for all
    S*H/U blocks (a cooperative launch needs every block resident). H
    above COOP_MAX_HIDDEN is refused for both cooperative kernels alike,
    though with S >= 2 streams (every BiRNN) the SMs run out first."""
    if hidden > COOP_MAX_HIDDEN:
        raise ValueError(f'BiRNN training kernels: H={hidden} has more '
                         f'than {COOP_MAX_HIDDEN} units')
    for u in UNITS:
        if hidden % u == 0 and n_streams * hidden // u <= n_sms:
            return u
    raise ValueError(f'BiRNN training kernels: {n_streams} streams of '
                     f'H={hidden} do not fit {n_sms} SMs with U in {UNITS}')


def _bs_size(ng: int, hidden: int, ks: int, item: int) -> tuple:
    """(threads, shared-memory bytes) of a batch-split block with `ks`
    k-splits (csrc/birnn_train.cu bs_threads/bs_smem): the stream's whole
    W_hh, the lane's rounded h, the product's partial sums and their
    totals, and two steps of the lane's gate inputs."""
    threads = -(-max(ng * hidden // BS_ROWS * ks, hidden) // 32) * 32
    smem = item * ng * hidden * hidden \
        + 4 * (hidden + (ks + 1) * ng * hidden) + item * 2 * ng * hidden
    return threads, smem


def batch_split_shape(cell: str, hidden: int, dtype: torch.dtype,
                      smem_limit: int) -> dict:
    """k-splits, threads and shared-memory bytes of a batch-split block:
    the most k-splits (a power of two) that divide the 16-byte chunks of a
    W_hh row and keep the block within BS_MAX_THREADS threads and
    `smem_limit` bytes. None where nothing fits or H is not a whole
    number of chunks."""
    item = dtype.itemsize
    vec = 16 // item
    ng, chunks = n_gates(cell), hidden // vec
    if hidden % vec:
        return None
    best = None
    ks = 1
    while chunks % ks == 0 and ks <= BS_MAX_SPLITS:
        threads, smem = _bs_size(ng, hidden, ks, item)
        if threads > BS_MAX_THREADS or smem > smem_limit:
            break
        best = {'splits': ks, 'threads': threads, 'smem': smem}
        ks *= 2
    return best


def _bs_bwd_size(ng: int, hidden: int, gs: int, item: int) -> tuple:
    """(threads, shared-memory bytes) of a batch-split backward block with
    `gs` row slices (csrc/birnn_train.cu bs_bwd_threads/bs_bwd_smem): the
    stream's whole W_hh, the lane's rounded dgh, the slices' partial sums,
    and two steps of the lane's dy and stash row."""
    threads = -(-max(hidden * item // 16 * gs, hidden) // 32) * 32
    smem = item * ng * hidden * hidden \
        + 4 * (ng * hidden + gs * hidden + 2 * hidden) \
        + item * 2 * 5 * hidden
    return threads, smem


def batch_split_bwd_shape(cell: str, hidden: int, dtype: torch.dtype,
                          smem_limit: int) -> dict:
    """Row slices, threads and shared-memory bytes of a batch-split
    backward block: the most slices (a power of two dividing NG*H) that
    keep the block within BS_MAX_THREADS threads and `smem_limit` bytes.
    None where nothing fits or H is not a whole number of 16-byte
    chunks."""
    item = dtype.itemsize
    ng = n_gates(cell)
    if hidden % (16 // item):
        return None
    gs = BS_BWD_MAX_SPLITS
    while gs >= 1:
        threads, smem = _bs_bwd_size(ng, hidden, gs, item)
        if (ng * hidden) % gs == 0 and threads <= BS_MAX_THREADS \
                and smem <= smem_limit:
            return {'splits': gs, 'threads': threads, 'smem': smem}
        gs //= 2
    return None


def _cooperative_bwd(n_streams: int, hidden: int, n_sms: int) -> dict:
    """The cooperative backward takes U >= 4 units per block where H
    allows (its partial sums then cross L2 in 16-byte pieces), else the
    forward's U."""
    units = units_per_block(n_streams, hidden, n_sms)
    if units < 4 and hidden % 4 == 0:
        units = 4
    return {'path': 'cooperative', 'units': units}


@functools.lru_cache(maxsize=None)
def train_backward_plan(cell: str, n_streams: int, batch: int, hidden: int,
                        dtype: torch.dtype, smem_limit: int, n_sms: int
                        ) -> dict:
    """The backward kernel's path for a shape, chosen as
    `train_forward_plan` chooses the forward's (the stash layout is the
    same on every path, so the two choices are independent):

    - 'batch_split' wherever a stream's whole W_hh and a lane's state fit
      in one block: one block per stream and batch lane, no grid barrier,
      no exchange;
    - 'cooperative' otherwise: one block per U units of a stream, all
      resident, a grid barrier per step, partial sums exchanged through
      L2."""
    shape = batch_split_bwd_shape(cell, hidden, dtype, smem_limit)
    if shape is not None:
        return {'path': 'batch_split', 'blocks': n_streams * batch, **shape}
    return _cooperative_bwd(n_streams, hidden, n_sms)


@functools.lru_cache(maxsize=None)
def train_forward_plan(cell: str, n_streams: int, batch: int, hidden: int,
                       dtype: torch.dtype, smem_limit: int, n_sms: int
                       ) -> dict:
    """The forward kernel's path for a shape, from the shared memory a
    block may opt in to on the card and its SM count.

    - 'batch_split' wherever a stream's whole W_hh and a lane's state fit
      in one block: one block per stream and batch lane, no grid barrier;
    - 'cooperative' otherwise: one block per U units of a stream, all
      resident, a grid barrier per step."""
    shape = batch_split_shape(cell, hidden, dtype, smem_limit)
    if shape is not None:
        return {'path': 'batch_split',
                'blocks': n_streams * batch, **shape}
    return {'path': 'cooperative',
            'units': units_per_block(n_streams, hidden, n_sms)}


def _check(tensors, dev):
    for name, t, dt in tensors:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f'BiRNN training kernel: {name} must be a '
                             f'contiguous {dt} tensor on {dev}, got '
                             f'{t.dtype} on {t.device}')


def _launch(name, what, n_ptrs, *args):
    """Call launcher `name` of csrc/birnn_train.cu (built at first use) on
    the current stream of the tensors' device; raise on its error code.
    Its arguments: two flags, `n_ptrs` pointers, five ints, the stream."""
    from forwardtacotron_tpu_torch.kernels import _build
    lib = _build.load('birnn_train')
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * n_ptrs \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(lib, fn(*args, torch.cuda.current_stream().cuda_stream),
                 what)


def train_forward(cell: str, gi: torch.Tensor, w_hh: torch.Tensor,
                  b_hh: torch.Tensor, lengths: torch.Tensor,
                  compute_dtype: torch.dtype = torch.float32,
                  path: str = None):
    """(y, stash) of the training forward (see
    `ops/rnn.py:birnn_train_forward` for the contract). CUDA tensors
    launch the kernel on the path of `train_forward_plan`, or on `path`
    when given; CPU tensors take the plain version."""
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
    props = torch.cuda.get_device_properties(dev)
    plan = train_forward_plan(cell, S, B, H, compute_dtype,
                              props.shared_memory_per_block_optin,
                              props.multi_processor_count)
    if path == 'cooperative' and plan['path'] != path:
        plan = {'path': path,
                'units': units_per_block(S, H, props.multi_processor_count)}
    elif path not in (None, plan['path']):
        raise ValueError(f'BiRNN training kernel: the {path} path does not '
                         f'take {cell} H={H} in {compute_dtype}')
    y = torch.empty((T, B, S, H), dtype=torch.float32, device=dev)
    stash = torch.empty((T, B, S, 5, H), dtype=compute_dtype, device=dev)
    args = (int(cell == 'lstm'), int(compute_dtype == torch.bfloat16),
            gi.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
            lengths.data_ptr(), y.data_ptr(), stash.data_ptr())
    with torch.cuda.device(dev):
        if plan['path'] == 'batch_split':
            _launch('ftt_birnn_train_fwd_bs', 'BiRNN training forward kernel '
                    '(batch-split)', 6, *args, T, B, S, H, plan['splits'])
        else:
            hbuf = torch.zeros((2, S, B, H), dtype=torch.float32, device=dev)
            _launch('ftt_birnn_train_fwd', 'BiRNN training forward kernel',
                    7, *args, hbuf.data_ptr(), T, B, S, H, plan['units'])
    train_forward.launches += 1
    train_forward.path_launches[plan['path']] += 1
    train_forward.path_dtype_launches[
        (plan['path'], _DTYPE_NAMES[compute_dtype])] += 1
    return y, stash


_DTYPE_NAMES = {torch.float32: 'float32', torch.bfloat16: 'bfloat16'}
train_forward.launches = 0
train_forward.path_launches = {p: 0 for p in PATHS}
train_forward.path_dtype_launches = {(p, d): 0 for p in PATHS
                                  for d in _DTYPE_NAMES.values()}


def train_backward(cell: str, stash: torch.Tensor, dy: torch.Tensor,
                   w_hh: torch.Tensor, lengths: torch.Tensor,
                   compute_dtype: torch.dtype = torch.float32,
                   path: str = None):
    """(dgi, dgh) of backpropagation through time (see
    `ops/rnn.py:birnn_train_backward` for the contract; for LSTM the two
    are the same tensor). CUDA tensors launch the kernel on the path of
    `train_backward_plan`, or on `path` when given; CPU tensors take the
    plain version."""
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
    props = torch.cuda.get_device_properties(dev)
    plan = train_backward_plan(cell, S, B, H, compute_dtype,
                               props.shared_memory_per_block_optin,
                               props.multi_processor_count)
    if path == 'cooperative' and plan['path'] != path:
        plan = _cooperative_bwd(S, H, props.multi_processor_count)
    elif path not in (None, plan['path']):
        raise ValueError(f'BiRNN training kernel: the {path} backward does '
                         f'not take {cell} H={H} in {compute_dtype}')
    dgi = torch.empty((T, B, S, GH), dtype=compute_dtype, device=dev)
    dgh = dgi if cell == 'lstm' else torch.empty_like(dgi)
    args = (int(cell == 'lstm'), int(compute_dtype == torch.bfloat16),
            stash.data_ptr(), dy.data_ptr(), w_hh.data_ptr(),
            lengths.data_ptr(), dgi.data_ptr(),
            None if cell == 'lstm' else dgh.data_ptr())
    with torch.cuda.device(dev):
        if plan['path'] == 'batch_split':
            _launch('ftt_birnn_train_bwd_bs', 'BiRNN training backward '
                    'kernel (batch-split)', 6, *args, T, B, S, H,
                    plan['splits'])
        else:
            u = plan['units']
            xbuf = torch.empty((2, S, H // u, B, H), dtype=torch.float32,
                               device=dev)
            _launch('ftt_birnn_train_bwd', 'BiRNN training backward kernel',
                    7, *args, xbuf.data_ptr(), T, B, S, H, u)
    train_backward.launches += 1
    train_backward.path_launches[plan['path']] += 1
    train_backward.path_dtype_launches[
        (plan['path'], _DTYPE_NAMES[compute_dtype])] += 1
    return dgi, dgh


train_backward.launches = 0
train_backward.path_launches = {p: 0 for p in PATHS}
train_backward.path_dtype_launches = {(p, d): 0 for p in PATHS
                                  for d in _DTYPE_NAMES.values()}

