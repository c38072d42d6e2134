"""Bidirectional GRU/LSTM recurrence of inference as a CUDA kernel (#1).

Replaces the Pallas TPU kernel `forwardtacotron_tpu/kernels/birnn.py:
_kernel` (reached through `_pallas_birnn`). The kernel is
`csrc/birnn.cu`; its plain version is `ops/rnn.py:birnn_recurrence`,
which has the same signature and is used for tensors on the CPU.

What bounds it: each step is a (B, H) x (H, NG*H) product per stream
that depends on the previous step, so the work is a chain of T tiny
products; at batch 1 the card is bound by the latency of one step, not by
bytes or FLOPs. Two paths, chosen by `inference_plan`:

- 'stream_local': one cluster of C blocks per stream and batch lane,
  with no grid barrier (streams and lanes are independent, so where the
  card holds fewer clusters at once they run in waves). The blocks split
  the stream's W_hh by units and keep it resident (registers, then shared
  memory); each step every block pushes its units' new h into the shared
  memory of every block of its cluster, then one cluster barrier (at C=1
  a block barrier). Every shape of the serving path and of `evaluate()`
  takes it.
- 'cooperative': one persistent cooperative launch, a block per U units of
  a stream, all resident, h through L2 and one grid barrier per step; for
  a stream whose W_hh fits no cluster size of the stream-local layout.

`recurrence(..., path=, cluster=)` forces a path (and the stream-local
cluster size), so that they can be timed on the same inputs;
`recurrence.path_launches` counts the launches of each path.

`recurrence` reaches the kernel through the custom op
`ftt::birnn_recurrence` (`kernels/ops.py`): its CUDA implementation is
`launch` (the plan is made there, from the real tensors), its CPU one the
plain version; `torch.export` records the op. Plain CUDA tensors call
`launch` directly (eager, and under CUDA graph capture), without the
op's dispatcher.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from forwardtacotron_tpu_torch.ops.rnn import birnn_recurrence, n_gates

PATHS = ('stream_local', 'cooperative')
MAX_ROWS = 32          # NG*U rows per cooperative block (kMaxRows)
# the stream-local path (csrc/birnn.cu, mirrored names)
SL_ROWS = 4            # W_hh rows per thread of its product (kSlRows)
SL_MAX_THREADS = 512   # kSlMaxThreads
SL_MAX_SPLITS = 16     # kSlMaxSplits
SL_MAX_CLUSTER = 16    # kSlMaxCluster; above 8 a non-portable size
SL_CLUSTERS = (1, 2, 4, 8, 16)  # the cluster sizes the plan picks from
SL_REG_CHUNKS = {4: 4, 2: 2}  # chunks of a thread's rows in registers
# The plan's estimate of a stream-local step, in µs, fitted to the probe's
# phases on an H100 (PERF.md, PR 5; bf16, B=1): the product takes ~0.15
# µs for each 16-byte chunk of a row that a product thread multiplies; the
# rest of a step (with the product's own start) is a fixed cost: ~0.7 µs
# in one block (block barriers only), ~1.3 µs across a cluster (the
# pushes of h and a cluster barrier).
SL_US_PER_CHUNK = 0.15
SL_FIXED_US = {'block': 0.7, 'cluster': 1.3}


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


def _sl_size(ng: int, hidden: int, cluster: int, splits: int, item: int):
    """(threads, shared-memory bytes, W_hh bytes of them) of a stream-local
    block (csrc/birnn.cu sl_size), or None where the kernel does not take
    the shape: thread (g, ks) holds SL_ROWS rows over k-slice ks, its
    first SL_REG_CHUNKS 16-byte chunks a row in registers; shared memory
    holds the W_hh share outside registers, the partial sums of every row,
    two buffers of h and two steps of the block's gate inputs."""
    vec = 16 // item
    if cluster < 1 or cluster > SL_MAX_CLUSTER or cluster & (cluster - 1) \
            or hidden % cluster or not 1 <= splits <= SL_MAX_SPLITS:
        return None
    units = hidden // cluster
    rows = ng * units
    chunks = hidden // vec
    if units % vec or chunks % splits:
        return None
    nc = chunks // splits
    n = max(rows // SL_ROWS * splits, units)
    if n > SL_MAX_THREADS:
        return None
    w_smem = 16 * rows * splits * (nc - min(SL_REG_CHUNKS[item], nc))
    smem = w_smem + 4 * (splits * rows + 2 * hidden) + item * 2 * rows
    return -(-n // 32) * 32, smem, w_smem


def stream_local_shape(cell: str, hidden: int, dtype: torch.dtype,
                       smem_limit: int, cluster: int) -> dict:
    """k-slices, threads and shared memory of a stream-local block at
    cluster size `cluster`: the most k-slices (a power of two) within
    SL_MAX_THREADS threads and `smem_limit` bytes (more slices, more
    threads, more of W_hh in registers, shorter chains). None where nothing
    fits."""
    best = None
    splits = 1
    while splits <= SL_MAX_SPLITS:
        size = _sl_size(n_gates(cell), hidden, cluster, splits,
                        dtype.itemsize)
        if size is not None and size[1] <= smem_limit:
            best = {'cluster': cluster, 'splits': splits,
                    'threads': size[0], 'smem': size[1],
                    'w_smem': size[2]}
        splits *= 2
    return best


def step_estimate_us(hidden: int, dtype: torch.dtype, shape: dict) -> float:
    """The plan's estimate of one step of a stream-local shape:
    SL_US_PER_CHUNK for each chunk of a row a product thread
    multiplies, plus the fixed cost of a step in one block or a
    cluster."""
    chunks = hidden * dtype.itemsize // 16 // shape['splits']
    fixed = SL_FIXED_US['block' if shape['cluster'] == 1 else 'cluster']
    return SL_US_PER_CHUNK * chunks + fixed


def resident_clusters(cluster: int, n_sms: int) -> int:
    """Clusters of `cluster` blocks (one block an SM) the plan counts on
    being resident at once: every SM for single blocks; else 16 // C in
    each group of 18 SMs (an H100's GPCs hold 16-18 SMs, and a cluster
    lies within one). The card's own count (cudaOccupancyMaxActiveClusters,
    which the launcher reads) may be larger."""
    if cluster == 1:
        return n_sms
    return n_sms // 18 * (16 // cluster)


@functools.lru_cache(maxsize=None)
def inference_plan(cell: str, n_streams: int, batch: int, hidden: int,
                   dtype: torch.dtype, smem_limit: int, n_sms: int) -> dict:
    """The inference kernel's path for a shape, from the shared memory a
    block may opt in to on the card and its SM count.

    - 'stream_local' wherever a stream's W_hh fits clusters of C blocks (C
      in SL_CLUSTERS): the C of the least estimated launch, `waves` x
      `step_estimate_us`, where the S*B clusters run in `waves` =
      ceil(S*B / resident_clusters(C)) (the smaller C on a tie). It
      measured faster than the cooperative path at every shape of the
      serving path and of evaluate(), in waves too (PERF.md, PR 5);
    - 'cooperative' where no cluster size fits."""
    fits = []
    for cluster in SL_CLUSTERS:
        shape = stream_local_shape(cell, hidden, dtype, smem_limit, cluster)
        if shape is not None:
            waves = -(-n_streams * batch // resident_clusters(cluster, n_sms))
            fits.append({**shape, 'waves': waves})
    if fits:
        shape = min(fits, key=lambda f: (round(
            f['waves'] * step_estimate_us(hidden, dtype, f), 6),
            f['cluster']))
        return {'path': 'stream_local', 'clusters': n_streams * batch,
                **shape}
    return {'path': 'cooperative',
            'units': units_per_block(n_streams, hidden, cell, n_sms)}


def recurrence(cell: str, gi: torch.Tensor, w_hh: torch.Tensor,
               b_hh: torch.Tensor, lengths: torch.Tensor,
               compute_dtype: torch.dtype = torch.float32,
               path: str = None, cluster: int = None) -> torch.Tensor:
    """The BiRNN recurrence (see `ops/rnn.py:birnn_recurrence` for the
    contract), through the op `ftt::birnn_recurrence`: CUDA tensors launch
    the kernel on the path of `inference_plan`, or on `path` when given
    (stream-local: with `cluster` blocks a cluster, where given); CPU
    tensors take the plain version. The kernel's output carries no
    gradient, so CUDA inputs that require grad under grad mode raise: the
    trainable path is `ops/rnn.py:BiRNNTrain`, which `grouped_birnn`
    picks for them. CPU inputs that require grad take the plain version
    directly, which autograd differentiates. A plain CUDA tensor, eager
    or under graph capture, launches directly: the op's dispatcher,
    which only torch.export's fake tensors need, is left out of the
    launch's host time."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (gi, w_hh, b_hh)):
        if gi.device.type == 'cpu':
            return birnn_recurrence(cell, gi, w_hh, b_hh, lengths,
                                    compute_dtype)
        raise RuntimeError('BiRNN kernel: inputs require grad, but the '
                           'inference kernel would cut the graph; use '
                           'ops/rnn.py:BiRNNTrain (kernels #2 and #3)')
    if type(gi) is torch.Tensor and gi.is_cuda:
        return launch(cell, gi, w_hh, b_hh, lengths, compute_dtype, path,
                      cluster)
    return torch.ops.ftt.birnn_recurrence(cell, gi, w_hh, b_hh, lengths,
                                          compute_dtype, path, cluster)


recurrence.launches = 0
recurrence.path_launches = {p: 0 for p in PATHS}


def _plan(cell, S, B, H, dtype, props, path=None, cluster=None):
    """The plan of a launch: `inference_plan`'s, or the one `path` and
    `cluster` force; raises where the forced path does not take the
    shape."""
    smem, n_sms = props.shared_memory_per_block_optin, \
        props.multi_processor_count
    plan = inference_plan(cell, S, B, H, dtype, smem, n_sms)
    if path is None and cluster is None:
        return plan
    if path == 'cooperative':
        return {'path': path, 'units': units_per_block(S, H, cell, n_sms)}
    if path not in (None, 'stream_local'):
        raise ValueError(f'BiRNN kernel: unknown path {path!r}')
    if cluster is None:
        if plan['path'] != 'stream_local':
            raise ValueError(f'BiRNN kernel: the stream-local path does not '
                             f'take {cell} S={S} B={B} H={H} in {dtype}')
        cluster = plan['cluster']
    shape = stream_local_shape(cell, H, dtype, smem, cluster)
    if shape is None:
        raise ValueError(f'BiRNN kernel: {cell} H={H} in {dtype} does not '
                         f'fit clusters of {cluster}')
    return {'path': 'stream_local', 'clusters': S * B, **shape}


def launch(cell, gi, w_hh, b_hh, lengths, compute_dtype, path=None,
           cluster=None):
    """The kernel's launch on CUDA tensors (the CUDA implementation of
    `ftt::birnn_recurrence`)."""
    from forwardtacotron_tpu_torch.kernels import _build
    if gi.device.type != 'cuda':
        raise ValueError(f'BiRNN kernel: unsupported device {gi.device}')
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
    plan = _plan(cell, S, B, H, compute_dtype,
                 torch.cuda.get_device_properties(dev), path, cluster)
    y = torch.empty((T, B, S, H), dtype=torch.float32, device=dev)
    lib = _build.load('birnn')
    flags = (int(cell == 'lstm'), int(compute_dtype == torch.bfloat16))
    ptrs = (gi.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
            lengths.data_ptr(), y.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if plan['path'] == 'stream_local':
            fn = lib.ftt_birnn_sl_launch
            fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 \
                + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            code = fn(*flags, *ptrs, T, B, S, H, plan['cluster'],
                      plan['splits'], stream)
            what = 'BiRNN kernel launch (stream-local)'
        else:
            hbuf = torch.zeros((2, S, B, H), dtype=torch.float32,
                               device=dev)
            fn = lib.ftt_birnn_launch
            fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 \
                + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            code = fn(*flags, *ptrs, hbuf.data_ptr(), T, B, S, H,
                      plan['units'], stream)
            what = 'BiRNN kernel launch (cooperative)'
    _build.check(lib, code, what)
    recurrence.launches += 1
    recurrence.path_launches[plan['path']] += 1
    return y


def sl_size_on_card(cell: str, hidden: int, dtype: torch.dtype,
                    cluster: int, splits: int) -> tuple:
    """(threads, shared-memory bytes, resident clusters) of a stream-local
    block as csrc/birnn.cu's launcher computes them
    (ftt_birnn_sl_size), the last from cudaOccupancyMaxActiveClusters on
    the current card; threads 0 where the kernel does not take the
    shape."""
    from forwardtacotron_tpu_torch.kernels import _build
    lib = _build.load('birnn')
    fn = lib.ftt_birnn_sl_size
    fn.argtypes = [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    threads, smem, resident = ctypes.c_int(), ctypes.c_longlong(), \
        ctypes.c_int()
    _build.check(lib, fn(int(cell == 'lstm'), int(dtype == torch.bfloat16),
                         hidden, cluster, splits,
                         ctypes.byref(threads), ctypes.byref(smem),
                         ctypes.byref(resident)),
                 'BiRNN stream-local size')
    return threads.value, smem.value, resident.value
