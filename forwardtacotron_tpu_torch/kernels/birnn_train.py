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

The forward has three paths, chosen by `train_forward_plan`: where a
stream's whole W_hh fits one block, the batch-split kernel (one block per
stream and batch lane, no grid barrier), which the training step's
series-predictor BiGRUs take; where a stream's W_hh fits a cluster of C
blocks and the clusters run in one wave, the cluster kernel (one
thread-block cluster per stream and group of 8 or 16 lanes, W_hh split by
units and resident, h pushed into the peers' shared memory, a cluster
barrier per step; bf16 on the tensor cores), which the CBHG GRUs,
WaveRNN's GRU and the decoder LSTM take (the last in float32 only at
grad_accum's micro-batches: at batch 32 its clusters need two waves);
otherwise the cooperative kernel (one block per U units of a stream, a
grid barrier per step). The backward has two paths, chosen apart by
`train_backward_plan` (the stash layout is the same on every path):
batch-split where W_hh fits one block, cooperative otherwise. `path=`
forces a path on either kernel, so that the paths can be timed on the
same inputs; `launch_forward` launches a forward plan of any shape.

The counters (`train_forward.launches`, `.path_launches`,
`.path_dtype_launches`, and `train_backward`'s) count the wrappers'
calls. A call inside the capture of a CUDA graph counts once, when its
launch is recorded; the graph's replays run that launch without a call
and count nowhere here (a profiler counts them on the card:
`utils/profiling.py:kernel_launches`).

What bounds them on the card: the chain of dependent steps, not bytes or
operations. The cooperative kernels pay a grid barrier per step; the
cooperative backward splits its product by gate rows, so that after the
barrier each block sums only its own units' partials (B x H floats a
block a step cross L2, not the stream's B x NG*H gate gradients). The
batch-split and cluster paths are bound by each block's per-step chain of
product, gate math (and for clusters, the exchange of h and a cluster
barrier); see the source for the design and what it does about each.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from forwardtacotron_tpu_torch.ops.rnn import (birnn_train_backward,
                                               birnn_train_forward, n_gates)
from forwardtacotron_tpu_torch.utils.profiling import annotate

UNITS = (1, 2, 4, 8)   # units per block compiled in csrc/birnn_train.cu
PATHS = ('cooperative', 'batch_split', 'cluster')  # of the forward
BWD_PATHS = ('cooperative', 'batch_split')
BS_ROWS = 4            # W_hh rows per thread of its product
BS_MAX_THREADS = 512
BS_MAX_SPLITS = 8
BS_BWD_MAX_SPLITS = 32  # row slices of the batch-split backward's product
COOP_MAX_HIDDEN = 768  # W_hh columns the cooperative backward holds
# the cluster forward (csrc/birnn_train.cu, mirrored names)
CL_CLUSTERS = (2, 4, 8, 16)   # blocks of a cluster (kClMaxCluster 16)
CL_MAX_THREADS = 512          # kClMaxThreads
CL_MAX_SPLITS = 16            # kClMaxSplits
CL_TC_REG = 8                 # A tiles a warp keeps in registers (bf16)
CL_FMA_ROWS = 2               # W_hh rows a thread multiplies (float32)
# 16-byte chunks of a row in a thread's registers (float32): the fewer
# where the rest fits shared memory (4: no spills, 4-9% faster than 8 on
# an H100, PERF.md)
CL_FMA_REGS = (4, 8)
CL_LANES = (8, 16)  # lanes of a group (float32 on the CUDA cores: 8)
# the product of the cluster forward by element size: bf16 on the tensor
# cores ('mma'), float32 on the CUDA cores ('fma')
CL_PRODUCT = {2: 'mma', 4: 'fma'}
# The plan's estimate of a cluster block's step, in µs, which chooses the
# cluster size and group width: its fixed cost (gate math, pushes of h,
# the cluster barrier), which grows with the lanes of a group, and its
# product per mma.m16n8k16 tile (bf16) or per FMA (float32, by the 16-byte
# chunks of a row in registers: 8 spill) of a block. Least-squares fits
# (`tools/torch_kernel_probe.py --fit`) to the probe's CUDA-event times at
# the training shapes on an H100; the readings are in PERF.md.
CL_FIXED_US = 2.15
CL_FIXED_US_PER_LANE = 0.024
CL_US_PER_MMA = 3.43e-3
CL_US_PER_FMA = {4: 7.52e-6, 8: 8.98e-6}


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


def _cl_block(ng: int, hidden: int, cluster: int, lanes: int, splits: int,
              item: int, product_size):
    """(threads, shared-memory bytes, W_hh bytes of them) of a cluster
    forward block (csrc/birnn_train.cu cl_layout) whose product takes
    `product_size(rows, splits)` = (threads, W_hh bytes in shared memory)
    or None; None where the kernel does not take the shape. After W_hh's
    share: two buffers of the group's rounded h (rows of H + 16 bytes), the
    partial sums of every (lane, row) (rows padded by 4) and two steps of
    the block's gate inputs; one owner thread a (lane, unit)."""
    vec = 16 // item
    if cluster not in CL_CLUSTERS or hidden % cluster \
            or not 1 <= splits <= CL_MAX_SPLITS or splits & (splits - 1):
        return None
    units = hidden // cluster
    rows = ng * units
    if units % vec or (part := product_size(rows, splits)) is None:
        return None
    n = max(part[0], units * lanes)
    if n > CL_MAX_THREADS:
        return None
    h_bytes = -(-item * 2 * lanes * (hidden + vec) // 16) * 16
    smem = part[1] + h_bytes + 4 * splits * lanes * (rows + 4) \
        + item * 2 * ng * lanes * units
    return -(-n // 32) * 32, smem, part[1]


def _cl_size(ng: int, hidden: int, cluster: int, lanes: int, splits: int,
             reg: int, item: int):
    """`_cl_block` of the shipped products (ClMmaProduct, ClFmaProduct):
    bf16 on the tensor cores, warps of 16 W_hh rows x `splits` k-slices,
    each warp's first CL_TC_REG A tiles (16 x 16) in registers and the rest
    in shared memory (512 bytes a tile), in groups of 8 or 16 lanes;
    float32 on the CUDA cores, CL_FMA_ROWS rows x `splits` k-slices a
    thread, its first `reg` (CL_FMA_REGS) 16-byte chunks of a row in
    registers, in groups of 8."""
    def mma(rows, splits):
        if reg != CL_TC_REG or lanes not in CL_LANES or rows % 16 \
                or hidden % 16 or (hidden // 16) % splits:
            return None
        tiles = hidden // 16 // splits
        return (32 * rows // 16 * splits,
                512 * rows // 16 * splits * (tiles - min(reg, tiles)))

    def fma(rows, splits):
        if reg not in CL_FMA_REGS or lanes != 8 or rows % CL_FMA_ROWS \
                or (hidden // 4) % splits:
            return None
        chunks = hidden // 4 // splits
        return (rows // CL_FMA_ROWS * splits,
                16 * rows * splits * (chunks - min(reg, chunks)))

    return _cl_block(ng, hidden, cluster, lanes, splits, item,
                     mma if item == 2 else fma)


def cluster_shape(cell: str, hidden: int, dtype: torch.dtype,
                  smem_limit: int, cluster: int, lanes: int) -> dict:
    """k-slices, register share, threads and shared memory of a
    cluster-forward block at `cluster` blocks and `lanes` lanes a group:
    the most k-slices (a power of two) within CL_MAX_THREADS threads and
    `smem_limit` bytes (more slices, more threads, more of W_hh in
    registers, shorter chains), with the smallest register share that
    fits. None where nothing fits."""
    product = CL_PRODUCT[dtype.itemsize]
    regs = {'mma': (CL_TC_REG,), 'fma': CL_FMA_REGS}[product]
    best = None
    splits = 1
    while splits <= CL_MAX_SPLITS:
        for reg in regs:
            size = _cl_size(n_gates(cell), hidden, cluster, lanes, splits,
                            reg, dtype.itemsize)
            if size is not None and size[1] <= smem_limit:
                best = {'cluster': cluster, 'lanes': lanes,
                        'product': product, 'splits': splits, 'reg': reg,
                        'threads': size[0], 'smem': size[1],
                        'w_smem': size[2]}
                break
        splits *= 2
    return best


def cluster_shapes(cell: str, hidden: int, dtype: torch.dtype,
                   smem_limit: int) -> list:
    """`cluster_shape` at every cluster size and group width that
    fits."""
    return [shape for c in CL_CLUSTERS for lanes in CL_LANES
            if (shape := cluster_shape(cell, hidden, dtype, smem_limit, c,
                                       lanes)) is not None]


def cl_step_estimate_us(cell: str, hidden: int, dtype: torch.dtype,
                        shape: dict) -> float:
    """The plan's estimate of one step of a cluster-forward block: its
    fixed cost (CL_FIXED_US, CL_FIXED_US_PER_LANE a lane of the group)
    plus its product, CL_US_PER_MMA a tensor-core tile (bf16) or
    CL_US_PER_FMA[reg] an FMA (float32) of the block's rows against the
    group's lanes."""
    rows = n_gates(cell) * hidden // shape['cluster']
    if shape['product'] == 'mma':
        product = CL_US_PER_MMA * (rows // 16 * shape['lanes'] // 8
                                   * (hidden // 16))
    else:
        product = CL_US_PER_FMA[shape['reg']] * rows * hidden \
            * shape['lanes']
    return CL_FIXED_US + CL_FIXED_US_PER_LANE * shape['lanes'] + product


def _cluster_plan(cell, n_streams, batch, hidden, dtype, smem_limit, n_sms,
                  cluster=None):
    """The cluster shape of the least estimated launch, `waves` x
    `cl_step_estimate_us`, where the S x ceil(B / lanes) clusters run in
    `waves` = ceil(clusters / resident_clusters(C)) (the smaller C, then
    the wider group, on a tie); with `cluster` = (C, lanes), that shape
    (for timing shapes the plan does not choose through `launch_forward`).
    None where nothing fits."""
    from forwardtacotron_tpu_torch.kernels.birnn import resident_clusters
    fits = []
    for shape in cluster_shapes(cell, hidden, dtype, smem_limit):
        if cluster is not None and cluster != (shape['cluster'],
                                               shape['lanes']):
            continue
        clusters = n_streams * -(-batch // shape['lanes'])
        waves = -(-clusters // resident_clusters(shape['cluster'], n_sms))
        fits.append({'path': 'cluster', 'clusters': clusters,
                     'waves': waves, **shape,
                     'step_us': waves * cl_step_estimate_us(
                         cell, hidden, dtype, shape)})
    if not fits:
        return None
    return min(fits, key=lambda f: (round(f['step_us'], 6), f['cluster'],
                                    -f['lanes']))


def cl_size_on_card(cell: str, hidden: int, dtype: torch.dtype,
                    cluster: int, lanes: int, splits: int, reg: int) -> tuple:
    """(threads, shared-memory bytes, resident clusters) of a
    cluster-forward block as csrc/birnn_train.cu's launcher computes them
    (ftt_birnn_train_cl_size), the last from cudaOccupancyMaxActiveClusters
    on the current card; threads 0 where the kernel does not take the
    shape."""
    from forwardtacotron_tpu_torch.kernels import _build
    lib = _build.load('birnn_train')
    fn = lib.ftt_birnn_train_cl_size
    fn.argtypes = [ctypes.c_int] * 8 + [
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    threads, smem, resident = ctypes.c_int(), ctypes.c_longlong(), \
        ctypes.c_int()
    _build.check(lib, fn(int(cell == 'lstm'), int(dtype == torch.bfloat16),
                         hidden, cluster, lanes, splits, reg,
                         int(dtype == torch.bfloat16),
                         ctypes.byref(threads), ctypes.byref(smem),
                         ctypes.byref(resident)),
                 'BiRNN training cluster size')
    return threads.value, smem.value, resident.value


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
    - 'cluster' where a stream's W_hh fits a cluster of C blocks, at the
      (C, lanes) of the least estimated launch (`_cluster_plan`), if its
      clusters run in one wave (or the cooperative path cannot launch):
      one cluster per stream and group of lanes, h through distributed
      shared memory, a cluster barrier per step. In one wave it measured
      faster than the cooperative path at every shape of the training
      paths (PERF.md), by 1.2-1.9x in float32 and 2.3-4.1x in bf16. A
      second wave doubles its chain of steps: at the one such shape, the
      float32 decoder at batch 32 (the 4 clusters of 16 that its W_hh
      needs, 7 resident), the two paths measured within 3.5% of each
      other, the faster one changing between probe runs;
    - 'cooperative' otherwise: one block per U units of a stream, all
      resident, a grid barrier per step."""
    shape = batch_split_shape(cell, hidden, dtype, smem_limit)
    if shape is not None:
        return {'path': 'batch_split',
                'blocks': n_streams * batch, **shape}
    cl = _cluster_plan(cell, n_streams, batch, hidden, dtype, smem_limit,
                       n_sms)
    if cl is not None and cl['waves'] == 1:
        return cl
    try:
        return {'path': 'cooperative',
                'units': units_per_block(n_streams, hidden, n_sms)}
    except ValueError:
        if cl is None:
            raise
        return cl


def _check(tensors, dev):
    for name, t, dt in tensors:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f'BiRNN training kernel: {name} must be a '
                             f'contiguous {dt} tensor on {dev}, got '
                             f'{t.dtype} on {t.device}')


def _launch(name, what, n_ptrs, *args):
    """Call launcher `name` of csrc/birnn_train.cu (built at first use) on
    the current stream of the tensors' device; raise on its error code.
    Its arguments: two flags, `n_ptrs` pointers, the ints, the stream."""
    from forwardtacotron_tpu_torch.kernels import _build
    lib = _build.load('birnn_train')
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * n_ptrs \
        + [ctypes.c_int] * (len(args) - 2 - n_ptrs) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(lib, fn(*args, torch.cuda.current_stream().cuda_stream),
                 what)


def _forward_plan(cell, S, B, H, dtype, props, path=None):
    """The plan of a forward launch: `train_forward_plan`'s, or the one
    `path` forces; raises where the forced path does not take the
    shape."""
    smem, n_sms = props.shared_memory_per_block_optin, \
        props.multi_processor_count
    plan = train_forward_plan(cell, S, B, H, dtype, smem, n_sms)
    if path not in (None,) + PATHS:
        raise ValueError(f'BiRNN training kernel: unknown path {path!r}')
    if path == 'cooperative':
        return {'path': path, 'units': units_per_block(S, H, n_sms)}
    if path == 'cluster':
        forced = _cluster_plan(cell, S, B, H, dtype, smem, n_sms)
        if forced is None:
            raise ValueError(f'BiRNN training kernel: the cluster path does '
                             f'not take {cell} H={H} in {dtype}')
        return forced
    if path not in (None, plan['path']):
        raise ValueError(f'BiRNN training kernel: the {path} path does not '
                         f'take {cell} H={H} in {dtype}')
    return plan


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
    plan = _forward_plan(cell, S, B, H, compute_dtype,
                         torch.cuda.get_device_properties(dev), path)
    return launch_forward(plan, cell, gi, w_hh, b_hh, lengths,
                          compute_dtype)


def launch_forward(plan: dict, cell: str, gi: torch.Tensor,
                   w_hh: torch.Tensor, b_hh: torch.Tensor,
                   lengths: torch.Tensor, compute_dtype: torch.dtype):
    """(y, stash) of one launch of the forward kernel on the path and
    shape of `plan` (a plan of `train_forward_plan`'s form), on inputs
    `train_forward` has checked, counted in `train_forward`'s counters
    (and, while a profiler records, spanned as
    `ftt.kernels.birnn_train_fwd` with its shape: `utils/profiling.py`).
    tools/torch_kernel_probe.py and the tests time and check shapes the
    plan does not choose through it (`_cluster_plan(..., cluster)`)."""
    T, B, S, _ = gi.shape
    H = w_hh.shape[-1]
    dev = gi.device
    y = torch.empty((T, B, S, H), dtype=torch.float32, device=dev)
    stash = torch.empty((T, B, S, 5, H), dtype=compute_dtype, device=dev)
    args = (int(cell == 'lstm'), int(compute_dtype == torch.bfloat16),
            gi.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
            lengths.data_ptr(), y.data_ptr(), stash.data_ptr())
    with torch.cuda.device(dev), annotate(
            'ftt.kernels.birnn_train_fwd', path=plan['path'], cell=cell,
            dtype=_DTYPE_NAMES[compute_dtype], T=T, B=B, S=S, H=H,
            lengths=lengths):
        if plan['path'] == 'batch_split':
            _launch('ftt_birnn_train_fwd_bs', 'BiRNN training forward kernel '
                    '(batch-split)', 6, *args, T, B, S, H, plan['splits'])
        elif plan['path'] == 'cluster':
            _launch('ftt_birnn_train_fwd_cl', 'BiRNN training forward kernel '
                    '(cluster)', 6, *args, T, B, S, H, plan['cluster'],
                    plan['lanes'], plan['splits'], plan['reg'],
                    int(plan['product'] == 'mma'))
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
    `train_backward_plan`, or on `path` when given (a launch spanned as
    `ftt.kernels.birnn_train_bwd` while a profiler records); CPU tensors
    take the plain version."""
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
    with torch.cuda.device(dev), annotate(
            'ftt.kernels.birnn_train_bwd', path=plan['path'], cell=cell,
            dtype=_DTYPE_NAMES[compute_dtype], T=T, B=B, S=S, H=H,
            lengths=lengths):
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
train_backward.path_launches = {p: 0 for p in BWD_PATHS}
train_backward.path_dtype_launches = {(p, d): 0 for p in BWD_PATHS
                                  for d in _DTYPE_NAMES.values()}

