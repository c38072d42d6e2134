"""Per-step and per-phase cost of the port's CUDA kernels on the card.

    python tools/torch_kernel_probe.py [--steps 400] [--lanes 1,8,64,128]
                                       [--phases] [--seeds 6] [--rounds 2]
                                       [--dtypes bfloat16,float32]
                                       [--batches 32] [--shapes decoder,...]
                                       [--only train,train_bwd,sampler,birnn,birnn_eval,grads,dispatch]
    python tools/torch_kernel_probe.py --fit KERNEL_PROBE.jsonl

Times, with CUDA events:
- the WaveRNN sampling kernel (#4) at full width (rnn_dims = fc_dims =
  512, RAW 9 bits) for each fold-lane count of `--lanes`, greedy and
  sampled, in bfloat16 and float32;
- the BiRNN training forward (#2) at the training step's five shapes and
  WaveRNN's (`chip_smoke.TRAIN_KERNEL_CASES`, `VOCODER_TRAIN_KERNEL_CASES`;
  of `--shapes` where given) at each batch of `--batches` (32 by
  default), float32 and bfloat16, on each of its paths that takes the
  shape, the cluster path at every (C, lanes) and register share that
  fits (with its k-slices, threads, shared memory, waves, the plan's
  estimate and the clusters resident at once; float32 also with the
  3xTF32 product of `csrc/birnn_train_tf32.cu`, a library of its own),
  `--rounds` turns on the same inputs, beside the path that
  `train_forward_plan` picks, with the cluster kernels' `-Xptxas -v`
  registers and spills; `--fit` fits the plan's cluster step estimate
  (`kernels/birnn_train.py` CL_*) to such rows by least squares;
- the BiRNN training backward (#3) at the five shapes of the training
  step (`chip_smoke.TRAIN_KERNEL_CASES`, B=32: decoder LSTM H=512
  T=1024, postnet GRU H=256 T=1024, prenet GRU H=256 T=192, predictor
  GRUs H=128/64 T=192; float32 and bfloat16) on the cooperative path and,
  where `train_backward_plan` picks it, the batch-split path; and, where
  the cooperative path is planned, the cooperative backward as first
  designed (`csrc/birnn_train_staged.cu`: the exchange staged by bulk
  copies multicast within clusters) on the same inputs, with its staging
  buffers, cluster size and largest difference from the shipped path;
- the BiRNN inference kernel (#1) at the serving shapes
  (`chip_smoke.SERVING_BIRNN_CASES`, B=1, in each of `--dtypes`,
  bfloat16 by default): its stream-local path at every cluster size that
  fits, with the product on the CUDA cores and, in bfloat16, on the
  tensor cores (`csrc/birnn_sl_mma.cu`, a library of its own that the
  package never loads), each with its k-slices, threads, shared memory
  and the clusters resident at once, and its cooperative path, `--rounds`
  turns each on the same inputs, beside cuDNN and the bound, with the
  `-Xptxas -v` registers of both libraries and the host µs of a launch
  of the planned and the cooperative path;
- with `--only birnn_eval`: kernel #1 at the five shapes that evaluate()
  gives it (`chip_smoke.EVAL_BIRNN_CASES`, B=32, float32), the
  stream-local path at every cluster size that fits (its 64 clusters in
  waves where the card holds fewer at once) and the cooperative path, in
  turns on the same inputs;
- with `--only dispatch`: the host µs of a call of kernels #1 and #4
  through their custom ops (`kernels/ops.py`), through the wrappers the
  models call (`recurrence`, `sample`) and through their ctypes
  launchers called directly, on inputs of 4 steps (device time small),
  `--rounds` turns of the ways: #1 at the serving shapes, B=1, in each
  of `--dtypes`; #4 at 8 lanes in bfloat16, the wrapper with an int seed
  (written to the card a call) and the others with a seed already
  there;
- with `--only grads` (not run by default): the float32 gradients of the
  full-width model on chip_smoke's two-item batch, card (kernels #2/#3)
  against CPU (plain versions), for `--seeds` random models: with the CPU
  replaying the card's ReLU and max-pool decisions, as chip_smoke checks
  them, and with its own, and how many of its own decisions differ (a
  pre-activation near zero that rounds to the other side moves a
  gradient by a whole term); `ok` is chip_smoke's limits.

With `--phases`, it also loads the probe build (`-DFTT_PROBE`) and
prints where a step's time goes, from thread 0 of block 0: kernels #1,
#2 and #3 at the same shapes on each path (#1's stream-local path:
product, row sums, gate math, exchange, barrier; #2's cluster path:
product, input wait, gate math and stores, pushes of h, cluster
barrier), and the sampler in
bfloat16 at 1, 64 and 72 lanes (of those in `--lanes`).

Prints one JSON object per line (also written to
kernel_probe.jsonl in `chip_smoke.py`'s output directory) and the card's
name and power limit.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from forwardtacotron_tpu_torch.kernels.birnn import (  # noqa: E402
    resident_clusters)
from forwardtacotron_tpu_torch.ops.rnn import n_gates  # noqa: E402
from chip_smoke import (OUT_DIR, TRAIN_KERNEL_CASES,  # noqa: E402
                        VOCODER_TRAIN_KERNEL_CASES, _card_cpu_grads,
                        _grads_batch, _train_inputs)

OUT = OUT_DIR / 'kernel_probe.jsonl'
TRAIN_PHASES = {'cooperative': ('stage h', 'product', 'reduce',
                                'gate update', 'grid barrier'),
                'batch_split': ('product', 'product wait', 'gate sums',
                                'gate math, stash stores', 'stores',
                                'update wait'),
                'cluster': ('product', 'input wait', 'gate math, stores',
                            'push h', 'cluster barrier')}
TRAIN_BWD_PHASES = {'cooperative': ('gate gradients', 'partial products',
                                    'grid barrier', 'partial sums'),
                    'batch_split': ('input wait', 'gate gradients',
                                    'product', 'slice sums'),
                    'staged': ('gate gradients', 'grid barrier', 'copy wait',
                               'product', 'combine',
                               'cluster barrier, next copy')}
BIRNN_PHASES = {'stream_local': ('product', 'row sums', 'gate math',
                                 'exchange', 'barrier'),
                'cooperative': ('product', 'gate math, stores',
                                'grid barrier')}
SAMPLER_PHASES = ('stage', 'product', 'gate update', 'grid barrier',
                  'sample', 'product wait')


def emit(row):
    print(json.dumps(row), flush=True)
    with OUT.open('a') as f:
        f.write(json.dumps(row) + '\n')


def cuda_ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps=200):
    """Host µs a call of fn, launched back to back (one synchronize at the
    end, so a call whose device time is below its host time shows the
    host's)."""
    import time
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def phases(name, labels, fn, reps, steps):
    """µs per step of each probe phase of `reps` calls of fn."""
    from forwardtacotron_tpu_torch.kernels import _build
    _build.PROBE = True
    try:
        fn()
        _build.probe_read(name)
        for _ in range(reps):
            fn()
        got = _build.probe_read(name)
    finally:
        _build.PROBE = False
    per = reps * steps
    out = {lab: got[f'phase{i}'] / per / 1e3 for i, lab in enumerate(labels)}
    out['step'] = got['run_ns'] / per / 1e3
    return out


def sampler(args):
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.kernels import wavernn_sample as ws
    from forwardtacotron_tpu_torch.models.wavernn import WaveRNN
    torch.manual_seed(0)
    model = WaveRNN.from_config(default_config()).cuda()
    C = model.feat_dims + 4 * model.aux_dims
    seed = ws.seed_tensor(0, 'cuda')      # read by the kernel from the card
    for dtype in (torch.bfloat16, torch.float32):
        w = ws.pack_weights(model, dtype)
        for lanes in (int(v) for v in args.lanes.split(',')):
            cond = (torch.randn((args.steps, lanes, C), device='cuda')
                    * 0.5).to(dtype)
            for greedy in (True, False):
                ms = cuda_ms(lambda: ws.sample(cond, w, seed, 0, greedy,
                                               dtype))
                emit({'kernel': 'wavernn_sample', 'dtype': str(dtype)[6:],
                      'lanes': lanes, 'greedy': greedy, 'steps': args.steps,
                      'ms': ms, 'us_per_step': 1e3 * ms / args.steps})
            if (args.phases and lanes in (1, 64, 72)
                    and dtype == torch.bfloat16):
                emit({'kernel': 'wavernn_sample', 'probe_us_per_step': phases(
                    'wavernn_sample', SAMPLER_PHASES,
                    lambda: ws.sample(cond, w, seed, 0, False, dtype), 2,
                    args.steps), 'dtype': 'bfloat16', 'lanes': lanes})


TF32_REGS = (8, 16)  # A tiles a warp keeps in registers (kClTf32RegLo/Hi)


def tf32_size(ng, H, C, lanes, splits, reg):
    """(threads, shared-memory bytes, W_hh bytes of them) of a block of
    the 3xTF32 cluster forward (csrc/birnn_train_tf32.cu, the float32
    ClMmaProduct): warps of 16 W_hh rows x `splits` k-slices, each warp's
    first `reg` (TF32_REGS) A tiles of 16 x 8 floats in registers and the
    rest in shared memory (512 bytes a tile), groups of 8 or 16 lanes;
    None where it does not take the shape."""
    from forwardtacotron_tpu_torch.kernels import birnn_train as bt

    def product(rows, splits):
        if reg not in TF32_REGS or lanes not in bt.CL_LANES or rows % 16 \
                or H % 8 or (H // 8) % splits:
            return None
        tiles = H // 8 // splits
        return (32 * rows // 16 * splits,
                512 * rows // 16 * splits * (tiles - min(reg, tiles)))

    return bt._cl_block(ng, H, C, lanes, splits, 4, product)


def tf32_shape(cell, H, smem, C, lanes):
    """The 3xTF32 block at C blocks and `lanes` lanes as
    `birnn_train.cluster_shape` chooses the shipped ones: the most
    k-slices within the threads and `smem` bytes, the fewer A tiles in
    registers that fit; None where nothing fits."""
    from forwardtacotron_tpu_torch.kernels import birnn_train as bt
    best, splits = None, 1
    while splits <= bt.CL_MAX_SPLITS:
        for reg in TF32_REGS:
            size = tf32_size(n_gates(cell), H, C, lanes, splits, reg)
            if size is not None and size[1] <= smem:
                best = {'cluster': C, 'lanes': lanes, 'product': 'tf32x3',
                        'splits': splits, 'reg': reg, 'threads': size[0],
                        'smem': size[1], 'w_smem': size[2]}
                break
        splits *= 2
    return best


def train_forward_paths(args):
    """Kernel #2 at the training step's five shapes and WaveRNN's
    (`chip_smoke.TRAIN_KERNEL_CASES`, `VOCODER_TRAIN_KERNEL_CASES`) at each
    batch of `--batches` (the shortest lanes of chip_smoke's lengths, as
    grad_accum's micro-batches take them), float32 and bfloat16, on each
    path that takes the shape, the cluster path at every (C, lanes) and
    register share that fits (float32 also with the 3xTF32 product),
    `--rounds` turns on the same inputs, with `--phases` by phase; and the
    `-Xptxas -v` registers and spills of the cluster kernels."""
    from forwardtacotron_tpu_torch.kernels import birnn_train as bt
    birnn_ptxas(['birnn_train', 'birnn_train_tf32'], 'train_fwd_cl')
    props = torch.cuda.get_device_properties(0)
    smem = props.shared_memory_per_block_optin
    n_sms = props.multi_processor_count
    cases = [(n, c, T, H, ln, 2) for n, c, T, H, ln in TRAIN_KERNEL_CASES]
    cases += [(n, c, T, H, ln, 1)
              for n, c, T, H, _, ln in VOCODER_TRAIN_KERNEL_CASES]
    batches = [int(v) for v in args.batches.split(',')]
    sizes = ('threads', 'smem', 'w_smem')
    for (what, cell, T, H, all_lens, S), B in (
            (case, B) for case in cases for B in batches):
        if args.shapes and what not in args.shapes.split(','):
            continue
        lens = all_lens[len(all_lens) - B:]
        gi32, w32, b, ln, _ = _train_inputs(cell, T, B, H, lens, H + T, S=S)
        for dtype in (torch.float32, torch.bfloat16):
            gi, w = gi32.to(dtype), w32.to(dtype)
            plan = bt.train_forward_plan(cell, S, B, H, dtype, smem, n_sms)
            # (path, (C, lanes, product, register share) or None)
            variants = [('cooperative', None)]
            shapes = []
            if bt.batch_split_shape(cell, H, dtype, smem) is not None:
                variants.append(('batch_split', None))
            else:
                regs = bt.CL_FMA_REGS if dtype == torch.float32 \
                    else (bt.CL_TC_REG,)
                for c in bt.CL_CLUSTERS:
                    for lanes in bt.CL_LANES:
                        # each register share that fits at the shape's
                        # k-slices, with its own threads and bytes
                        sh = bt.cluster_shape(cell, H, dtype, smem, c, lanes)
                        shapes += [] if sh is None else [
                            dict(sh, reg=r, **dict(zip(sizes, size)))
                            for r in regs
                            if (size := bt._cl_size(
                                n_gates(cell), H, c, lanes, sh['splits'], r,
                                dtype.itemsize)) and size[1] <= smem]
                        if dtype == torch.float32:
                            shapes += [] if (sh := tf32_shape(
                                cell, H, smem, c, lanes)) is None else [
                                dict(sh, reg=r, **dict(zip(sizes, size)))
                                for r in TF32_REGS
                                if (size := tf32_size(
                                    n_gates(cell), H, c, lanes,
                                    sh['splits'], r)) and size[1] <= smem]
                variants += [('cluster', tuple(sh[k] for k in (
                    'cluster', 'lanes', 'product', 'reg'))) for sh in shapes]
            shape_of = {('cluster', tuple(sh[k] for k in (
                'cluster', 'lanes', 'product', 'reg'))): sh for sh in shapes}
            ref = bt.train_forward(cell, gi, w, b, ln, dtype,
                                   path='cooperative')
            rows, runs = {}, {}
            for _ in range(args.rounds):
                for key in variants:
                    if key not in rows:
                        runs[key], rows[key] = _forward_variant(
                            key, shape_of.get(key), plan, what, cell, T, B,
                            S, H, dtype, gi, w, b, ln, n_sms, ref)
                    rows[key]['ms'].append(cuda_ms(runs[key], reps=5))
            for key, row in rows.items():
                row['us_per_step'] = 1e3 * min(row['ms']) / T
                if args.phases:
                    lib = 'birnn_train_tf32' if row.get('product') == \
                        'tf32x3' else 'birnn_train'
                    row['probe_us_per_step'] = phases(
                        lib, TRAIN_PHASES[key[0]], runs[key], 3, T)
                emit(row)


def _forward_variant(key, shape, plan, what, cell, T, B, S, H, dtype, gi, w,
                     b, ln, n_sms, ref):
    """(launch, row) of one variant of `train_forward_paths`: the path
    forced, or the cluster block `shape` launched through
    `launch_forward` (the 3xTF32 one through its own library), with the
    plan's estimate of its step and the card's resident clusters."""
    from forwardtacotron_tpu_torch.kernels import birnn_train as bt
    path, cl = key
    row = {'kernel': 'birnn_train_fwd', 'shape': what, 'cell': cell, 'H': H,
           'T': T, 'B': B, 'S': S, 'dtype': str(dtype)[6:], 'path': path,
           'planned': plan['path'] == path and (cl is None or cl == tuple(
               plan[k] for k in ('cluster', 'lanes', 'product', 'reg'))),
           'ms': []}
    if cl is None:
        def run():
            return bt.train_forward(cell, gi, w, b, ln, dtype, path=path)
    else:
        clusters = S * -(-B // shape['lanes'])
        shape = dict(shape, path='cluster', clusters=clusters,
                     waves=-(-clusters // resident_clusters(shape['cluster'],
                                                            n_sms)))
        shape['step_us'] = None if shape['product'] == 'tf32x3' else \
            bt.cl_step_estimate_us(cell, H, dtype, shape)
        row.update({k: shape[k] for k in (
            'cluster', 'lanes', 'product', 'splits', 'reg', 'threads',
            'smem', 'w_smem', 'waves', 'step_us')})
        if shape['product'] == 'tf32x3':
            row['resident_clusters'] = tf32_forward(shape, cell, gi, w, b,
                                                    ln, True)

            def run():
                return tf32_forward(shape, cell, gi, w, b, ln)
        else:
            row['resident_clusters'] = bt.cl_size_on_card(
                cell, H, dtype, shape['cluster'], shape['lanes'],
                shape['splits'], shape['reg'])[2]

            def run():
                return bt.launch_forward(shape, cell, gi, w, b, ln, dtype)
    row['max_abs_err_vs_cooperative'] = max(
        float((got.float() - r.float()).abs().max())
        for got, r in zip(run(), ref))
    return run, row


def fit_step_estimates(path):
    """Least-squares fit of `birnn_train.py`'s cluster step estimate to the
    cluster rows of a probe output (`path`, jsonl): a wave's µs a step
    (us_per_step / waves) = CL_FIXED_US + CL_FIXED_US_PER_LANE x lanes +
    CL_US_PER_MMA x tiles (bf16) or CL_US_PER_FMA[reg] x FMAs (float32) of
    a block. The fixed terms come from the bf16 rows (their lanes vary);
    each float32 register share's rate is then fitted alone. Prints the
    constants and every reading beside its estimate."""
    import numpy as np
    rows = [r for line in Path(path).read_text().splitlines()
            if (r := json.loads(line)).get('kernel') == 'birnn_train_fwd'
            and r.get('path') == 'cluster' and r.get('product') in
            ('mma', 'fma')]

    def work(r):
        block_rows = n_gates(r['cell']) * r['H'] // r['cluster']
        if r['product'] == 'mma':
            return block_rows // 16 * r['lanes'] // 8 * (r['H'] // 16)
        return block_rows * r['H'] * r['lanes']

    def step(r):
        return r['us_per_step'] / r['waves']

    mma = [r for r in rows if r['product'] == 'mma']
    a = np.array([[1.0, r['lanes'], work(r)] for r in mma])
    fixed, per_lane, per_mma = np.linalg.lstsq(
        a, np.array([step(r) for r in mma]), rcond=None)[0]
    per_fma = {}
    for reg in sorted({r['reg'] for r in rows if r['product'] == 'fma'}):
        sel = [r for r in rows if r['product'] == 'fma' and r['reg'] == reg]
        x = np.array([work(r) for r in sel])
        y = np.array([step(r) - fixed - per_lane * r['lanes'] for r in sel])
        per_fma[reg] = float(x @ y / (x @ x))
    fit = {'CL_FIXED_US': float(fixed), 'CL_FIXED_US_PER_LANE':
           float(per_lane), 'CL_US_PER_MMA': float(per_mma),
           'CL_US_PER_FMA': per_fma}
    print(json.dumps({'fit': fit, 'readings': len(rows)}))
    for r in rows:
        est = fit['CL_FIXED_US'] + fit['CL_FIXED_US_PER_LANE'] * r['lanes'] \
            + work(r) * (fit['CL_US_PER_MMA'] if r['product'] == 'mma'
                         else fit['CL_US_PER_FMA'][r['reg']])
        print(json.dumps({k: r[k] for k in (
            'shape', 'B', 'dtype', 'cluster', 'lanes', 'reg', 'waves')}
            | {'us_per_wave_step': step(r), 'fit_us': est}))
    return fit


def tf32_forward(shape, cell, gi, w, b, ln, resident_only=False):
    """(y, stash) of kernel #2's cluster forward in float32 with its
    product on the tensor cores as three TF32 products
    (csrc/birnn_train_tf32.cu, a library of its own) at `shape` (C, lanes,
    k-slices, A tiles in registers); with resident_only, the clusters of
    it the card holds at once instead, launching nothing."""
    import ctypes
    from forwardtacotron_tpu_torch.kernels import _build
    T, B, S, _ = gi.shape
    H = w.shape[-1]
    lib = _build.load('birnn_train_tf32')
    fn = lib.ftt_birnn_train_fwd_cl_tf32
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 \
        + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    y = torch.empty((T, B, S, H), dtype=torch.float32, device=gi.device)
    stash = torch.empty((T, B, S, 5, H), dtype=torch.float32,
                        device=gi.device)
    resident = ctypes.c_int(0)
    _build.check(lib, fn(
        int(cell == 'lstm'), gi.data_ptr(), w.data_ptr(), b.data_ptr(),
        ln.data_ptr(), y.data_ptr(), stash.data_ptr(), T, B, S, H,
        shape['cluster'], shape['lanes'], shape['splits'], shape['reg'],
        ctypes.byref(resident) if resident_only else None,
        torch.cuda.current_stream().cuda_stream), '3xTF32 cluster forward')
    return resident.value if resident_only else (y, stash)


def staged_backward(cell, st, dy, w, ln, dtype, layout_only=False):
    """(dgi, dgh) of kernel #3's cooperative backward as first designed
    (csrc/birnn_train_staged.cu, a library of its own), at the forward's
    units per block; with layout_only, its (units, staging buffers,
    cluster size) instead, launching nothing."""
    import ctypes
    from forwardtacotron_tpu_torch.kernels import _build
    from forwardtacotron_tpu_torch.kernels import birnn_train as bt
    T, B, S, _, H = st.shape
    GH = (4 if cell == 'lstm' else 3) * H
    u = bt.units_per_block(
        S, H, torch.cuda.get_device_properties(0).multi_processor_count)
    lib = _build.load('birnn_train_staged')
    fn = lib.ftt_birnn_train_bwd_staged
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    dgi = torch.empty((T, B, S, GH), dtype=dtype, device='cuda')
    dgh = dgi if cell == 'lstm' else torch.empty_like(dgi)
    xbuf = torch.empty((2, S, B, GH), dtype=dtype, device='cuda')
    layout = (ctypes.c_int * 2)()
    _build.check(lib, fn(
        int(cell == 'lstm'), int(dtype == torch.bfloat16), st.data_ptr(),
        dy.data_ptr(), w.data_ptr(), ln.data_ptr(), dgi.data_ptr(),
        None if cell == 'lstm' else dgh.data_ptr(), xbuf.data_ptr(), T, B,
        S, H, u, layout if layout_only else None,
        torch.cuda.current_stream().cuda_stream), 'staged backward')
    return (u, layout[0], layout[1]) if layout_only else (dgi, dgh)


def train_backward_paths(args):
    from forwardtacotron_tpu_torch.kernels import birnn_train as bt
    B = 32
    props = torch.cuda.get_device_properties(0)
    for what, cell, T, H, lens in TRAIN_KERNEL_CASES:
        gi32, w32, b, ln, dy = _train_inputs(cell, T, B, H, lens, H + T)
        for dtype in (torch.float32, torch.bfloat16):
            gi, w = gi32.to(dtype), w32.to(dtype)
            st = bt.train_forward(cell, gi, w, b, ln, dtype)[1]
            plan = bt.train_backward_plan(
                cell, 2, B, H, dtype, props.shared_memory_per_block_optin,
                props.multi_processor_count)
            paths = [p for p in bt.PATHS
                     if p == 'cooperative' or plan['path'] == p]
            if plan['path'] == 'cooperative':
                paths.append('staged')
            for path in paths:
                row = {'kernel': 'birnn_train_bwd', 'shape': what,
                       'cell': cell, 'H': H, 'T': T, 'B': B,
                       'dtype': str(dtype)[6:], 'path': path,
                       'planned': plan['path'] == path}
                if path == 'staged':
                    def run():
                        return staged_backward(cell, st, dy, w, ln, dtype)
                    row['units'], row['staging_buffers'], row['cluster'] = \
                        staged_backward(cell, st, dy, w, ln, dtype, True)
                    ref = bt.train_backward(cell, st, dy, w, ln, dtype)
                    row['max_abs_err_vs_cooperative'] = max(
                        float((got.float() - r.float()).abs().max())
                        for got, r in zip(run(), ref))
                else:
                    def run():
                        return bt.train_backward(cell, st, dy, w, ln, dtype,
                                                 path=path)
                row['ms'] = cuda_ms(run, reps=5)
                row['us_per_step'] = 1e3 * row['ms'] / T
                if args.phases:
                    lib = 'birnn_train_staged' if path == 'staged' \
                        else 'birnn_train'
                    row['probe_us_per_step'] = phases(
                        lib, TRAIN_BWD_PHASES[path], run, 3, T)
                emit(row)


def grads_vs_cpu(args):
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in range(args.seeds):
        torch.manual_seed(seed)
        model = ForwardTacotron.from_config(default_config()).cuda()
        emit({'kernel': 'grads', 'seed': seed,
              **_card_cpu_grads(model, _grads_batch(3 + seed))})


def ptxas_registers(report, name):
    """{kernel: 'Used N registers, ...; N bytes stack frame, N bytes spill
    stores, N bytes spill loads'} of the ptxas -v lines in `report` for
    the entry functions whose names contain `name`."""
    out, func = {}, None
    for line in report.splitlines():
        if 'Compiling entry function' in line:
            func = line.split("'")[1]
        elif func and name in func and 'registers' in line:
            out[func] = line.split(':', 1)[1].strip() + out.get(func, '')
        elif func and name in func and 'spill' in line:
            out[func] = '; ' + line.strip()
    return out


def mma_recurrence(cell, gi, w, b, ln, cluster, layout_only=False):
    """y of kernel #1's stream-local path with its product on the tensor
    cores (csrc/birnn_sl_mma.cu, a library of its own; bf16) in clusters
    of `cluster`; with layout_only, its (k-slices, threads, shared-memory
    bytes, resident clusters) instead, launching nothing (k-slices 0: no
    block fits)."""
    import ctypes
    from forwardtacotron_tpu_torch.kernels import _build
    T, B, S, _ = gi.shape
    H = w.shape[-1]
    lib = _build.load('birnn_sl_mma')
    fn = lib.ftt_birnn_sl_mma_launch
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    y = torch.empty((T, B, S, H), dtype=torch.float32, device=gi.device)
    layout = (ctypes.c_longlong * 4)()
    _build.check(lib, fn(
        int(cell == 'lstm'), gi.data_ptr(), w.data_ptr(), b.data_ptr(),
        ln.data_ptr(), y.data_ptr(), T, B, S, H, cluster,
        layout if layout_only else None,
        torch.cuda.current_stream().cuda_stream), 'mma stream-local')
    return tuple(layout) if layout_only else y


def birnn_ptxas(names, kernel='birnn'):
    """Rebuild the named libraries and emit the `-Xptxas -v` registers and
    spills of their entry functions whose names contain `kernel`."""
    from forwardtacotron_tpu_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in names:
        lib_path = _build._lib_path(name)
        if lib_path.exists():
            lib_path.unlink()           # rebuild, for the ptxas report
    for name, report in _build.build(names).items():
        emit({'kernel': name, 'ptxas': ptxas_registers(report, kernel)})


def birnn_variants(args, what, cell, S, T, H, B, dtype, lens, variants):
    """Kernel #1 on the same inputs in each of `variants` ((path, cluster,
    product), product 'fma' or 'mma'), `--rounds` turns; each row with the
    clusters resident at once and its largest difference from the planned
    path; with `--phases`, by phase."""
    from forwardtacotron_tpu_torch.kernels import birnn as kb
    from chip_smoke import _birnn_bound, _birnn_inputs, _cudnn_ms
    props = torch.cuda.get_device_properties(0)
    smem, n_sms = props.shared_memory_per_block_optin, \
        props.multi_processor_count
    gi, w, b, ln = _birnn_inputs(cell, T, B, S, H, dtype, seed=T + H,
                                 lens=lens)
    plan = kb.inference_plan(cell, S, B, H, dtype, smem, n_sms)
    ref = kb.recurrence(cell, gi, w, b, ln, dtype)

    def runner(path, c, product):
        if product == 'mma':
            return lambda: mma_recurrence(cell, gi, w, b, ln, c)
        return lambda: kb.recurrence(cell, gi, w, b, ln, dtype, path=path,
                                     cluster=c)
    rows = {}
    for rnd in range(args.rounds):
        for path, c, product in variants:
            run = runner(path, c, product)
            row = rows.setdefault((path, c, product), {
                'kernel': 'birnn', 'shape': what, 'cell': cell, 'S': S,
                'T': T, 'H': H, 'B': B, 'dtype': str(dtype)[6:],
                'path': path, 'cluster': c, 'product': product, 'ms': [],
                'planned': plan['path'] == path and product != 'mma'
                and plan.get('cluster') == c})
            if rnd == 0 and path == 'stream_local':
                if product == 'mma':
                    row['splits'], row['threads'], row['smem'], \
                        row['resident_clusters'] = mma_recurrence(
                            cell, gi, w, b, ln, c, layout_only=True)
                else:
                    shape = kb.stream_local_shape(cell, H, dtype, smem, c)
                    row.update({k: shape[k] for k in (
                        'splits', 'threads', 'smem', 'w_smem')})
                    row['resident_clusters'] = kb.sl_size_on_card(
                        cell, H, dtype, c, shape['splits'])[2]
                row['waves'] = -(-S * B // max(row['resident_clusters'], 1))
                row['max_abs_err_vs_planned'] = float(
                    (run() - ref).abs().max())
            row['ms'].append(cuda_ms(run, reps=5))
    bound = _birnn_bound(cell, gi, w, b, ln, H)
    library = _cudnn_ms(cell, T, H, S, B, dtype)
    for (path, c, product), row in rows.items():
        row['us_per_step'] = 1e3 * min(row['ms']) / T
        row['bound_ms'], row['bound_by'] = bound
        row['library_ms'] = library
        if args.phases:
            row['probe_us_per_step'] = phases(
                'birnn_sl_mma' if product == 'mma' else 'birnn',
                BIRNN_PHASES[path], runner(path, c, product), 3, T)
    return plan, rows


def inference_birnn(args):
    """Kernel #1 at the serving shapes, batch 1, in each of `--dtypes`:
    the stream-local path at every cluster size that fits, with the
    product on the CUDA cores and (bf16) on the tensor cores, and the
    cooperative path, in turns on the same inputs, with the host µs of a
    launch of the planned and the cooperative path."""
    from forwardtacotron_tpu_torch.kernels import birnn as kb
    from chip_smoke import SERVING_BIRNN_CASES, _birnn_inputs
    birnn_ptxas(['birnn', 'birnn_sl_mma'])
    smem = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    for dtype in (getattr(torch, d) for d in args.dtypes.split(',')):
        for what, cell, S, T, H in SERVING_BIRNN_CASES:
            variants = [('stream_local', c, 'fma') for c in kb.SL_CLUSTERS
                        if kb.stream_local_shape(cell, H, dtype, smem, c)]
            if dtype == torch.bfloat16:
                variants += [('stream_local', c, 'mma')
                             for c in kb.SL_CLUSTERS
                             if mma_recurrence(cell, *_birnn_inputs(
                                 cell, 1, 1, S, H, dtype, 0, [1]), c,
                                 layout_only=True)[0]]
            variants.append(('cooperative', None, 'fma'))
            plan, rows = birnn_variants(args, what, cell, S, T, H, 1, dtype,
                                        [T], variants)
            # host µs a launch, over launches of 4 steps (device time small)
            short = _birnn_inputs(cell, 4, 1, S, H, dtype, seed=H, lens=[4])
            for path, c in ((plan['path'], plan.get('cluster')),
                            ('cooperative', None)):
                rows[(path, c, 'fma')]['host_us_per_launch'] = host_us(
                    lambda: kb.recurrence(cell, *short, dtype, path=path,
                                          cluster=c))
            for row in rows.values():
                emit(row)


def evaluate_birnn(args):
    """Kernel #1 at the five shapes that evaluate() gives it (B=32,
    float32, `chip_smoke.EVAL_BIRNN_CASES`): the stream-local path at every
    cluster size that fits, its S*B clusters in waves where the card holds
    fewer at once, and the cooperative path, in turns on the same
    inputs."""
    from forwardtacotron_tpu_torch.kernels import birnn as kb
    from chip_smoke import EVAL_BIRNN_CASES
    smem = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    f32 = torch.float32
    for what, cell, T, H, lens in EVAL_BIRNN_CASES:
        variants = [('stream_local', c, 'fma') for c in kb.SL_CLUSTERS
                    if kb.stream_local_shape(cell, H, f32, smem, c)]
        variants.append(('cooperative', None, 'fma'))
        for row in birnn_variants(args, what, cell, 2, T, H, 32, f32,
                                  list(lens), variants)[1].values():
            emit(row)


def dispatch(args):
    """Host µs a call of #1 and #4: the op, the wrapper and the direct
    launch (the module docstring)."""
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.kernels import birnn as kb
    from forwardtacotron_tpu_torch.kernels import wavernn_sample as ws
    from forwardtacotron_tpu_torch.models.wavernn import WaveRNN
    from chip_smoke import SERVING_BIRNN_CASES, _birnn_inputs

    def turns(row, ways):
        for _ in range(args.rounds):
            for name, fn in ways.items():
                row.setdefault(f'host_us_{name}', []).append(host_us(fn))
        emit(row)
    for dtype in (getattr(torch, d) for d in args.dtypes.split(',')):
        for what, cell, S, _, H in SERVING_BIRNN_CASES:
            short = _birnn_inputs(cell, 4, 1, S, H, dtype, seed=H, lens=[4])
            turns({'kernel': 'birnn', 'case': what, 'dtype': str(dtype)[6:],
                   'steps': 4},
                  {'op': lambda: torch.ops.ftt.birnn_recurrence(
                      cell, *short, dtype),
                   'wrapper': lambda: kb.recurrence(cell, *short, dtype),
                   'direct': lambda: kb.launch(cell, *short, dtype)})
    torch.manual_seed(0)
    model = WaveRNN.from_config(default_config()).cuda()
    bf16 = torch.bfloat16
    w = ws.pack_weights(model, bf16)
    cond = (torch.randn((4, 8, model.feat_dims + 4 * model.aux_dims),
                        device='cuda') * 0.5).to(bf16)
    seed = ws.seed_tensor(0, 'cuda')
    turns({'kernel': 'wavernn_sample', 'lanes': 8, 'dtype': 'bfloat16',
           'steps': 4},
          {'op': lambda: torch.ops.ftt.wavernn_sample(
              cond, [w[k] for k in ws.WEIGHT_KEYS], seed, 0, False, bf16),
           'wrapper_int_seed': lambda: ws.sample(cond, w, 0, 0, False,
                                                 bf16),
           'wrapper': lambda: ws.sample(cond, w, seed, 0, False, bf16),
           'direct': lambda: ws.launch(cond, w, seed, 0, False, bf16)})


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument('--steps', type=int, default=400)
    parser.add_argument('--lanes', default='1,8,64,128')
    parser.add_argument('--only', default='train,train_bwd,sampler,birnn',
                        help='kernels to probe, of train (#2), train_bwd '
                             '(#3), sampler, birnn, birnn_eval, grads, '
                             'dispatch')
    parser.add_argument('--rounds', type=int, default=2,
                        help='turns of the birnn sections\' variants')
    parser.add_argument('--dtypes', default='bfloat16',
                        help='compute types of the birnn section')
    parser.add_argument('--seeds', type=int, default=6,
                        help='random models of the grads section')
    parser.add_argument('--phases', action='store_true',
                        help='also run the probe build and print per-phase '
                             'times')
    parser.add_argument('--batches', default='32',
                        help='batches of the train section')
    parser.add_argument('--shapes', default='',
                        help='shapes of the train section (all if empty), '
                             'of decoder, postnet, prenet, pitch, '
                             'dur/energy, wavernn GRU')
    parser.add_argument('--fit', metavar='JSONL',
                        help='fit the cluster path\'s step estimate to the '
                             'rows of a probe output and exit (no card '
                             'needed)')
    args = parser.parse_args()
    if args.fit:
        fit_step_estimates(args.fit)
        return
    if not torch.cuda.is_available():
        sys.exit('needs a CUDA device')
    OUT.parent.mkdir(exist_ok=True)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    emit({'nvidia_smi': smi, 'torch': torch.__version__})
    only = args.only.split(',')
    if 'train' in only:
        train_forward_paths(args)
    if 'train_bwd' in only:
        train_backward_paths(args)
    if 'sampler' in only:
        sampler(args)
    if 'birnn' in only:
        inference_birnn(args)
    if 'birnn_eval' in only:
        evaluate_birnn(args)
    if 'grads' in only:
        grads_vs_cpu(args)
    if 'dispatch' in only:
        dispatch(args)


if __name__ == '__main__':
    main()
