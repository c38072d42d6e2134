"""Per-step and per-phase cost of the port's CUDA kernels on the card.

    python tools/torch_kernel_probe.py [--steps 400] [--lanes 1,8,64,128]
                                       [--phases] [--seeds 6]
                                       [--only train,train_bwd,sampler,birnn,grads]

Times, with CUDA events:
- the WaveRNN sampling kernel (#4) at full width (rnn_dims = fc_dims =
  512, RAW 9 bits) for each fold-lane count of `--lanes`, greedy and
  sampled, in bfloat16 and float32;
- the BiRNN training forward (#2) at the shapes of the training step's
  series predictors and prenet (GRU H=64/128/256, T=192, B=32, float32
  and bfloat16) on each of its paths, beside the path that
  `train_forward_plan` picks;
- the BiRNN training backward (#3) at the five shapes of the training
  step (`chip_smoke.TRAIN_KERNEL_CASES`, B=32: decoder LSTM H=512
  T=1024, postnet GRU H=256 T=1024, prenet GRU H=256 T=192, predictor
  GRUs H=128/64 T=192; float32 and bfloat16) on the cooperative path and,
  where `train_backward_plan` picks it, the batch-split path; and, where
  the cooperative path is planned, the cooperative backward as first
  designed (`csrc/birnn_train_staged.cu`: the exchange staged by bulk
  copies multicast within clusters) on the same inputs, with its staging
  buffers, cluster size and largest difference from the shipped path;
- the BiRNN inference kernel (#1), decoder LSTM H=512, at batch 1 and 8;
- with `--only grads` (not run by default): the float32 gradients of the
  full-width model on chip_smoke's two-item batch, card against CPU, for
  `--seeds` random models, once with kernels #2/#3 and once with their
  plain versions run on the card. The plain versions are the same
  algorithm with other rounding, so this tells an error the kernels
  cause from one the model's ReLUs amplify (a pre-activation near zero
  that rounds to the other side moves a gradient by a whole term).

With `--phases`, it also loads the probe build (`-DFTT_PROBE`) and
prints where a step's time goes, from thread 0 of block 0: kernels #2 and
#3 at the same shapes on each path, and the sampler in bfloat16 at 1, 64
and 72 lanes (of those in `--lanes`).

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

from chip_smoke import (OUT_DIR, TRAIN_KERNEL_CASES,  # noqa: E402
                        _grad_errors, _grads_batch, _model_grads,
                        _train_inputs)

OUT = OUT_DIR / 'kernel_probe.jsonl'
TRAIN_SHAPES = (('dur/energy', 64), ('pitch', 128), ('prenet', 256))
TRAIN_PHASES = {'cooperative': ('stage h', 'product', 'reduce',
                                'gate update', 'grid barrier'),
                'batch_split': ('product', 'product wait', 'gate sums',
                                'gate math, stash stores', 'stores',
                                'update wait')}
TRAIN_BWD_PHASES = {'cooperative': ('gate gradients', 'partial products',
                                    'grid barrier', 'partial sums'),
                    'batch_split': ('input wait', 'gate gradients',
                                    'product', 'slice sums'),
                    'staged': ('gate gradients', 'grid barrier', 'copy wait',
                               'product', 'combine',
                               'cluster barrier, next copy')}
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
    for dtype in (torch.bfloat16, torch.float32):
        w = ws.pack_weights(model, dtype)
        for lanes in (int(v) for v in args.lanes.split(',')):
            cond = (torch.randn((args.steps, lanes, C), device='cuda')
                    * 0.5).to(dtype)
            for greedy in (True, False):
                ms = cuda_ms(lambda: ws.sample(cond, w, 0, 0, greedy, dtype))
                emit({'kernel': 'wavernn_sample', 'dtype': str(dtype)[6:],
                      'lanes': lanes, 'greedy': greedy, 'steps': args.steps,
                      'ms': ms, 'us_per_step': 1e3 * ms / args.steps})
            if (args.phases and lanes in (1, 64, 72)
                    and dtype == torch.bfloat16):
                emit({'kernel': 'wavernn_sample', 'probe_us_per_step': phases(
                    'wavernn_sample', SAMPLER_PHASES,
                    lambda: ws.sample(cond, w, 0, 0, False, dtype), 2,
                    args.steps), 'dtype': 'bfloat16', 'lanes': lanes})


def train_forward_paths(args):
    from forwardtacotron_tpu_torch.kernels import birnn_train as bt
    T, B = 192, 32
    props = torch.cuda.get_device_properties(0)
    for what, H in TRAIN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device='cuda').manual_seed(H)
            gi = torch.randn((T, B, 2, 3 * H), device='cuda',
                             generator=g).to(dtype)
            w = ((torch.rand((2, 3 * H, H), device='cuda', generator=g)
                  * 2 - 1) / H ** 0.5).to(dtype)
            b = torch.zeros((2, 3 * H), device='cuda')
            ln = torch.tensor([T - 5 * i for i in range(B)], device='cuda',
                              dtype=torch.int32)
            smem = props.shared_memory_per_block_optin
            plan = bt.train_forward_plan('gru', 2, B, H, dtype, smem,
                                         props.multi_processor_count)
            for path in bt.PATHS:
                if path == 'batch_split' and bt.batch_split_shape(
                        'gru', H, dtype, smem) is None:
                    continue
                def run():
                    bt.train_forward('gru', gi, w, b, ln, dtype, path=path)
                row = {'kernel': 'birnn_train_fwd', 'shape': what,
                       'cell': 'gru', 'H': H, 'T': T, 'B': B,
                       'dtype': str(dtype)[6:], 'path': path,
                       'planned': plan['path'] == path,
                       'ms': cuda_ms(run, reps=5)}
                row['us_per_step'] = 1e3 * row['ms'] / T
                if args.phases:
                    row['probe_us_per_step'] = phases(
                        'birnn_train', TRAIN_PHASES[path], run, 3, T)
                emit(row)


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
    from forwardtacotron_tpu_torch.kernels import birnn_train as bt
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.ops import rnn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = bt.train_forward, bt.train_backward
    plain = (lambda cell, gi, w, b, ln, dt: rnn.birnn_train_forward(
                 cell, gi, w, b, ln, dt),
             lambda cell, st, dy, w, ln, dt: rnn.birnn_train_backward(
                 cell, st, dy, w, ln, dt))

    def worst(got, ref):
        l2, peak = _grad_errors(got, ref)
        k2, kp = max(l2, key=l2.get), max(peak, key=peak.get)
        return {'rel_l2': l2[k2], 'param_l2': k2, 'rel_max': peak[kp],
                'param_max': kp}

    for seed in range(args.seeds):
        torch.manual_seed(seed)
        model = ForwardTacotron.from_config(default_config()).cuda()
        batch = _grads_batch(3 + seed)
        grads = {'cpu': _model_grads(model, batch, 'cpu')}
        for name, (fwd, bwd) in (('kernels', kernels), ('plain', plain)):
            bt.train_forward, bt.train_backward = fwd, bwd
            try:
                grads[name] = _model_grads(model, batch, 'cuda')
            finally:
                bt.train_forward, bt.train_backward = kernels
        emit({'kernel': 'grads', 'seed': seed,
              'kernels_vs_cpu': worst(grads['kernels'], grads['cpu']),
              'plain_on_card_vs_cpu': worst(grads['plain'], grads['cpu']),
              'kernels_vs_plain_on_card': worst(grads['kernels'],
                                                grads['plain'])})


def inference_birnn():
    from forwardtacotron_tpu_torch.kernels.birnn import recurrence
    H, T = 512, 1024
    for dtype in (torch.bfloat16, torch.float32):
        for B in (1, 8):
            gi = torch.randn((T, B, 2, 4 * H), device='cuda').to(dtype)
            wh = (torch.rand((2, 4 * H, H), device='cuda') * 0.08
                  - 0.04).to(dtype)
            b = torch.zeros((2, 4 * H), device='cuda')
            ln = torch.full((B,), T, dtype=torch.int32, device='cuda')
            ms = cuda_ms(lambda: recurrence('lstm', gi, wh, b, ln, dtype))
            emit({'kernel': 'birnn', 'cell': 'lstm', 'H': H, 'T': T, 'B': B,
                  'dtype': str(dtype)[6:], 'ms': ms,
                  'us_per_step': 1e3 * ms / T})


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument('--steps', type=int, default=400)
    parser.add_argument('--lanes', default='1,8,64,128')
    parser.add_argument('--only', default='train,train_bwd,sampler,birnn',
                        help='kernels to probe, of train (#2), train_bwd '
                             '(#3), sampler, birnn, grads')
    parser.add_argument('--seeds', type=int, default=6,
                        help='random models of the grads section')
    parser.add_argument('--phases', action='store_true',
                        help='also run the probe build and print per-phase '
                             'times')
    args = parser.parse_args()
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
        inference_birnn()
    if 'grads' in only:
        grads_vs_cpu(args)


if __name__ == '__main__':
    main()
