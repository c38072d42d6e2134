"""Per-step and per-phase cost of the port's CUDA kernels on the card.

    python tools/torch_kernel_probe.py [--steps 400] [--lanes 1,8,64,128]
                                       [--phases] [--only train,sampler,birnn]

Times, with CUDA events:
- the WaveRNN sampling kernel (#4) at full width (rnn_dims = fc_dims =
  512, RAW 9 bits) for each fold-lane count of `--lanes`, greedy and
  sampled, in bfloat16 and float32;
- the BiRNN training forward (#2) at the shapes of the training step's
  series predictors and prenet (GRU H=64/128/256, T=192, B=32, float32
  and bfloat16) on each of its paths, beside the path that
  `train_forward_plan` picks;
- the BiRNN inference kernel (#1), decoder LSTM H=512, at batch 1 and 8.

With `--phases`, it also loads the probe build (`-DFTT_PROBE`) and
prints where a step's time goes, from thread 0 of block 0: kernel #2 at
the same shapes on each path, and the sampler in bfloat16 at 1, 64 and
72 lanes (of those in `--lanes`).

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

from chip_smoke import OUT_DIR  # noqa: E402

OUT = OUT_DIR / 'kernel_probe.jsonl'
TRAIN_SHAPES = (('dur/energy', 64), ('pitch', 128), ('prenet', 256))
TRAIN_PHASES = {'cooperative': ('stage h', 'product', 'reduce',
                                'gate update', 'grid barrier'),
                'batch_split': ('product', 'product wait', 'gate sums',
                                'gate math, stash stores', 'stores',
                                'update wait')}
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
    parser.add_argument('--only', default='train,sampler,birnn',
                        help='kernels to probe, of train,sampler,birnn')
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
    if 'sampler' in only:
        sampler(args)
    if 'birnn' in only:
        inference_birnn()


if __name__ == '__main__':
    main()
