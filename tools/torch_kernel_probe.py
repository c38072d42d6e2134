"""Per-step cost of the port's CUDA kernels against their lane count.

    python tools/torch_kernel_probe.py [--steps 400]

Times the WaveRNN sampling kernel at full width (rnn_dims = fc_dims =
512, RAW 9 bits) for several fold-lane counts, greedy and sampled, in
bfloat16 and float32, and the BiRNN kernel (decoder LSTM, H=512) at
batch 1 and 8, with CUDA events. Prints one JSON object per line and
the card's name and power limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


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


def main() -> None:
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.kernels import wavernn_sample as ws
    from forwardtacotron_tpu_torch.kernels.birnn import recurrence
    from forwardtacotron_tpu_torch.models.wavernn import WaveRNN
    parser = argparse.ArgumentParser()
    parser.add_argument('--steps', type=int, default=400)
    parser.add_argument('--lanes', default='1,8,32,64,128')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit('needs a CUDA device')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
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
                print(json.dumps({'kernel': 'wavernn_sample',
                                  'dtype': str(dtype)[6:], 'lanes': lanes,
                                  'greedy': greedy, 'steps': args.steps,
                                  'ms': ms,
                                  'us_per_step': 1e3 * ms / args.steps}),
                      flush=True)
    H, T = 512, 1024
    for dtype in (torch.bfloat16, torch.float32):
        for B in (1, 8):
            gi = torch.randn((T, B, 2, 4 * H), device='cuda').to(dtype)
            wh = (torch.rand((2, 4 * H, H), device='cuda') * 0.08
                  - 0.04).to(dtype)
            b = torch.zeros((2, 4 * H), device='cuda')
            ln = torch.full((B,), T, dtype=torch.int32, device='cuda')
            ms = cuda_ms(lambda: recurrence('lstm', gi, wh, b, ln, dtype))
            print(json.dumps({'kernel': 'birnn', 'cell': 'lstm', 'H': H,
                              'T': T, 'B': B, 'dtype': str(dtype)[6:],
                              'ms': ms, 'us_per_step': 1e3 * ms / T}),
                  flush=True)


if __name__ == '__main__':
    main()
