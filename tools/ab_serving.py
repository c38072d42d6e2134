"""benchmark_serving's load with its launch count on and off, and with
cuDNN's TF32 off and on, in turns, in one process on one card.

    python3 tools/ab_serving.py [--rounds 2] [--requests 4,24] [--fused]

Writes chip_smoke phase 18's seeded files at the full width of
config.yaml (ForwardTacotron seed 0 as `.pt`, HiFi-GAN V1 in the official
layout: `chip_smoke._tool_files`) to model_outputs/ab_serving/
(git-ignored, removed after). Each round runs
`forwardtacotron_tpu_torch.tools.benchmark_serving.main` (a new staged
server a run, warmed as the tool warms it) at 8 clients x each of
`--requests` per client with `torch.backends.cudnn.allow_tf32` False (as
chip_smoke.py sets it) and then True (PyTorch's default, which the tool
and `serve_forward` leave as it is), each first counting the kernels'
launches (`--count-launches`: a CUDA-activity profiler over the timed
window) and then without it. Prints the card's name and power limit, then one
JSON line a run (`round`, `requests`, `cudnn_tf32`, `launch_count` and
the tool's line); the lines also go to chiprun_out/ab_serving.jsonl.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import itertools
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--rounds', type=int, default=2)
    parser.add_argument('--requests', default='4,24',
                        help='requests a client, comma-separated')
    parser.add_argument('--fused', action='store_true')
    args = parser.parse_args()

    import torch
    import chip_smoke
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.tools import benchmark_serving
    smi = chip_smoke.nvidia_smi_line()
    print(smi, flush=True)
    base = (ROOT / 'model_outputs' / 'ab_serving').resolve()
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    out = ROOT / 'chiprun_out'
    out.mkdir(exist_ok=True)
    try:
        files = chip_smoke._tool_files(default_config(), base)
        with open(out / 'ab_serving.jsonl', 'w') as log:
            for rnd, requests, tf32, count in itertools.product(
                    range(args.rounds), args.requests.split(','),
                    (False, True), (True, False)):
                torch.backends.cudnn.allow_tf32 = tf32
                argv = ['--checkpoint', str(files['tts']), '--vocoder',
                        'hifigan', '--voc_checkpoint', str(files['hifigan']),
                        '--clients', '8', '--requests', requests,
                        '--device', 'cuda']
                argv += ['--fused'] * args.fused
                argv += ['--count-launches'] if count else []
                with contextlib.redirect_stdout(io.StringIO()):
                    res = benchmark_serving.main(argv)
                row = json.dumps({'round': rnd, 'requests': int(requests),
                                  'cudnn_tf32': tf32, 'launch_count': count,
                                  'nvidia_smi': smi, **res})
                print(row, flush=True)
                log.write(row + '\n')
    finally:
        shutil.rmtree(base, ignore_errors=True)


if __name__ == '__main__':
    main()
