"""Text-to-mel time of one long utterance with the port in the working
directory, on one card.

    python3 tools/ab_utterance.py [--rounds 4] [--paths]

Imports `forwardtacotron_tpu_torch` from the working directory and builds
ForwardTacotron at the full width of config.yaml with random weights
(seed 0). The utterance is the last line of sentences.txt (115 phonemes)
decoded at 8 frames per phoneme (920 frames, bucket 1024, batch 1, bf16),
as `chip_smoke.py` phase 5 does. After two warm-up passes, each round
prints one JSON line: the median over 5 passes of the series and decode
ms (CUDA events) and of the host ms of a whole pass (ending in a
synchronize). A last line gives one pass under the profiler: the device's
busy ms (the union of its kernels' intervals, as `chip_smoke.profiled`
takes it), the pass's host ms and the device's idle share of it, and the
kernels of most device time.

Run from two checkouts in turns, one process each (parent, change,
change, parent), it compares them on one card:

    for d in PARENT . . PARENT; do
      (cd $d && python3 $OLDPWD/tools/ab_utterance.py); done

With `--paths` each round also runs the passes with every launch of
kernel #1 forced onto its cooperative path (`recurrence(...,
path='cooperative')`).

Prints the card's name and power limit first. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path


def forced_cooperative(kb):
    """`kb.recurrence` with `path='cooperative'`, sharing its counters."""
    planned = kb.recurrence

    def recurrence(*args, **kw):
        return planned(*args, path='cooperative', **kw)
    recurrence.launches = planned.launches
    recurrence.path_launches = planned.path_launches
    return recurrence


def main() -> None:
    parser = argparse.ArgumentParser(
        description=__doc__.split('\n\n')[0])
    parser.add_argument('--rounds', type=int, default=4)
    parser.add_argument('--paths', action='store_true',
                        help='also time kernel #1 forced onto its '
                             'cooperative path, in turns')
    args = parser.parse_args()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)

    import torch
    if not torch.cuda.is_available():
        sys.exit('needs a CUDA device')
    sys.path.insert(0, os.getcwd())
    from forwardtacotron_tpu_torch import gen_forward
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.kernels import birnn as kb

    cfg = default_config()
    model, cfg, _ = gen_forward.load_tts(None, cfg, 'cuda', 0)
    text = [s for s in Path('sentences.txt').read_text().splitlines()
            if s.strip()][-1]
    ids = gen_forward.text_to_ids(text, cfg)
    x = torch.tensor([ids], device='cuda')
    xl = torch.tensor([len(ids)], device='cuda')
    max_t = ((8 * len(ids) + 1 + 255) // 256) * 256

    def utterance():
        """(series ms, decode ms, host ms) of one pass."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        t0 = time.perf_counter()
        ev[0].record()
        series = model.predict_series(x, x_len=xl)
        ev[1].record()
        dur = torch.full_like(series['dur'], 8.0)
        model.generate_from_series(x, dur, series['pitch'],
                                   series['energy'], max_t, x_len=xl)
        ev[2].record()
        ev[2].synchronize()
        return (ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
                (time.perf_counter() - t0) * 1e3)

    planned = kb.recurrence
    variants = [('planned', planned)]
    if args.paths:
        variants.append(('cooperative', forced_cooperative(kb)))
    with torch.no_grad():
        for _, fn in variants:
            kb.recurrence = fn
            for _ in range(2):
                utterance()
        for rnd in range(args.rounds):
            for name, fn in variants:
                kb.recurrence = fn
                passes = [utterance() for _ in range(5)]
                series, decode, host = (
                    statistics.median(p[i] for p in passes) for i in range(3))
                print(json.dumps({'round': rnd, 'kernel_1': name,
                                  'ids': len(ids), 'bucket': max_t,
                                  'series_ms': series, 'decode_ms': decode,
                                  'host_ms': host, 'cwd': os.getcwd()}),
                      flush=True)
        kb.recurrence = planned
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            host = utterance()[2]
    # chip_smoke.py beside this tool, whatever checkout is being timed
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_helpers', Path(__file__).resolve().parents[1]
        / 'chip_smoke.py')
    helpers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helpers)
    print(json.dumps({'profiled': True, 'host_ms': host,
                      **helpers.profiled(prof, host, top=8)}), flush=True)


if __name__ == '__main__':
    main()
