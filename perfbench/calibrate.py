#!/usr/bin/env python3
"""Readings from which a cell's limits and rate were set (not run by the
benchmark's own runs).

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 8] [--control] [--faults]
    python3 perfbench/calibrate.py --workload <cell> --sweep 30,40,50 \\
        [--seconds 20]

For each seed, in one process: the program's reading of every number the
cell compares (set-up and, for serving, a short window at the cell's
load, then the check); with --control the control's, the reference
computed in bfloat16 in the program's place; with --faults the planted
faults' (training: half of each checked batch left out, the mean taken
over the rest; serving: one sample of a served answer altered). --sweep
serves each offered rate for --seconds and prints what the load did:
requests answered in time, latency percentiles and the generator's
lateness. One JSON line a reading on standard output.
"""
import argparse
import json
import random
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _emit(row) -> None:
    print(json.dumps(row), flush=True)


def train_readings(cfg, traffic, seed, control, faults):
    import torch
    from perfbench.harness.train_steps import TrainCell
    cell = TrainCell(cfg, traffic, seed)
    try:
        t0 = time.perf_counter()
        cell.setup()
        cell.release()
        t1 = time.perf_counter()
        ref = cell.reference_run()
        t2 = time.perf_counter()
        rows = [dict(cell.compare(cell.program, ref), who='program',
                     setup_s=t1 - t0, reference_s=t2 - t1,
                     setup_parts=cell.setup_parts,
                     losses=cell.program['losses'],
                     ref_losses=ref['losses'])]
        if control:
            rows.append(dict(cell.compare(
                cell.reference_run(dt=torch.bfloat16), ref), who='control'))
        if faults:
            rows.append(dict(cell.compare(cell.reference_run(halve=True),
                                          ref), who='half_batch'))
        return rows
    finally:
        cell.cleanup()


def serve_readings(cfg, traffic, seed, seconds, workload, control, faults):
    import numpy as np
    import torch
    from perfbench.harness.poisson_open import ServeCell
    cell = ServeCell(cfg, traffic, seed)
    try:
        cell.setup(seconds)
        e2e = cell.window(seconds)
        cell.release()
        sample = cell.sample(int(workload['check_requests']))
        got = [r.pcm for r in sample]
        ref = cell.reference_pcm(sample)
        rows = [dict(cell.compare(got, ref), who='program',
                     unanswered=cell.unanswered(), notes=cell.notes(),
                     **e2e)]
        if control:
            rows.append(dict(cell.compare(
                cell.reference_pcm(sample, torch.bfloat16), ref),
                who='control'))
        if faults:
            rng = random.Random(seed)
            bad = [g.copy() for g in got]
            i = rng.randrange(len(bad))
            j = rng.randrange(len(bad[i]))
            bad[i][j] = np.int16(-1 - int(bad[i][j]))
            rows.append(dict(cell.compare(bad, ref), who='altered_sample'))
        return rows
    finally:
        cell.cleanup()


def sweep(cfg, traffic, rates, seconds, seed):
    from perfbench.harness.poisson_open import ServeCell
    for rate in rates:
        cell = ServeCell(cfg, dict(traffic, rate_per_s=rate), seed)
        try:
            cell.setup(seconds)
            e2e = cell.window(seconds)
            ctx = cell.context()
            cell.release()
            sizes = ctx['batch_sizes']
            lat = sorted(cell.latencies)
            _emit({'rate_per_s': rate, **e2e, **cell.counts(),
                   'p50_s': lat[len(lat) // 2],
                   'lateness': cell.lateness,
                   'mean_batch': sum(sizes) / max(len(sizes), 1),
                   'queue_after': ctx['queue_depth'],
                   'shed': sum(r.shed for r in cell.requests)})
        finally:
            cell.cleanup()


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', default='1')
    p.add_argument('--seconds', type=float, default=8.0)
    p.add_argument('--control', action='store_true')
    p.add_argument('--faults', action='store_true')
    p.add_argument('--sweep', default='')
    p.add_argument('--no-tf32', action='store_true',
                   help='cuDNN without TF32 in the program too (a look at '
                        'what TF32 alone moves)')
    args = p.parse_args()
    if args.no_tf32:
        import torch
        torch.backends.cudnn.allow_tf32 = False
    from perfbench.harness import common
    from perfbench.run import cell_inputs
    common.set_cache_dirs()
    _, cell, cfg, traffic, workload = cell_inputs(args.workload)
    common.require_cards(int(cell['chips']))
    _emit({'card': common.nvidia_smi_line(), 'workload': args.workload})
    seeds = [int(s) for s in args.seeds.split(',')]
    if args.sweep:
        sweep(cfg, traffic, [float(r) for r in args.sweep.split(',')],
              args.seconds, seeds[0])
        return 0
    for seed in seeds:
        if traffic['kind'] == 'train_steps':
            rows = train_readings(cfg, traffic, seed, args.control,
                                  args.faults)
        else:
            rows = serve_readings(cfg, traffic, seed, args.seconds, workload,
                                  args.control, args.faults)
        for row in rows:
            _emit(dict(row, seed=seed))
    return 0


if __name__ == '__main__':
    sys.exit(main())
