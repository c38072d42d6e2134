"""Training step time of the port in the working directory, on one card.

    python3 tools/ab_training_step.py [--rounds 6] [--paths]

Imports `forwardtacotron_tpu_torch` and `chip_smoke.py` from the working
directory, builds the kernels, and times `--rounds` rounds of 5 steps at
batch 32 on a 768-frame batch of `chip_smoke.py`'s synthetic dataset. Per
round it prints one JSON line: the median forward (with the loss),
backward, clip + Adam and step ms (CUDA events) and the host ms of the
forward's Python call. Run from two checkouts in turns, one process each
(parent, change, change, parent), it compares them on one card, and a
drift shows as a difference between the two runs of one checkout:

    for d in PARENT . . PARENT; do (cd $d && python3 $OLDPWD/tools/ab_training_step.py); done

With `--paths` each round also runs the step with every launch of kernel
#2 forced onto its cooperative path (`train_forward(..., path=
'cooperative')`), and the tool prints the host µs of one `train_forward`
call at the pitch predictor's shape on each path.

Prints the card's name and power limit first. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path


def forced_cooperative(bt):
    """`bt.train_forward` with `path='cooperative'`, sharing its counters
    (the kernel's wrapper counts through the module's name)."""
    planned = bt.train_forward

    def train_forward(*args, **kw):
        return planned(*args, path='cooperative', **kw)
    train_forward.launches = planned.launches
    train_forward.path_launches = planned.path_launches
    return train_forward


def main() -> None:
    parser = argparse.ArgumentParser(
        description=__doc__.split('\n\n')[0])
    parser.add_argument('--rounds', type=int, default=6)
    parser.add_argument('--paths', action='store_true',
                        help="also time kernel #2 forced onto its "
                             'cooperative path, in turns')
    args = parser.parse_args()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)

    import torch
    sys.path.insert(0, os.getcwd())
    import chip_smoke as c
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.data.dataset import get_tts_datasets
    from forwardtacotron_tpu_torch.kernels import birnn_train as bt
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.forward_trainer import (
        batch_to_device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c.build_kernels()
    data = Path(c.OUT_DIR) / f'ab_step_data_{os.getpid()}'
    shutil.rmtree(data, ignore_errors=True)
    try:
        c._write_dataset(data)
        cfg = default_config()
        train_cfg = cfg['forward_tacotron']['training']
        _, val_set = get_tts_datasets(str(data), 32, 1, None)
        batch = batch_to_device(
            next(b for b in val_set if b['mel'].shape[1] == 768), 'cuda')
    finally:
        shutil.rmtree(data, ignore_errors=True)
    torch.manual_seed(0)
    model = ForwardTacotron.from_config(cfg).cuda().train()
    optimizer = tc.make_optimizer(model)

    def step():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        t0 = time.perf_counter()
        optimizer.zero_grad(set_to_none=True)
        loss, _ = tc.forward_loss(model(batch), batch, batch['pitch'],
                                  batch['energy'], train_cfg)
        host_fwd = (time.perf_counter() - t0) * 1e3
        ev[1].record()
        loss.backward()
        ev[2].record()
        tc.clip_by_global_norm(model.parameters(), train_cfg['clip_grad_norm'])
        optimizer.step()
        ev[3].record()
        ev[3].synchronize()
        fwd, bwd, opt = (ev[i].elapsed_time(ev[i + 1]) for i in range(3))
        return {'forward_ms': fwd, 'backward_ms': bwd, 'optimizer_ms': opt,
                'step_ms': fwd + bwd + opt, 'host_forward_ms': host_fwd}

    planned = bt.train_forward
    variants = [('planned', planned)]
    if args.paths:
        variants.append(('cooperative', forced_cooperative(bt)))
    for _ in range(3):
        step()
    for r in range(args.rounds):
        for name, fn in variants:
            bt.train_forward = fn
            try:
                step()
                rows = [step() for _ in range(5)]
            finally:
                bt.train_forward = planned
            print(json.dumps({'round': r, 'paths': name, **{
                k: statistics.median(row[k] for row in rows)
                for k in rows[0]}}), flush=True)
    if not args.paths:
        return

    # host cost of one call at the pitch predictor's shape on each path
    T, B, H = 192, 32, 128
    g = torch.Generator(device='cuda').manual_seed(H)
    gi = torch.randn((T, B, 2, 3 * H), device='cuda', generator=g)
    w = (torch.rand((2, 3 * H, H), device='cuda', generator=g) * 2 - 1) / 11
    b = torch.zeros((2, 3 * H), device='cuda')
    ln = torch.full((B,), T, dtype=torch.int32, device='cuda')
    for path in bt.PATHS:
        bt.train_forward('gru', gi, w, b, ln, torch.float32, path=path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            bt.train_forward('gru', gi, w, b, ln, torch.float32, path=path)
        host_us = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
        print(json.dumps({'train_forward_host_us': host_us, 'path': path,
                          'shape': 'gru H=128 T=192 B=32 float32'}))


if __name__ == '__main__':
    main()
