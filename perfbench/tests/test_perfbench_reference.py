"""The frozen reference against the port at a small size on the CPU:
each cell's whole run (set-up, a short window, the check) reads correct,
and the reference put in the program's place in bfloat16 (the control)
does not."""
import argparse
import time

import numpy as np
import pytest
import torch

from perfbench.harness.poisson_open import ServeCell
from perfbench.harness.train_steps import TrainCell
from perfbench.run import run_cell
from perfbench.tests.conftest import small_inputs

SEED = 2 ** 31 + 4242
TRAIN_CELLS = ('ftw_ljspeech.train_b32', 'fph_ljspeech.train_b32')


def cpu_run(cell, seconds=1.0, **traffic):
    args = argparse.Namespace(workload=cell, seed=SEED, seconds=seconds,
                              trace=0)
    return run_cell(args, device='cpu', inputs=small_inputs(cell, **traffic))


@pytest.mark.parametrize('cell', TRAIN_CELLS + ('fph_ljspeech.serve_poisson',))
def test_a_whole_run_reads_correct(cell):
    result, check, notes = cpu_run(cell)
    assert result['correct'], (check, notes)
    assert result['attempted'] > 0 and result['failed'] == 0
    assert set(result['metrics']) >= {'setup_s'}
    for row in check.values():
        assert row['value'] <= row['limit'] / 10 or row['limit'] == 0


@pytest.mark.parametrize('cell', TRAIN_CELLS)
def test_training_control_fails(cell):
    _, _, cfg, traffic, workload = small_inputs(cell)
    run = TrainCell(cfg, traffic, SEED, 'cpu')
    try:
        run.setup()
        run.release()
        ref = run.reference_run()
        numbers = run.compare(run.reference_run(dt=torch.bfloat16), ref)
    finally:
        run.cleanup()
    over = [k for k, limit in workload['limits'].items()
            if numbers[k] > limit]
    assert over, numbers


def test_serving_control_fails():
    _, _, cfg, traffic, workload = small_inputs('fph_ljspeech.serve_poisson')
    run = ServeCell(cfg, dict(traffic, rate_per_s=4.0, chars_max=60), SEED,
                    'cpu')
    try:
        run.setup(1.0)
        run.window(1.0)
        run.release()
        sample = run.sample(4)
        ref = run.reference_pcm(sample)
        numbers = run.compare(run.reference_pcm(sample, torch.bfloat16), ref)
    finally:
        run.cleanup()
    assert numbers['pcm_max_abs'] > workload['limits']['pcm_max_abs'], numbers
    assert all(np.abs(r).max() > 100 for r in ref)
    assert time.perf_counter() > 0
