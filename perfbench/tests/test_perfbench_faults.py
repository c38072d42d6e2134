"""A run with its timed path broken underneath reads not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU
at a small size, once for each fault the cell can have. The cells run
on one card, so none has an exchange between cards to leave out."""
import numpy as np
import pytest
import torch

from perfbench.tests.test_perfbench_reference import TRAIN_CELLS, cpu_run


@pytest.mark.parametrize('cell', TRAIN_CELLS)
def test_a_step_that_leaves_the_state_unchanged(cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, 'step',
                        lambda self, closure=None: None)
    result, check, _ = cpu_run(cell)
    assert not result['correct']
    assert check['change_gap' if 'change_gap' in check
                 else 'change_gap_median']['value'] == pytest.approx(1.0)


@pytest.mark.parametrize('cell', TRAIN_CELLS)
def test_half_of_the_batch_left_out(cell, monkeypatch):
    from forwardtacotron_tpu_torch.train import common as tc
    whole = tc.train_step

    def halved(model, optimizer, batch, generator, train_cfg, ema=None):
        n = batch['x'].shape[0] // 2
        return whole(model, optimizer, {k: v[:n] for k, v in batch.items()},
                     generator, train_cfg, ema)
    monkeypatch.setattr(tc, 'train_step', halved)
    result, check, _ = cpu_run(cell)
    assert not result['correct'], check


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from forwardtacotron_tpu_torch import serving
    produce = serving.vocode_generator
    calls = []

    def altered(model, mel, pcm16=False):
        pcm = produce(model, mel, pcm16=pcm16).copy()
        calls.append(1)
        i = len(pcm) // 2
        pcm[i] = np.int16(int(pcm[i]) + (1000 if pcm[i] < 0 else -1000))
        return pcm
    monkeypatch.setattr(serving, 'vocode_generator', altered)
    result, check, _ = cpu_run('fph_ljspeech.serve_poisson')
    assert calls and not result['correct'], check


def test_a_request_that_never_comes(monkeypatch):
    """The vocoder fails every request once the window opens (a fault in
    set-up stops the run before it prints a result)."""
    from forwardtacotron_tpu_torch import serving
    from perfbench.harness.poisson_open import ServeCell
    produce, window = serving.vocode_generator, ServeCell.window
    broken = []

    def fails(model, mel, pcm16=False):
        if broken:
            raise RuntimeError('vocoder fault')
        return produce(model, mel, pcm16=pcm16)

    def open_window(self, *args, **kw):
        broken.append(1)
        return window(self, *args, **kw)
    monkeypatch.setattr(serving, 'vocode_generator', fails)
    monkeypatch.setattr(ServeCell, 'window', open_window)
    result, check, _ = cpu_run('fph_ljspeech.serve_poisson')
    assert not result['correct'] and check['unanswered']['value'] > 0
