"""chip_smoke.py's gradient check replays one pass's ReLU and max-pool
decisions in another (`_Decisions`, `_layer_decisions`), on the CPU at a
tiny width.

- Recording changes nothing: the loss and gradients equal those of a
  pass without it, bit for bit.
- Replaying a pass's own decisions gives the same loss and gradients,
  and counts no decision as different.
- Replaying decisions that differ from the pass's own is counted (with
  the decisions downstream that they move) and moves the gradients; the
  replayed relu is where(mask, x, 0) and the replayed max-pool gathers
  the recorded indices.
- models/layers.py gets its `F` back after the block, also on an error.
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs

TINY = {
    'embed_dims': 16, 'series_embed_dims': 8,
    'durpred_conv_dims': 12, 'durpred_rnn_dims': 4, 'durpred_dropout': 0.0,
    'pitch_conv_dims': 12, 'pitch_rnn_dims': 6, 'pitch_dropout': 0.0,
    'pitch_strength': 1.0,
    'energy_conv_dims': 12, 'energy_rnn_dims': 3, 'energy_dropout': 0.0,
    'energy_strength': 0.7,
    'rnn_dims': 12, 'prenet_dims': 8, 'prenet_k': 3, 'prenet_dropout': 0.0,
    'prenet_num_highways': 2, 'postnet_dims': 8, 'postnet_k': 2,
    'postnet_num_highways': 1, 'postnet_dropout': 0.0,
}


def _model(seed=0):
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    torch.manual_seed(seed)
    return ForwardTacotron(num_chars=61, n_mels=80, **TINY)


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def test_recording_and_replaying_own_decisions_change_nothing():
    model, batch = _model(), cs._grads_batch(3)
    plain = cs._model_grads(model, batch, 'cpu')
    rec = cs._Decisions()
    recorded = cs._model_grads(model, batch, 'cpu', rec)
    # 3 x 3 predictor convs, prenet K=3 bank + projection, 2 + 1 highways,
    # postnet K=2 bank + projection: 9 + 4 + 2 + 3 + 1 relus, 2 max-pools
    assert len(rec.recorded) == 9 + 4 + 2 + 3 + 1 + 2
    assert _same(plain, recorded)
    rep = cs._Decisions(rec.recorded)
    replayed = cs._model_grads(model, batch, 'cpu', rep)
    assert rep.calls == len(rec.recorded) and rep.differ == 0
    assert rep.total == sum(d.numel() for d in rec.recorded)
    for k, g in plain.items():
        torch.testing.assert_close(replayed[k], g, rtol=0, atol=1e-7)


def test_replayed_decisions_that_differ_are_counted_and_used():
    model, batch = _model(), cs._grads_batch(3)
    rec = cs._Decisions()
    own = cs._model_grads(model, batch, 'cpu', rec)
    flipped = [d.clone() for d in rec.recorded]
    relu = next(i for i, d in enumerate(flipped) if d.dtype == torch.bool)
    flipped[relu].view(-1)[:5] = ~flipped[relu].view(-1)[:5]
    rep = cs._Decisions(flipped)
    other = cs._model_grads(model, batch, 'cpu', rep)
    # the five flipped, and those downstream that the flips move
    assert rep.differ >= 5
    assert not _same(own, other)


def test_replayed_functions():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 3, 7).astype(np.float32))
    rec = cs._Decisions()
    y_relu = rec.relu(x)
    y_pool = rec.max_pool1d(x, 2, stride=1, padding=1)
    torch.testing.assert_close(y_relu, torch.relu(x), rtol=0, atol=0)
    torch.testing.assert_close(
        y_pool, torch.nn.functional.max_pool1d(x, 2, stride=1, padding=1),
        rtol=0, atol=0)
    assert rec.linear is torch.nn.functional.linear
    mask = rec.recorded[0].clone()
    mask[0, 0, 0] = ~mask[0, 0, 0]
    rep = cs._Decisions([mask, rec.recorded[1]])
    z = rep.relu(x)
    assert rep.differ == 1
    assert torch.equal(z, torch.where(mask, x, torch.zeros_like(x)))
    assert torch.equal(rep.max_pool1d(x, 2, stride=1, padding=1), y_pool)


def test_layer_decisions_restores_layers_f():
    from forwardtacotron_tpu_torch.models import layers
    saved = layers.F
    with pytest.raises(RuntimeError):
        with cs._layer_decisions(cs._Decisions()) as d:
            assert layers.F is d
            raise RuntimeError('inside')
    assert layers.F is saved
