"""Shared modules: BatchNormConv, HighwayNetwork, CBHG, BiGRU/BiLSTM.

Layout is time-major (B, T, C) at every public function, as in the JAX
package; convolutions transpose to PyTorch's (B, C, T) internally.
Parameter and buffer names are the reference's torch `state_dict` keys
(e.g. `conv1d_bank.0.conv.weight`, `rnn.weight_hh_l0_reverse`), so a
converted checkpoint loads with `strict=True`. In `train()` mode the
batch norms normalize with batch statistics and the dropouts are live,
as the JAX package's `train=True`.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from forwardtacotron_tpu_torch.ops import rnn as rnn_ops
from forwardtacotron_tpu_torch.ops.masking import time_mask
from forwardtacotron_tpu_torch.parallel.mesh import global_sum, spans_ranks


def speaker_emb(model: nn.Module, speaker: Optional[torch.Tensor],
                batch: int, device) -> Optional[torch.Tensor]:
    """(batch, E) rows of a multi-speaker model's `speaker_embedding` for
    the (batch,) ids `speaker` (speaker 0 where None); None for a model
    whose `n_speakers` is 1, which has no speaker parameter."""
    if model.n_speakers <= 1:
        return None
    if speaker is None:
        speaker = torch.zeros(batch, dtype=torch.long, device=device)
    return model.speaker_embedding(speaker.to(device).long())


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout whose mask is drawn from `generator` (none drawn,
    and x returned, when `generator` is None or p is 0)."""
    if generator is None or p == 0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class BiRNN(nn.Module):
    """Bidirectional single-layer GRU or LSTM with nn.GRU/nn.LSTM
    parameter names; the recurrence runs through the BiRNN kernel
    wrapper (`kernels/birnn.py`)."""

    def __init__(self, cell: str, input_dim: int, hidden: int) -> None:
        super().__init__()
        self.cell = cell
        self.hidden = hidden
        g = rnn_ops.n_gates(cell)
        bound = 1.0 / hidden ** 0.5
        for sfx in ('', '_reverse'):
            for name, shape in (('weight_ih_l0', (g * hidden, input_dim)),
                                ('weight_hh_l0', (g * hidden, hidden)),
                                ('bias_ih_l0', (g * hidden,)),
                                ('bias_hh_l0', (g * hidden,))):
                p = nn.Parameter(torch.empty(shape).uniform_(-bound, bound))
                self.register_parameter(name + sfx, p)

    def direction(self, reverse: bool):
        sfx = '_reverse' if reverse else ''
        return {'w_ih': getattr(self, 'weight_ih_l0' + sfx),
                'w_hh': getattr(self, 'weight_hh_l0' + sfx),
                'b_ih': getattr(self, 'bias_ih_l0' + sfx),
                'b_hh': getattr(self, 'bias_hh_l0' + sfx)}

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                pad_value: float = 0.0,
                compute_dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
        """`compute_dtype` None follows x (`ops/rnn.py:follow_dtype`)."""
        return rnn_ops.birnn(self.cell, self.direction(False),
                             self.direction(True), x, lengths=lengths,
                             pad_value=pad_value,
                             compute_dtype=compute_dtype)


_RUNNING_STATS = threading.local()


@contextlib.contextmanager
def frozen_running_stats():
    """Within it (on this thread), train-mode `batch_norm` normalises with
    the batch's statistics as always but leaves the running statistics
    alone: the recompute of a rematerialised forward runs in it, so a
    step moves them once, as the JAX step's single mutation does."""
    before = getattr(_RUNNING_STATS, 'frozen', False)
    _RUNNING_STATS.frozen = True
    try:
        yield
    finally:
        _RUNNING_STATS.frozen = before


def batch_norm(bn: nn.BatchNorm1d, h: torch.Tensor) -> torch.Tensor:
    """`bn` over h (B, C, T) as flax's BatchNorm computes it. In training
    mode the norm uses the batch's mean and biased variance over (B, T)
    and moves the running statistics towards those same values with
    momentum 0.1 (flax's momentum 0.9). `nn.BatchNorm1d` would store the
    unbiased variance instead, 3% larger at 32 samples, so the update is
    written out here. The statistics and the normalisation are computed
    in float32 at least and the result comes back in h's dtype, and the
    running statistics stay float32, as flax does for bfloat16 input.
    Inside `parallel.data_parallel` over more than one rank, the mean and
    the variance are those of the global batch: sums over the ranks
    (`global_sum`, through which the backward goes too) of every rank's
    rows, which all have the global batch's padded length. In eval mode it
    is `bn` itself."""
    if not bn.training:
        return bn(h)
    hf = h.float()
    mesh = spans_ranks()
    if mesh is None:
        var, mean = torch.var_mean(hf, dim=(0, 2), unbiased=False)
    else:
        n = hf.shape[0] * hf.shape[2] * mesh.size
        mean = global_sum(hf.sum(dim=(0, 2))) / n
        var = global_sum(torch.square(hf - mean[:, None]).sum(dim=(0, 2))) / n
    if not getattr(_RUNNING_STATS, 'frozen', False):
        with torch.no_grad():
            bn.running_mean.mul_(1.0 - bn.momentum).add_(bn.momentum * mean)
            bn.running_var.mul_(1.0 - bn.momentum).add_(bn.momentum * var)
            bn.num_batches_tracked.add_(1)
    y = (hf - mean[:, None]) * (torch.rsqrt(var[:, None] + bn.eps)
                                * bn.weight.float()[:, None])
    return (y + bn.bias.float()[:, None]).to(h.dtype)


class BatchNormConv(nn.Module):
    """conv (no bias, 'same' padding) -> optional relu -> BatchNorm
    (`batch_norm`). Even kernels produce one extra frame, which is
    trimmed."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 relu: bool = True) -> None:
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, kernel,
                              padding=kernel // 2, bias=False)
        self.bnorm = nn.BatchNorm1d(out_channels, eps=1e-5, momentum=0.1)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq_len = x.shape[1]
        h = self.conv(x.transpose(1, 2))[:, :, :seq_len]
        if self.relu:
            h = F.relu(h)
        return batch_norm(self.bnorm, h).transpose(1, 2)


class HighwayNetwork(nn.Module):

    def __init__(self, size: int) -> None:
        super().__init__()
        self.W1 = nn.Linear(size, size)
        self.W2 = nn.Linear(size, size)
        nn.init.zeros_(self.W1.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = torch.sigmoid(self.W2(x))
        return g * F.relu(self.W1(x)) + (1.0 - g) * x


class CBHG(nn.Module):
    """Conv bank -> maxpool -> projections -> residual -> highways ->
    BiGRU, with dropout after the maxpool and after the first projection.
    With `lengths`, every stage is cut at each item's true length (convs
    see zero padding, the maxpool sees -inf, the BiGRU reverses from the
    true end), so a padded bucket computes the values of an exact-length
    run; without them padding flows through, as on the reference's padded
    training batches."""

    def __init__(self, K: int, in_channels: int, channels: int,
                 proj_channels: Sequence[int], num_highways: int,
                 dropout: float) -> None:
        super().__init__()
        self.dropout = nn.Dropout(dropout)
        self.conv1d_bank = nn.ModuleList(
            [BatchNormConv(in_channels, channels, k)
             for k in range(1, K + 1)])
        self.conv_project1 = BatchNormConv(K * channels, proj_channels[0], 3)
        self.conv_project2 = BatchNormConv(proj_channels[0],
                                           proj_channels[1], 3, relu=False)
        self.pre_highway = nn.Linear(proj_channels[1], channels, bias=False)
        self.highways = nn.ModuleList([HighwayNetwork(channels)
                                       for _ in range(num_highways)])
        self.rnn = BiRNN('gru', channels, channels)

    def _dropout(self, x: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        if generator is None:
            return self.dropout(x)
        return dropout(x, self.dropout.p if self.training else 0.0,
                       generator)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                compute_dtype: Optional[torch.dtype] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        seq_len = x.shape[1]
        x = time_mask(x, lengths)
        residual = x
        x = torch.cat([conv(x) for conv in self.conv1d_bank], dim=-1)
        x = time_mask(x, lengths, fill=float('-inf'))
        x = F.max_pool1d(x.transpose(1, 2), 2, stride=1, padding=1)
        x = self._dropout(time_mask(x.transpose(1, 2)[:, :seq_len], lengths),
                          generator)
        x = self._dropout(time_mask(self.conv_project1(x), lengths),
                          generator)
        x = self.conv_project2(x) + residual
        x = time_mask(x, lengths)
        x = self.pre_highway(x)
        for highway in self.highways:
            x = highway(x)
        return self.rnn(x, lengths=lengths, compute_dtype=compute_dtype)
