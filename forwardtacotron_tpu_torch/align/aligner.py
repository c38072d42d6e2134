"""Teacher-free neural aligner: text and mel encoders and the monotonic
forward-sum alignment.

A port of the JAX package's `align/aligner.py`. Two convolutional
encoders score every (frame, phoneme) pair; `forward_sum_loss` is the
negative log-likelihood of every monotonic alignment path (a CTC-like
dynamic program without blanks), and `viterbi_durations` extracts the
hard durations of the best path. `train_aligner` trains it in place of
the Tacotron teacher and writes the same alignment files.

The JAX package computes both dynamic programs with `lax.scan` and XLA
ops (no Pallas kernel), so here they are plain PyTorch: a Python loop
over the padded frame axis of a few whole-batch (B, N) ops a step, the
shift by one phoneme an `F.pad`, and the backward through autograd.
Frames at or past `mel_len` carry alpha unchanged. Constants kept from
JAX: `NEG = -1e9` as a soft minus infinity, flax's LayerNorm epsilon
1e-6, 'SAME' convolution padding.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from forwardtacotron_tpu_torch.models.layers import dropout
from forwardtacotron_tpu_torch.text.symbols import phonemes

NEG = -1e9                     # soft -inf that is safe in float32 DP math
LAYER_NORM_EPS = 1e-6          # flax's nn.LayerNorm default


class ConvStack(nn.Module):
    """(Conv1d 'SAME' -> LayerNorm -> ReLU -> dropout) x n_convs, then a
    linear head."""

    def __init__(self, in_dims: int, dims: int, out_dims: int,
                 n_convs: int, kernel: int = 3, p: float = 0.0) -> None:
        super().__init__()
        self.p = p
        self.pad = ((kernel - 1) // 2, kernel // 2)
        self.convs = nn.ModuleList([
            nn.Conv1d(in_dims if i == 0 else dims, dims, kernel)
            for i in range(n_convs)])
        self.norms = nn.ModuleList([nn.LayerNorm(dims, eps=LAYER_NORM_EPS)
                                    for _ in range(n_convs)])
        self.lin = nn.Linear(dims, out_dims)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """x (B, T, C) -> (B, T, out_dims); dropout draws from
        `generator` (none without one)."""
        for conv, norm in zip(self.convs, self.norms):
            x = conv(F.pad(x.transpose(1, 2), self.pad)).transpose(1, 2)
            x = dropout(F.relu(norm(x)), self.p, generator)
        return self.lin(x)


def log_beta_binomial_prior(T: int, N: int, width: float,
                            device=None) -> torch.Tensor:
    """(T, N) log-prior favouring the diagonal: a Gaussian around
    n = (t + 0.5) N / T with std `width` phonemes."""
    t = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    n = torch.arange(N, dtype=torch.float32, device=device)[None, :]
    center = (t + 0.5) * N / T
    return -0.5 * ((n - center) / width) ** 2


class Aligner(nn.Module):
    """log P(phoneme n | frame t) for every pair: `forward(x (B, N) int,
    mel (B, T, M), x_len)` -> log_att (B, T, N), a per-frame
    log-softmax over the real phonemes (positions >= x_len are NEG
    before normalising). Train mode (`train()`) draws the encoders'
    dropout from the `generator` that `forward` is given."""

    def __init__(self, vocab_size: int, n_mels: int = 80,
                 embed_dims: int = 128, conv_dims: int = 128,
                 key_dims: int = 64, n_text_convs: int = 3,
                 n_mel_convs: int = 2, dropout: float = 0.1,
                 prior_width: float = 10.0) -> None:
        super().__init__()
        self.key_dims = key_dims
        self.prior_width = prior_width
        self.embedding = nn.Embedding(vocab_size, embed_dims)
        self.text_enc = ConvStack(embed_dims, conv_dims, key_dims,
                                  n_text_convs, p=dropout)
        self.mel_enc = ConvStack(n_mels, conv_dims, key_dims, n_mel_convs,
                                 p=dropout)
        self.register_buffer('step', torch.zeros(1, dtype=torch.long))

    def forward(self, x: torch.Tensor, mel: torch.Tensor,
                x_len: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if self.training and generator is None and \
                self.text_enc.p > 0:
            raise ValueError('train mode draws dropout from a '
                             'torch.Generator: pass `generator`')
        gen = generator if self.training else None
        keys = self.text_enc(self.embedding(x), gen)
        queries = self.mel_enc(mel, gen)
        # -||q - k||^2 / sqrt(D) through one batched product
        qk = torch.bmm(queries, keys.transpose(1, 2))
        q2 = (queries ** 2).sum(-1)[:, :, None]
        k2 = (keys ** 2).sum(-1)[:, None, :]
        dist = (2.0 * qk - q2 - k2) / float(np.sqrt(float(self.key_dims)))
        if self.prior_width > 0:
            dist = dist + log_beta_binomial_prior(
                mel.shape[1], x.shape[1], self.prior_width, x.device)
        n_mask = torch.arange(x.shape[1], device=x.device)[None, :] \
            < x_len.to(x.device)[:, None]
        dist = dist.masked_fill(~n_mask[:, None, :], NEG)
        return torch.log_softmax(dist, dim=-1)


def _alpha0(log_att: torch.Tensor) -> torch.Tensor:
    """alpha at frame 0: phoneme 0 holds log_att[:, 0, 0], the rest NEG."""
    B, _, N = log_att.shape
    return F.pad(log_att[:, 0, :1], (0, N - 1), value=NEG)


def _active(log_att: torch.Tensor, mel_len: torch.Tensor) -> torch.Tensor:
    """(B, T, 1) bool: frame t lies before the item's mel_len."""
    T = log_att.shape[1]
    return (torch.arange(T, device=log_att.device)[None, :]
            < mel_len.to(log_att.device)[:, None])[..., None]


def forward_sum_loss(log_att: torch.Tensor, x_len: torch.Tensor,
                     mel_len: torch.Tensor) -> torch.Tensor:
    """Negative log-likelihood of every monotonic alignment: paths start
    on phoneme 0 at frame 0, advance by 0 or 1 phoneme a frame, and end on
    phoneme x_len - 1 at frame mel_len - 1. The batch mean of -log P /
    mel_len; differentiable in log_att."""
    T = log_att.shape[1]
    active = _active(log_att, mel_len)
    alpha = _alpha0(log_att)
    for t in range(1, T):
        advanced = F.pad(alpha[:, :-1], (1, 0), value=NEG)
        new = log_att[:, t] + torch.logaddexp(alpha, advanced)
        alpha = torch.where(active[:, t], new, alpha)
    x_len = x_len.to(log_att.device).long()
    final = alpha.gather(1, (x_len - 1)[:, None])[:, 0]
    return (-final / mel_len.to(log_att.device).float()).mean()


@torch.no_grad()
def viterbi_durations(log_att: torch.Tensor, x_len: torch.Tensor,
                      mel_len: torch.Tensor) -> torch.Tensor:
    """Hard durations (B, N) int32 of the best monotonic path, summing to
    mel_len. The forward max pass records the choice to advance at each
    (frame, phoneme) (`advanced > alpha`: a tie stays) on the device; the
    backtrack from (mel_len - 1, x_len - 1) walks the choices on the host.
    """
    B, T, N = log_att.shape
    active = _active(log_att, mel_len)
    alpha = _alpha0(log_att)
    choices = torch.zeros((T, B, N), dtype=torch.bool,
                          device=log_att.device)
    for t in range(1, T):
        advanced = F.pad(alpha[:, :-1], (1, 0), value=NEG)
        choices[t] = (advanced > alpha) & active[:, t]
        new = log_att[:, t] + torch.maximum(alpha, advanced)
        alpha = torch.where(active[:, t], new, alpha)
    choices = choices.cpu().numpy()
    n = x_len.cpu().numpy().astype(np.int64) - 1
    rows = np.arange(B)
    frame_phon = np.zeros((B, T), np.int64)
    for t in range(T - 1, 0, -1):
        frame_phon[:, t] = n
        n = n - choices[t, rows, n]
    valid = np.arange(T)[None, :] < mel_len.cpu().numpy()[:, None]
    durs = np.zeros((B, N), np.int32)
    for b in range(B):
        durs[b] = np.bincount(frame_phon[b][valid[b]], minlength=N)[:N]
    return torch.from_numpy(durs).to(log_att.device)


@torch.no_grad()
def align_extract(model: Aligner, x: torch.Tensor, mel: torch.Tensor,
                  x_len: torch.Tensor, mel_len: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(durations (B, N) int32, soft attention (B, T, N)) of a batch in
    eval mode: the aligner's counterpart of the teacher's attention
    step."""
    was_training = model.training
    model.eval()
    try:
        log_att = model(x, mel, x_len)
    finally:
        model.train(was_training)
    return viterbi_durations(log_att, x_len, mel_len), log_att.exp()


def aligner_from_config(config: Dict[str, Any]) -> Aligner:
    """The Aligner of `config['aligner']['model']` (JAX's defaults where
    a key is missing), over the phoneme table and `dsp.num_mels`."""
    cfg = config.get('aligner', {}).get('model', {})
    return Aligner(
        vocab_size=len(phonemes), n_mels=config['dsp']['num_mels'],
        embed_dims=cfg.get('embed_dims', 128),
        conv_dims=cfg.get('conv_dims', 128),
        key_dims=cfg.get('key_dims', 64),
        n_text_convs=cfg.get('n_text_convs', 3),
        n_mel_convs=cfg.get('n_mel_convs', 2),
        dropout=cfg.get('dropout', 0.1),
        prior_width=cfg.get('prior_width', 10.0))
