"""The original DeepMind coarse/fine WaveRNN.

A port of the JAX package's `models/deepmind_wavernn.py` (the
reference's models/deepmind_version.py, which no trainer or CLI uses).
The dual-softmax cell splits its hidden state into a coarse and a fine
half; the fine half is conditioned on the step's sampled coarse value.
Parameter names are the reference's (`R`, `O1`..`O4`, `I_coarse`,
`I_fine`, `bias_u`, `bias_r`, `bias_e`).

The JAX package samples in one `lax.scan` with no Pallas kernel, so
`generate` is a plain PyTorch loop of a step's ops. It draws both
categorical samples by the Gumbel-max rule from an explicit
`torch.Generator`, not the TPU's PRNG: sampled sequences differ from
JAX's draw for draw, while a run whose logits have one dominant class
follows the same trajectory.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn


def combine_signal(coarse: np.ndarray, fine: np.ndarray) -> np.ndarray:
    """16-bit signal in [-1, 1] from its 8-bit coarse and fine parts."""
    signal = coarse.astype(np.int64) * 256 + fine.astype(np.int64)
    return (signal.astype(np.float32) / 32767.5) - 1.0


def split_signal(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A signal in [-1, 1] -> its 8-bit (coarse, fine) parts."""
    unsigned = ((x + 1.0) * 32767.5).astype(np.int64)
    return unsigned // 256, unsigned % 256


def _gumbel_max(logits: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """One categorical draw per row of `logits` (B, C) from `generator`."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_(min=torch.finfo(u.dtype).tiny)
    return (logits - torch.log(-torch.log(u))).argmax(dim=-1)


class DeepMindWaveRNN(nn.Module):

    def __init__(self, hidden_size: int = 896,
                 quantisation: int = 256) -> None:
        super().__init__()
        self.hidden_size = hidden_size
        self.split_size = s = hidden_size // 2
        self.R = nn.Linear(hidden_size, 3 * hidden_size, bias=False)
        self.O1 = nn.Linear(s, s)
        self.O2 = nn.Linear(s, quantisation)
        self.O3 = nn.Linear(s, s)
        self.O4 = nn.Linear(s, quantisation)
        self.I_coarse = nn.Linear(2, 3 * s, bias=False)
        self.I_fine = nn.Linear(3, 3 * s, bias=False)
        self.bias_u = nn.Parameter(torch.zeros(hidden_size))
        self.bias_r = nn.Parameter(torch.zeros(hidden_size))
        self.bias_e = nn.Parameter(torch.zeros(hidden_size))

    def forward(self, prev_y: torch.Tensor, prev_hidden: torch.Tensor,
                current_coarse: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Teacher-forced step: prev_y (B, 2) coarse and fine in [-1, 1],
        prev_hidden (B, hidden), current_coarse (B, 1). Returns (coarse
        logits, fine logits, hidden)."""
        s = self.split_size
        R_u, R_r, R_e = self.R(prev_hidden).chunk(3, dim=1)
        I_cu, I_cr, I_ce = self.I_coarse(prev_y).chunk(3, dim=1)
        fine_input = torch.cat([prev_y, current_coarse], dim=1)
        I_fu, I_fr, I_fe = self.I_fine(fine_input).chunk(3, dim=1)
        I_u = torch.cat([I_cu, I_fu], dim=1)
        I_r = torch.cat([I_cr, I_fr], dim=1)
        I_e = torch.cat([I_ce, I_fe], dim=1)
        u = torch.sigmoid(R_u + I_u + self.bias_u)
        r = torch.sigmoid(R_r + I_r + self.bias_r)
        e = torch.tanh(r * R_e + I_e + self.bias_e)
        hidden = u * prev_hidden + (1.0 - u) * e
        out_coarse = self.O2(torch.relu(self.O1(hidden[:, :s])))
        out_fine = self.O4(torch.relu(self.O3(hidden[:, s:])))
        return out_coarse, out_fine, hidden

    @torch.no_grad()
    def generate(self, seq_len: int,
                 generator: Optional[torch.Generator] = None,
                 batch_size: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """Unconditional generation of `seq_len` steps on the model's
        device: (coarse, fine) int64 (B, seq_len), to be joined by
        `combine_signal`. `R(hidden)` is split into six gate blocks
        (coarse and fine of u, r, e), the coarse half's gates go first, and
        the fine half takes the step's coarse sample."""
        s = self.split_size
        device = self.R.weight.device
        b_cu, b_fu = self.bias_u[:s], self.bias_u[s:]
        b_cr, b_fr = self.bias_r[:s], self.bias_r[s:]
        b_ce, b_fe = self.bias_e[:s], self.bias_e[s:]
        out_c = torch.zeros(batch_size, device=device)
        out_f = torch.zeros(batch_size, device=device)
        h_c = torch.zeros(batch_size, s, device=device)
        h_f = torch.zeros(batch_size, s, device=device)
        coarse = torch.empty((batch_size, seq_len), dtype=torch.long,
                             device=device)
        fine = torch.empty_like(coarse)
        for t in range(seq_len):
            prev = torch.stack([out_c, out_f], dim=1) / 127.5 - 1.0
            I_cu, I_cr, I_ce = self.I_coarse(prev).chunk(3, dim=1)
            R_cu, R_fu, R_cr, R_fr, R_ce, R_fe = self.R(
                torch.cat([h_c, h_f], dim=1)).chunk(6, dim=1)
            u = torch.sigmoid(R_cu + I_cu + b_cu)
            r = torch.sigmoid(R_cr + I_cr + b_cr)
            e = torch.tanh(r * R_ce + I_ce + b_ce)
            h_c = u * h_c + (1.0 - u) * e
            c = _gumbel_max(self.O2(torch.relu(self.O1(h_c))), generator)

            fine_input = torch.cat([prev, (c.float() / 127.5 - 1.0)[:, None]],
                                   dim=1)
            I_fu, I_fr, I_fe = self.I_fine(fine_input).chunk(3, dim=1)
            u = torch.sigmoid(R_fu + I_fu + b_fu)
            r = torch.sigmoid(R_fr + I_fr + b_fr)
            e = torch.tanh(r * R_fe + I_fe + b_fe)
            h_f = u * h_f + (1.0 - u) * e
            f = _gumbel_max(self.O4(torch.relu(self.O3(h_f))), generator)
            coarse[:, t], fine[:, t] = c, f
            out_c, out_f = c.float(), f.float()
        return coarse, fine
