"""Bidirectional GRU/LSTM in the torch parameter layout.

- GRU gates are ordered r|z|n, with the reset gate applied to the
  hidden projection plus its bias (`n = tanh(gi_n + r * (W_hn h + b_hn))`);
  LSTM gates are ordered i|f|g|o.
- Variable lengths follow pack_padded_sequence: the forward direction
  updates while t < len, the backward direction starts at each
  sequence's true end, and padded outputs are filled with `pad_value`.
- The input projection gi = x W_ihᵀ + b_ih of the whole sequence is one
  matmul; only the hidden recurrence runs step by step. That recurrence
  is `birnn_recurrence`: the plain version of the CUDA kernel in
  `kernels/birnn.py`, which `grouped_birnn` reaches through the kernel's
  wrapper (the kernel for CUDA tensors, this function for CPU ones).

Parameter dicts: {'w_ih': (NG*H, D), 'w_hh': (NG*H, H), 'b_ih': (NG*H,),
'b_hh': (NG*H,)} with NG = 3 (GRU) or 4 (LSTM).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from forwardtacotron_tpu_torch.ops.masking import pad_mask

Params = Dict[str, torch.Tensor]


def n_gates(cell: str) -> int:
    if cell not in ('gru', 'lstm'):
        raise ValueError(f'unknown cell {cell!r}')
    return 4 if cell == 'lstm' else 3


def gru_from_gates(gi: torch.Tensor, gh: torch.Tensor, h: torch.Tensor
                   ) -> torch.Tensor:
    """GRU update from input gates gi and hidden gates gh = W_hh h + b_hh
    (both (..., 3H))."""
    H = h.shape[-1]
    r = torch.sigmoid(gi[..., :H] + gh[..., :H])
    z = torch.sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
    n = torch.tanh(gi[..., 2 * H:] + r * gh[..., 2 * H:])
    return (1.0 - z) * n + z * h


def lstm_from_gates(gates: torch.Tensor, c: torch.Tensor):
    """LSTM update from the summed gates (..., 4H); returns (h, c)."""
    H = c.shape[-1]
    i = torch.sigmoid(gates[..., :H])
    f = torch.sigmoid(gates[..., H:2 * H])
    g = torch.tanh(gates[..., 2 * H:3 * H])
    o = torch.sigmoid(gates[..., 3 * H:])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def stream_active(t: int, n_steps: int, n_streams: int,
                  lengths: torch.Tensor) -> torch.Tensor:
    """(S, B) bool: is stream s at step t inside its sequence? Even
    streams run forward (active iff t < len); odd streams run over the
    time-reversed input (active iff n_steps - len <= t)."""
    fwd = t < lengths
    bwd = t >= n_steps - lengths
    return torch.stack([fwd if s % 2 == 0 else bwd
                        for s in range(n_streams)])


def birnn_recurrence(cell: str, gi: torch.Tensor, w_hh: torch.Tensor,
                     b_hh: torch.Tensor, lengths: torch.Tensor,
                     compute_dtype: torch.dtype = torch.float32
                     ) -> torch.Tensor:
    """Plain version of the BiRNN kernel: S independent recurrences
    ("streams") advanced together.

    gi (T, B, S, NG*H) input gates in `compute_dtype`, odd streams
    time-reversed; w_hh (S, NG*H, H) in `compute_dtype`; b_hh (S, NG*H)
    float32 (zeros for LSTM, whose b_hh is folded into gi); lengths (B,)
    int. The hidden state is float32 and is rounded to `compute_dtype`
    before each product, which accumulates in float32, exactly as the
    kernel does. Returns y (T, B, S, H) float32: the state after each
    step (held, not updated, at inactive steps)."""
    T, B, S, _ = gi.shape
    H = w_hh.shape[-1]
    lstm = n_gates(cell) == 4
    w = w_hh.float()
    b = b_hh.float()[:, None, :]
    h = gi.new_zeros((S, B, H), dtype=torch.float32)
    c = torch.zeros_like(h)
    ys = []
    for t in range(T):
        hq = h.to(compute_dtype).float()
        gh = torch.einsum('sbh,sgh->sbg', hq, w) + b
        g = gi[t].float().transpose(0, 1)                 # (S, B, NG*H)
        if lstm:
            h_new, c_new = lstm_from_gates(g + gh, c)
        else:
            h_new = gru_from_gates(g, gh, h)
        active = stream_active(t, T, S, lengths)[..., None]
        h = torch.where(active, h_new, h)
        if lstm:
            c = torch.where(active, c_new, c)
        ys.append(h)
    return torch.stack(ys).permute(0, 2, 1, 3).contiguous()


def grouped_birnn(cell: str, w_ih: torch.Tensor, w_hh: torch.Tensor,
                  b_ih: torch.Tensor, b_hh: torch.Tensor,
                  x_groups: torch.Tensor,
                  lengths: Optional[torch.Tensor] = None,
                  compute_dtype: torch.dtype = torch.float32
                  ) -> torch.Tensor:
    """G independent bidirectional RNNs in one recurrence.

    w_ih (2, G, NG*H, D) with direction 0 = forward; w_hh (2, G, NG*H, H);
    b_ih/b_hh (2, G, NG*H); x_groups (B, T, G, D). Returns (B, T, G, 2, H)
    per-group [forward, backward] features, zero at t >= lengths."""
    from forwardtacotron_tpu_torch.kernels.birnn import recurrence
    B, T, G, _ = x_groups.shape
    H = w_hh.shape[-1]
    GH = w_ih.shape[-2]
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32,
                             device=x_groups.device)
    lengths = lengths.to(device=x_groups.device, dtype=torch.int32)
    gi = torch.einsum('btgd,cghd->btcgh', x_groups, w_ih) \
        + b_ih[None, None]                                # (B, T, 2, G, GH)
    if cell == 'lstm':
        gi = gi + b_hh[None, None]
        b_rec = torch.zeros((2 * G, GH), dtype=torch.float32,
                            device=x_groups.device)
    else:
        b_rec = b_hh.transpose(0, 1).reshape(2 * G, GH).float()
    # stream s = 2g + d; the backward stream walks reversed time
    gi = torch.stack([gi[:, :, 0], gi[:, :, 1].flip(1)], dim=3)
    gi = gi.transpose(0, 1).reshape(T, B, 2 * G, GH)
    gi = gi.to(compute_dtype).contiguous()
    w = w_hh.transpose(0, 1).reshape(2 * G, GH, H).to(compute_dtype)
    y = recurrence(cell, gi, w.contiguous(), b_rec.contiguous(), lengths,
                   compute_dtype)                         # (T, B, 2G, H)
    y = y.reshape(T, B, G, 2, H)
    y = torch.stack([y[:, :, :, 0], y[:, :, :, 1].flip(0)], dim=3)
    y = y.permute(1, 0, 2, 3, 4)                          # (B, T, G, 2, H)
    valid = pad_mask(lengths, T)[:, :, None, None, None]
    return torch.where(valid, y, torch.zeros_like(y))


def grouped_bigru(w_ih, w_hh, b_ih, b_hh, x_groups, lengths=None,
                  compute_dtype: torch.dtype = torch.float32
                  ) -> torch.Tensor:
    return grouped_birnn('gru', w_ih, w_hh, b_ih, b_hh, x_groups, lengths,
                         compute_dtype)


def mask_outputs(y: torch.Tensor, lengths: Optional[torch.Tensor],
                 pad_value: float) -> torch.Tensor:
    if lengths is None:
        return y
    mask = pad_mask(lengths.to(y.device), y.shape[1])[:, :, None]
    return torch.where(mask, y, torch.full_like(y, pad_value))


def birnn(cell: str, params_fwd: Params, params_bwd: Params,
          x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
          pad_value: float = 0.0,
          compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Bidirectional RNN over x (B, T, D) -> (B, T, 2H) = [fwd, bwd]."""
    def stack(k):
        return torch.stack([params_fwd[k], params_bwd[k]])[:, None]
    y = grouped_birnn(cell, stack('w_ih'), stack('w_hh'), stack('b_ih'),
                      stack('b_hh'), x[:, :, None, :], lengths,
                      compute_dtype)
    y = torch.cat([y[:, :, 0, 0], y[:, :, 0, 1]], dim=-1)
    return mask_outputs(y, lengths, pad_value)


def bigru(params_fwd: Params, params_bwd: Params, x: torch.Tensor,
          lengths: Optional[torch.Tensor] = None, pad_value: float = 0.0,
          compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return birnn('gru', params_fwd, params_bwd, x, lengths, pad_value,
                 compute_dtype)


def bilstm(params_fwd: Params, params_bwd: Params, x: torch.Tensor,
           lengths: Optional[torch.Tensor] = None, pad_value: float = 0.0,
           compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return birnn('lstm', params_fwd, params_bwd, x, lengths, pad_value,
                 compute_dtype)


def pad_gru_gates(w: torch.Tensor, h_group: int, h_common: int,
                  n: int = 3) -> torch.Tensor:
    """Zero-pad the per-gate blocks of a stacked-gate tensor
    (n*h_group, ...) to (n*h_common, ...)."""
    if h_group == h_common:
        return w
    w = w.reshape((n, h_group) + tuple(w.shape[1:]))
    pad = w.new_zeros((n, h_common - h_group) + tuple(w.shape[2:]))
    return torch.cat([w, pad], dim=1).reshape(
        (n * h_common,) + tuple(w.shape[2:]))
