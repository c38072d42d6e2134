"""Plain PyTorch layers of the benchmark's references.

Each function takes its weights from a dict of tensors by name (the
published `state_dict` keys) and computes in the dtype of what it is
handed: float32 for the reference, bfloat16 for its control. Nothing here
imports the program under test. The layouts, (B, T, C) at every public
function with convolutions on a transposed view, follow the published
modules, so that a dropout drawn from the global generator meets the
same elements as in any implementation of the same layers.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.nn import functional as F

Params = Dict[str, torch.Tensor]


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


def embed(w: torch.Tensor, ids: torch.Tensor, dtype) -> torch.Tensor:
    return w.to(dtype)[ids]


def batch_norm_train(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """Batch normalisation of h (B, C, T) with the batch's mean and biased
    variance over (B, T), in float32 at least, back in h's dtype."""
    hf = h.float()
    var, mean = torch.var_mean(hf, dim=(0, 2), unbiased=False)
    y = (hf - mean[:, None]) * (torch.rsqrt(var[:, None] + eps)
                                * w.float()[:, None]) + b.float()[:, None]
    return y.to(h.dtype)


def bn_conv(P: Params, pre: str, x: torch.Tensor, k: int,
            relu: bool = True) -> torch.Tensor:
    """conv (no bias, padding k // 2, cut to T) -> relu -> batch norm over
    x (B, T, C); returns the (B, T, C) transpose of the (B, C, T) result."""
    T = x.shape[1]
    h = F.conv1d(x.transpose(1, 2), P[f'{pre}.conv.weight'].to(x.dtype),
                 padding=k // 2)[:, :, :T]
    if relu:
        h = F.relu(h)
    return batch_norm_train(h, P[f'{pre}.bnorm.weight'],
                            P[f'{pre}.bnorm.bias']).transpose(1, 2)


def global_dropout(x: torch.Tensor, p: float) -> torch.Tensor:
    """Dropout on the global generator of x's device, drawn as a float32
    tensor of x's layout would draw it (a bfloat16 control then keeps the
    float32 run's masks)."""
    if x.dtype == torch.float32:
        return F.dropout(x, p, training=True)
    return F.dropout(x.float(), p, training=True).to(x.dtype)


def generator_dropout(x: torch.Tensor, p: float,
                      gen: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout whose keep mask is `rand >= p`, drawn from `gen` in
    float32 (nothing drawn for p = 0 or no generator)."""
    if gen is None or p == 0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def highway(P: Params, pre: str, x: torch.Tensor) -> torch.Tensor:
    g = torch.sigmoid(linear(x, P[f'{pre}.W2.weight'], P[f'{pre}.W2.bias']))
    return g * F.relu(linear(x, P[f'{pre}.W1.weight'],
                             P[f'{pre}.W1.bias'])) + (1.0 - g) * x


def _reverse_index(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """(B, T) index that reverses each row within its length and leaves
    the positions past it in place."""
    t = torch.arange(T, device=lengths.device)[None, :]
    n = lengths[:, None]
    return torch.where(t < n, n - 1 - t, t)


def _time_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def birnn(P: Params, pre: str, cell: str, x: torch.Tensor,
          lengths: Optional[torch.Tensor] = None,
          pad_value: float = 0.0) -> torch.Tensor:
    """Bidirectional one-layer GRU or LSTM with torch's parameter names
    and gate equations, over x (B, T, D) -> (B, T, 2H). The backward
    direction starts at each row's last valid step (a packed sequence);
    outputs past a row's length are `pad_value`. A plain loop over time
    in x's dtype, both directions advanced together."""
    B, T, _ = x.shape
    dt = x.dtype
    full = lengths is None
    if full:
        lengths = torch.full((B,), T, dtype=torch.long, device=x.device)
    lengths = lengths.to(x.device).long()
    rev = _reverse_index(lengths, T)
    xs = torch.stack([x, _time_gather(x, rev)])               # (2, B, T, D)
    sfx = ('', '_reverse')
    w_ih = torch.stack([P[f'{pre}.weight_ih_l0{s}'] for s in sfx]).to(dt)
    w_hh = torch.stack([P[f'{pre}.weight_hh_l0{s}'] for s in sfx]).to(dt)
    b_ih = torch.stack([P[f'{pre}.bias_ih_l0{s}'] for s in sfx]).to(dt)
    b_hh = torch.stack([P[f'{pre}.bias_hh_l0{s}'] for s in sfx]).to(dt)
    H = w_hh.shape[-1]
    gi = torch.einsum('sbtd,sgd->sbtg', xs, w_ih) + b_ih[:, None, None]
    h = xs.new_zeros((2, B, H))
    c = xs.new_zeros((2, B, H))
    w_t = w_hh.transpose(1, 2)
    ys = []
    for t in range(T):
        gh = torch.baddbmm(b_hh[:, None, :], h, w_t)             # (2, B, G)
        g = gi[:, :, t]
        if cell == 'lstm':
            gates = g + gh
            i = torch.sigmoid(gates[..., :H])
            f = torch.sigmoid(gates[..., H:2 * H])
            gg = torch.tanh(gates[..., 2 * H:3 * H])
            o = torch.sigmoid(gates[..., 3 * H:])
            c_new = f * c + i * gg
            h_new = o * torch.tanh(c_new)
        else:
            r = torch.sigmoid(g[..., :H] + gh[..., :H])
            z = torch.sigmoid(g[..., H:2 * H] + gh[..., H:2 * H])
            n = torch.tanh(g[..., 2 * H:] + r * gh[..., 2 * H:])
            h_new = (1.0 - z) * n + z * h
            c_new = c
        if full:
            h, c = h_new, c_new
        else:
            active = (t < lengths)[None, :, None]
            h = torch.where(active, h_new, h)
            c = torch.where(active, c_new, c)
        ys.append(h)
    y = torch.stack(ys, dim=2)                                  # (2, B, T, H)
    out = torch.cat([y[0], _time_gather(y[1], rev)], dim=-1)
    if full:
        return out
    valid = (torch.arange(T, device=x.device)[None, :]
             < lengths[:, None])[..., None]
    return torch.where(valid, out, torch.full_like(out, pad_value))


def length_regulate(h: torch.Tensor, dur: torch.Tensor, max_t: int
                    ) -> torch.Tensor:
    """Each phoneme of h (B, T, C) repeated round(max(dur, 0)) times
    (halves up), cut or zero-padded to max_t frames."""
    reps = torch.floor(torch.clamp(dur.float(), min=0.0) + 0.5).long()
    rows = []
    for b in range(h.shape[0]):
        r = torch.repeat_interleave(h[b], reps[b], dim=0)[:max_t]
        rows.append(F.pad(r, (0, 0, 0, max_t - r.shape[0])))
    return torch.stack(rows)


def masked_l1(x: torch.Tensor, target: torch.Tensor, lens: torch.Tensor
              ) -> torch.Tensor:
    """Mean absolute error over the valid positions (t < len) of (B, T) or
    (B, T, C) tensors, in float32."""
    x, target = x.float(), target.float()
    if x.dim() == 2:
        x, target = x[..., None], target[..., None]
    mask = (torch.arange(target.shape[1], device=x.device)[None, :]
            < lens[:, None])[..., None].float()
    total = torch.sum(torch.abs(x - target) * mask)
    return total / torch.clamp(mask.sum() * x.shape[-1], min=1.0)
