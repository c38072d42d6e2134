"""LengthRegulator: duration-driven upsampling as a fixed-shape gather.

    reps   = floor(max(dur, 0) + 0.5)
    ends   = cumsum(reps)                      # phoneme end frames
    idx[t] = searchsorted(ends, t, right)      # frame -> phoneme map
    out    = x[min(idx, T-1)], zero beyond the total length

The output has a static `max_t` frames; the true mel lengths come back
beside it. The output is differentiable in x: autograd's backward of the
gather is a scatter-add over the frames of each phoneme (the JAX package
computes the same sum as a one-hot matmul). Durations get no gradient:
the frame map goes through rounding.
"""
from __future__ import annotations

from typing import Tuple

import torch


def length_regulate(x: torch.Tensor, dur: torch.Tensor, max_t: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand x (B, T, C) by durations dur (B, T) -> (B, max_t, C).
    Returns (expanded, total_lengths (B,) int64); totals are not clipped
    to `max_t`."""
    reps = torch.floor(torch.clamp(dur.float(), min=0.0) + 0.5).long()
    ends = torch.cumsum(reps, dim=1)                       # (B, T)
    frames = torch.arange(max_t, device=x.device)
    idx = torch.searchsorted(ends, frames[None, :].expand(x.shape[0], -1)
                             .contiguous(), right=True)
    idx = torch.clamp(idx, max=x.shape[1] - 1)
    out = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))
    total = ends[:, -1]
    valid = frames[None, :] < total[:, None]
    out = torch.where(valid[..., None], out, torch.zeros_like(out))
    return out, total
