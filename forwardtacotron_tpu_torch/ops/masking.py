"""Length masks over the time axis of (B, T, ...) tensors."""
from __future__ import annotations

from typing import Optional

import torch


def pad_mask(lens: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) bool mask, True where t < len."""
    return torch.arange(max_len, device=lens.device)[None, :] < lens[:, None]


def time_mask(x: torch.Tensor, lengths: Optional[torch.Tensor],
              fill: float = 0.0) -> torch.Tensor:
    """Replace positions t >= lengths[b] of x (B, T, C) by `fill`."""
    if lengths is None:
        return x
    mask = pad_mask(lengths, x.shape[1])[:, :, None]
    return torch.where(mask, x, torch.full_like(x, fill))

