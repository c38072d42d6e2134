"""Length masks over the time axis of (B, T, ...) tensors, and the
masked L1 loss of training."""
from __future__ import annotations

from typing import Optional

import torch

from forwardtacotron_tpu_torch.parallel.mesh import spans_ranks, sum_over_ranks


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


def masked_l1(x: torch.Tensor, target: torch.Tensor, lens: torch.Tensor
              ) -> torch.Tensor:
    """Mean absolute error over valid (t < len) positions, normalized by
    the channel-expanded mask sum as the reference's MaskedL1 does.
    Inside `parallel.data_parallel` over n > 1 ranks the count is the
    global batch's: each rank's sum over its rows is divided by the
    global count / n, so that the ranks' mean is the global loss.

    x, target: (B, T, C) or (B, T); lens: (B,)."""
    if x.dim() == 2:
        x, target = x[..., None], target[..., None]
    mask = pad_mask(lens, target.shape[1])[..., None].to(x.dtype)
    loss = torch.sum(torch.abs(x * mask - target * mask))
    count = mask.sum() * x.shape[-1]
    mesh = spans_ranks()
    if mesh is None:
        return loss / torch.clamp(count, min=1.0)
    return loss / (torch.clamp(sum_over_ranks(count), min=1.0) / mesh.size)
