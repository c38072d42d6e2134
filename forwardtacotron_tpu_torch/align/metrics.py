"""Attention quality scores: a port of the JAX package's
`align/metrics.py` (the reference's utils/metrics.py:4-31).

The location score measures monotonicity (the share of adjacent argmax
moves of at most r), the sharpness score the mean peak attention; both
are masked by mel_len // r. The forward model's data layer filters its
items by them.
"""
from __future__ import annotations

from typing import Tuple

import torch


def attention_score(att: torch.Tensor, mel_lens: torch.Tensor, r: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """att (B, T_dec, T_text); mel_lens (B,) int. Returns (loc, sharp),
    each (B,) float32, on att's device."""
    t_max = att.shape[1]
    mel_lens = mel_lens.to(att.device) // r
    mask = (torch.arange(t_max, device=att.device)[None, :]
            < mel_lens[:, None]).float()
    max_loc = att.argmax(dim=2)
    max_loc_diff = (max_loc[:, 1:] - max_loc[:, :-1]).abs()
    loc_score = ((max_loc_diff >= 0) & (max_loc_diff <= r)).float()
    loc_score = (loc_score * mask[:, 1:]).sum(dim=1)
    loc_score = loc_score / torch.clamp(mel_lens - 1, min=1)
    sharp_score = (att.max(dim=2).values * mask).mean(dim=1)
    return loc_score, sharp_score
