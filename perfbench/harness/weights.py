"""Weights drawn from the run's seed: one uniform draw on the device for
every random tensor of a specification, cut and scaled per tensor;
constants filled. The same seed on the same device gives the same
weights, so the reference draws them again after the program is gone."""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from perfbench.reference.spec import Entry


def sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for stream `tag` of the run's seed."""
    return (int(seed) * 1_000_003 + 7919 * int(tag)) % (2 ** 63 - 1)


def draw(entries: List[Entry], seed: int, device) -> Dict[str, torch.Tensor]:
    device = torch.device(device)
    total = sum(math.prod(shape) for _, shape, init in entries
                if init[0] == 'uniform')
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    flat = torch.empty(total, device=device).uniform_(-1.0, 1.0,
                                                      generator=gen)
    out, at = {}, 0
    for name, shape, (kind, value) in entries:
        n = math.prod(shape)
        if kind == 'uniform':
            out[name] = (flat[at:at + n] * value).reshape(shape)
            at += n
        else:
            out[name] = torch.full(shape, value, device=device)
    return out
