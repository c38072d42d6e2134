"""Discretized mixture-of-logistics sampling (inference only).

`y` holds [logit_probs | means | log_scales], nr_mix = y.shape[-1] // 3.
Uniform noise comes in as arguments, so the same draws can feed this
function and the sampling kernel.
"""
from __future__ import annotations

import math

import torch

LOG_SCALE_MIN = math.log(1e-14)


def greedy_from_discretized_mix_logistic(y: torch.Tensor) -> torch.Tensor:
    """The mean of the most likely mixture component, in [-1, 1]."""
    nr_mix = y.shape[-1] // 3
    k = torch.argmax(y[..., :nr_mix], dim=-1, keepdim=True)
    means = torch.gather(y[..., nr_mix:2 * nr_mix], -1, k)[..., 0]
    return torch.clamp(means, -1.0, 1.0)


def sample_from_discretized_mix_logistic(
        y: torch.Tensor, u_mix: torch.Tensor, u: torch.Tensor,
        log_scale_min: float = LOG_SCALE_MIN) -> torch.Tensor:
    """y (..., 3*nr_mix); u_mix (..., nr_mix) and u (...) uniform draws in
    (0, 1), clipped here to [1e-5, 1 - 1e-5]. Gumbel-max picks the
    component, then a logistic inverse-CDF draws the sample."""
    nr_mix = y.shape[-1] // 3
    u_mix = torch.clamp(u_mix, 1e-5, 1.0 - 1e-5)
    temp = y[..., :nr_mix] - torch.log(-torch.log(u_mix))
    k = torch.argmax(temp, dim=-1, keepdim=True)
    means = torch.gather(y[..., nr_mix:2 * nr_mix], -1, k)[..., 0]
    log_scales = torch.clamp(
        torch.gather(y[..., 2 * nr_mix:3 * nr_mix], -1, k)[..., 0],
        min=log_scale_min)
    u = torch.clamp(u, 1e-5, 1.0 - 1e-5)
    x = means + torch.exp(log_scales) * (torch.log(u) - torch.log(1.0 - u))
    return torch.clamp(x, -1.0, 1.0)
