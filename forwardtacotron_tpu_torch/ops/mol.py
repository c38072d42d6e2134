"""Discretized mixture of logistics: sampling and the training loss.

`y` holds [logit_probs | means | log_scales], nr_mix = y.shape[-1] // 3.
Uniform noise comes in as arguments, so the same draws can feed the
samplers here and the sampling kernel. The loss is the JAX package's
`ops/mol.py:discretized_mix_logistic_loss`.
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as F

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


def log_sum_exp(x: torch.Tensor) -> torch.Tensor:
    """log(sum(exp(x))) over the last axis, shifted by its maximum."""
    m = torch.amax(x, dim=-1)
    return m + torch.log(torch.sum(torch.exp(x - m[..., None]), dim=-1))


def discretized_mix_logistic_loss(y_hat: torch.Tensor, y: torch.Tensor,
                                  num_classes: int = 65536,
                                  log_scale_min: float = LOG_SCALE_MIN,
                                  reduce: bool = True) -> torch.Tensor:
    """Negative log-likelihood of y (B, T) or (B, T, 1) in [-1, 1] under
    the mixture y_hat (B, T, 3*nr_mix), time-major; the mean over every
    sample where `reduce`, else (B, T, 1). The JAX package's
    `ops/mol.py:discretized_mix_logistic_loss` (the reference's
    utils/distribution.py), with its edge cases: the CDF at the two ends,
    and the density at the centre where a bin's mass underflows."""
    if y.ndim == 2:
        y = y[..., None]
    nr_mix = y_hat.shape[-1] // 3
    logit_probs = y_hat[..., :nr_mix]
    means = y_hat[..., nr_mix:2 * nr_mix]
    log_scales = torch.clamp(y_hat[..., 2 * nr_mix:3 * nr_mix],
                             min=log_scale_min)

    centered_y = y - means
    inv_stdv = torch.exp(-log_scales)
    plus_in = inv_stdv * (centered_y + 1.0 / (num_classes - 1))
    cdf_plus = torch.sigmoid(plus_in)
    min_in = inv_stdv * (centered_y - 1.0 / (num_classes - 1))
    cdf_min = torch.sigmoid(min_in)

    log_cdf_plus = plus_in - F.softplus(plus_in)
    log_one_minus_cdf_min = -F.softplus(min_in)
    cdf_delta = cdf_plus - cdf_min
    mid_in = inv_stdv * centered_y
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)

    inner_inner_cond = (cdf_delta > 1e-5).float()
    inner_inner_out = (
        inner_inner_cond * torch.log(torch.clamp(cdf_delta, min=1e-12))
        + (1.0 - inner_inner_cond)
        * (log_pdf_mid - math.log((num_classes - 1) / 2)))
    inner_cond = (y > 0.999).float()
    inner_out = (inner_cond * log_one_minus_cdf_min
                 + (1.0 - inner_cond) * inner_inner_out)
    cond = (y < -0.999).float()
    log_probs = cond * log_cdf_plus + (1.0 - cond) * inner_out

    log_probs = log_probs + F.log_softmax(logit_probs, dim=-1)
    if reduce:
        return -torch.mean(log_sum_exp(log_probs))
    return -log_sum_exp(log_probs)[..., None]
