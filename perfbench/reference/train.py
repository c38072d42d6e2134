"""The reference's optimisation steps: the loss's gradient, clipping by
the global norm (optax's rule: scale min(1, c / ||g||)) and Adam with
bias correction (beta 0.9 / 0.999, eps 1e-8 outside the root), written
out in float32 on master weights; the forward may run in a lower type
through `dt`.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

BETAS = (0.9, 0.999)
EPS = 1e-8


def run_steps(params: Dict[str, torch.Tensor],
              loss_of: Callable[[Dict[str, torch.Tensor], int], torch.Tensor],
              n_steps: int, lr: float, clip: float) -> Dict[str, object]:
    """`n_steps` steps from `params` (float32, not modified). loss_of(P,
    step) is the step's loss for the weights P. Returns the losses, the
    first step's clipped gradient and the weights after the last step."""
    names = list(params)
    P = {n: params[n].detach().clone() for n in names}
    m = {n: torch.zeros_like(P[n]) for n in names}
    v = {n: torch.zeros_like(P[n]) for n in names}
    losses: List[float] = []
    first_grad: Dict[str, torch.Tensor] = {}
    for step in range(1, n_steps + 1):
        leaves = {n: P[n].requires_grad_(True) for n in names}
        loss = loss_of(leaves, step - 1)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names],
                                    allow_unused=True)
        losses.append(float(loss.detach()))
        grads = [torch.zeros_like(P[n]) if g is None else g.detach()
                 for n, g in zip(names, grads)]
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))
        scale = 1.0 if float(norm) < clip else clip / float(norm)
        with torch.no_grad():
            for n, g in zip(names, grads):
                g = g * scale
                if step == 1:
                    first_grad[n] = g.clone()
                m[n].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v[n].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                m_hat = m[n] / (1 - BETAS[0] ** step)
                v_hat = v[n] / (1 - BETAS[1] ** step)
                P[n] = (P[n] - lr * m_hat / (torch.sqrt(v_hat) + EPS)
                        ).detach()
    return {'losses': losses, 'first_grad': first_grad, 'final': P}


def leaf_gap(program: Dict[str, float], reference: Dict[str, float],
             leaves: Sequence[str]) -> Dict[str, object]:
    """The worst leaf's gap between two sets of leaf norms, |p - r| over
    the larger of r and the median of r over `leaves`; the median leaf's
    gap beside it."""
    ref = sorted(reference[n] for n in leaves)
    median = ref[len(ref) // 2]
    gaps = {n: abs(program[n] - reference[n]) / max(reference[n], median,
                                                    1e-30) for n in leaves}
    at = max(gaps, key=gaps.get)
    ordered = sorted(gaps.values())
    return {'gap': gaps[at], 'leaf': at, 'median': median,
            'median_gap': ordered[len(ordered) // 2]}
