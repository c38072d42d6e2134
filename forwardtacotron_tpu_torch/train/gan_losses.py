"""Adversarial vocoder losses: LSGAN, feature matching and mel L1.

Mirrors `forwardtacotron_tpu/train/gan_losses.py` (the official HiFi-GAN
recipe) over the (logits, feature-map) lists of
`models/gan_discriminators.py`:

- discriminator: sum_d mean((1 - D_d(y))^2) + mean(D_d(y_hat)^2)
- generator adversarial: sum_d mean((1 - D_d(y_hat))^2)
- feature matching: 2 * sum_d sum_layers mean(|f_r - f_g|)
- mel reconstruction: 45 * mean(|mel(y_hat) - mel(y)|), with a
  differentiable log-mel (`DSP.wav_to_mel_batch`, `dsp/stft.py:wav_to_mel`,
  the convention of the JAX package's `wav_to_mel_fn`).
"""
from __future__ import annotations

from typing import Callable, List

import torch

FM_WEIGHT = 2.0
MEL_WEIGHT = 45.0


def discriminator_loss(logits_real: List[torch.Tensor],
                       logits_gen: List[torch.Tensor]) -> torch.Tensor:
    return sum(torch.mean((1.0 - lr) ** 2) + torch.mean(lg ** 2)
               for lr, lg in zip(logits_real, logits_gen))


def generator_adversarial_loss(logits_gen: List[torch.Tensor]
                               ) -> torch.Tensor:
    return sum(torch.mean((1.0 - lg) ** 2) for lg in logits_gen)


def feature_matching_loss(fmaps_real: List[List[torch.Tensor]],
                          fmaps_gen: List[List[torch.Tensor]]
                          ) -> torch.Tensor:
    return FM_WEIGHT * sum(torch.mean(torch.abs(fr - fg))
                           for fr_list, fg_list in zip(fmaps_real, fmaps_gen)
                           for fr, fg in zip(fr_list, fg_list))


def mel_l1_loss(wav_to_mel: Callable[[torch.Tensor], torch.Tensor],
                y: torch.Tensor, y_hat: torch.Tensor) -> torch.Tensor:
    return MEL_WEIGHT * torch.mean(torch.abs(wav_to_mel(y_hat)
                                             - wav_to_mel(y)))
