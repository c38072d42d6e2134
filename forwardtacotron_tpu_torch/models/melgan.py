"""MelGAN generator (inference), the torch.hub model's architecture.

Mirrors `forwardtacotron_tpu/models/melgan.py` as the hub model's own
module tree: `generator` is a Sequential of a reflection-padded stem
conv, four stages of [lrelu, ConvTranspose1d, ResStack] and a
reflection-padded head conv with tanh, so its `state_dict` keys are the
hub file's once weight normalisation is folded. Checkpoints are matched
POSITIONALLY, convolution by convolution with shape checks, as the JAX
converter does, so forks that name the layers otherwise load as long as
the architecture agrees.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from forwardtacotron_tpu_torch import resolve_device
from forwardtacotron_tpu_torch.models.hifigan import (_torch_file,
                                                      fold_weight_norm,
                                                      run_generator)

LRELU = 0.2


class ResStack(nn.Module):
    """Three dilated residual blocks with 1x1 shortcuts:
    x = shortcut(x) + conv1x1(lrelu(conv_d(pad(lrelu(x)))))."""

    def __init__(self, channels: int, n_blocks: int = 3) -> None:
        super().__init__()
        self.blocks = nn.ModuleList([nn.Sequential(
            nn.LeakyReLU(LRELU), nn.ReflectionPad1d(3 ** i),
            nn.Conv1d(channels, channels, 3, dilation=3 ** i),
            nn.LeakyReLU(LRELU), nn.Conv1d(channels, channels, 1))
            for i in range(n_blocks)])
        self.shortcuts = nn.ModuleList([nn.Conv1d(channels, channels, 1)
                                        for _ in range(n_blocks)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block, shortcut in zip(self.blocks, self.shortcuts):
            x = shortcut(x) + block(x)
        return x


class MelGANGenerator(nn.Module):
    """mel (B, n_mels, T) -> waveform (B, T * prod(upsample_rates))."""

    def __init__(self, n_mels: int = 80, base_channels: int = 512,
                 upsample_rates: Sequence[int] = (8, 8, 2, 2)) -> None:
        super().__init__()
        self.n_mels = n_mels
        self.upsample_rates = tuple(upsample_rates)
        ch = base_channels
        layers: List[nn.Module] = [nn.ReflectionPad1d(3),
                                   nn.Conv1d(n_mels, ch, 7)]
        for r in upsample_rates:
            layers += [nn.LeakyReLU(LRELU),
                       nn.ConvTranspose1d(ch, ch // 2, 2 * r, r,
                                          padding=r // 2),
                       ResStack(ch // 2)]
            ch //= 2
        layers += [nn.LeakyReLU(LRELU), nn.ReflectionPad1d(3),
                   nn.Conv1d(ch, 1, 7), nn.Tanh()]
        self.generator = nn.Sequential(*layers)
        self.eval()

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.upsample_rates))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return self.generator(mel)[:, 0]


def _ordered_convs(sd: Dict[str, torch.Tensor]
                   ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(weight, bias) pairs in state-dict order (weight norm folded)."""
    return [(sd[k], sd[f'{k[:-len(".weight")]}.bias']) for k in sd
            if k.endswith('.weight') and f'{k[:-len(".weight")]}.bias' in sd]


def _conv_modules(model: nn.Module) -> List[Tuple[str, nn.Module]]:
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d))]


def convert_melgan_generator(state_dict: Dict[str, Any],
                             model: MelGANGenerator
                             ) -> Dict[str, torch.Tensor]:
    """A hub-lineage state_dict (any key prefix, weight-normed or not) as
    `model`'s state_dict: the convolutions matched in order (stem; per
    stage the transposed conv, the three dilated/1x1 pairs, the three
    shortcuts; head), each shape-checked."""
    convs = _ordered_convs(fold_weight_norm(state_dict))
    slots = _conv_modules(model)
    if len(convs) != len(slots):
        raise ValueError(f'checkpoint has {len(convs)} conv layers, the '
                         f'generator defines {len(slots)}: architecture '
                         'mismatch')
    out = {}
    for (name, m), (w, b) in zip(slots, convs):
        if w.shape != m.weight.shape or b.shape != m.bias.shape:
            raise ValueError(f'{name}: checkpoint weight {tuple(w.shape)} '
                             f'does not fit {tuple(m.weight.shape)}')
        out[f'{name}.weight'], out[f'{name}.bias'] = w, b
    return out


def load_melgan(path, upsample_rates: Sequence[int] = (8, 8, 2, 2),
                device='cuda') -> MelGANGenerator:
    """A MelGAN generator on `device` from a torch file: a bare state_dict
    or one wrapped as {'model_g' | 'generator' | 'state_dict': sd}; n_mels
    and the base width come from the stem convolution."""
    device = resolve_device(device)
    ckpt = _torch_file(path)
    if isinstance(ckpt, dict):
        for key in ('model_g', 'generator', 'state_dict'):
            if key in ckpt and isinstance(ckpt[key], dict):
                ckpt = ckpt[key]
                break
    stem = _ordered_convs(fold_weight_norm(ckpt))[0][0]
    model = MelGANGenerator(n_mels=stem.shape[1],
                            base_channels=stem.shape[0],
                            upsample_rates=tuple(upsample_rates))
    model.load_state_dict(convert_melgan_generator(ckpt, model))
    return model.to(device).eval()


def vocode_melgan(model: MelGANGenerator, mel, frame_bucket: int = 64,
                  pcm16: bool = False) -> np.ndarray:
    """mel (n_mels, T) or (T, n_mels) -> waveform (T * hop,): T padded
    with its last frame to a `frame_bucket` multiple, trimmed exactly."""
    return run_generator(model, mel, frame_bucket, 'edge', pcm16)
