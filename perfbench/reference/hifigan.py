"""Plain PyTorch reference of the HiFi-GAN generator (jik876/hifi-gan,
models.py `Generator` with `ResBlock1`, config_v1.json): conv_pre (k=7),
per upsampling stage a leaky ReLU (0.1) and a transposed conv, then the
mean of the stage's resblocks (per dilation: lrelu, dilated conv, lrelu,
conv, residual), a leaky ReLU of torch's default slope 0.01, conv_post
(k=7) and tanh. Weights come weight-normalised (w = g v / ||v||, the
norm over all dims but the first), as the official files store them.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch
from torch.nn import functional as F

from perfbench.reference import spec

LRELU = 0.1


def weight_spec(gcfg: Dict[str, Any], n_mels: int) -> List[spec.Entry]:
    ch = gcfg['upsample_initial_channel']
    out = spec.conv('conv_pre', n_mels, ch, 7)
    for i, (u, k) in enumerate(zip(gcfg['upsample_rates'],
                                   gcfg['upsample_kernel_sizes'])):
        out += spec.conv_transpose(f'ups.{i}', ch, ch // 2, k)
        ch //= 2
    ch = gcfg['upsample_initial_channel']
    j = 0
    for i in range(len(gcfg['upsample_rates'])):
        ch //= 2
        for kr, dr in zip(gcfg['resblock_kernel_sizes'],
                          gcfg['resblock_dilation_sizes']):
            for c in ('convs1', 'convs2'):
                for n in range(len(dr)):
                    out += spec.conv(f'resblocks.{j}.{c}.{n}', ch, ch, kr)
            j += 1
    out += spec.conv('conv_post', ch, 1, 7)
    return out


def weight_norm_file(weights: Dict[str, torch.Tensor], gcfg: Dict[str, Any],
                     directory: Path) -> Path:
    """The generator as an official file: {'generator': state_dict} with
    every convolution as bias, weight_g = ||w|| and weight_v = w, and the
    config.json beside it."""
    directory.mkdir(parents=True, exist_ok=True)
    sd = {}
    for name, w in weights.items():
        w = w.detach().float().cpu()
        if name.endswith('.weight'):
            base = name[:-len('.weight')]
            sd[f'{base}.weight_g'] = torch.sqrt(
                (w ** 2).sum(dim=tuple(range(1, w.ndim)), keepdim=True))
            sd[f'{base}.weight_v'] = w.clone()
        else:
            sd[name] = w.clone()
    path = directory / 'generator.pt'
    torch.save({'generator': sd}, str(path))
    (directory / 'config.json').write_text(json.dumps(gcfg))
    return path


def read_weights(path: Path, device) -> Dict[str, torch.Tensor]:
    """The file's convolutions with weight normalisation folded."""
    sd = torch.load(str(path), map_location='cpu',
                    weights_only=True)['generator']
    out = {}
    for key, value in sd.items():
        if key.endswith('.weight_g'):
            continue
        if key.endswith('.weight_v'):
            base = key[:-len('.weight_v')]
            g = sd[f'{base}.weight_g'].to(device)
            v = value.to(device)
            norm = torch.sqrt((v ** 2).sum(dim=tuple(range(1, v.ndim)),
                                           keepdim=True))
            out[f'{base}.weight'] = v * (g / norm)
        else:
            out[key] = value.to(device)
    return out


@torch.no_grad()
def generate(W: Dict[str, torch.Tensor], gcfg: Dict[str, Any],
             mel: torch.Tensor, dt=torch.float32) -> torch.Tensor:
    """mel (n_mels, T) -> waveform (T * hop,) in float32."""
    def conv(x, name, dilation=1):
        w = W[f'{name}.weight'].to(dt)
        pad = (w.shape[-1] - 1) * dilation // 2
        return F.conv1d(x, w, W[f'{name}.bias'].to(dt), padding=pad,
                        dilation=dilation)

    x = conv(mel[None].to(dt), 'conv_pre')
    n_k = len(gcfg['resblock_kernel_sizes'])
    for i, (u, k) in enumerate(zip(gcfg['upsample_rates'],
                                   gcfg['upsample_kernel_sizes'])):
        x = F.conv_transpose1d(F.leaky_relu(x, LRELU),
                               W[f'ups.{i}.weight'].to(dt),
                               W[f'ups.{i}.bias'].to(dt), stride=u,
                               padding=(k - u) // 2)
        xs = None
        for j, dil in enumerate(gcfg['resblock_dilation_sizes']):
            b = f'resblocks.{i * n_k + j}'
            y = x
            for n, d in enumerate(dil):
                t = conv(F.leaky_relu(y, LRELU), f'{b}.convs1.{n}', d)
                y = y + conv(F.leaky_relu(t, LRELU), f'{b}.convs2.{n}')
            xs = y if xs is None else xs + y
        x = xs / n_k
    x = conv(F.leaky_relu(x, 0.01), 'conv_post')
    return torch.tanh(x)[0, 0].float()


def pcm16(wav: torch.Tensor) -> np.ndarray:
    """Float samples -> int16 PCM: clipped to [-1, 1], scaled by 32767,
    truncated toward zero."""
    return (torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16
                                                     ).cpu().numpy()


def vocode(W: Dict[str, torch.Tensor], gcfg: Dict[str, Any],
           mel: torch.Tensor, frame_bucket: int = 64,
           dt=torch.float32) -> np.ndarray:
    """A served mel (T, n_mels) -> int16 PCM of T * hop samples: the mel
    zero-padded to a `frame_bucket` multiple of frames, as served, and the
    output cut to the true length."""
    T = mel.shape[0]
    hop = int(np.prod(gcfg['upsample_rates']))
    t_pad = -(-T // frame_bucket) * frame_bucket
    padded = F.pad(mel.float().T, (0, t_pad - T))
    return pcm16(generate(W, gcfg, padded, dt)[:T * hop])
