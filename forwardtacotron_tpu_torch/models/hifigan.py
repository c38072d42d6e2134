"""HiFi-GAN generator (inference) and the GAN vocoders' loaders.

Mirrors `forwardtacotron_tpu/models/hifigan.py` in the (B, C, T) layout
of the official generator: the module names are the official
`state_dict` keys (conv_pre / ups.N / resblocks.N.convs{1,2}.M or
convs.M / conv_post), so an official checkpoint loads key for key once
its weight normalisation is folded into plain weights (w = g v / ||v||).
The convolutions are `F.conv1d` / `F.conv_transpose1d` on the model's
device. `make_generator` and `vocode_generator` (the JAX package's
`train/hifigan_trainer.py:72,91`) build and run either GAN generator.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from forwardtacotron_tpu_torch import resolve_device

LRELU_SLOPE = 0.1

# the official release's config_v1.json (22.05 kHz, hop 256): the default
# when a checkpoint comes without a config
V1_CONFIG = {
    'resblock': '1',
    'upsample_rates': [8, 8, 2, 2],
    'upsample_kernel_sizes': [16, 16, 4, 4],
    'upsample_initial_channel': 512,
    'resblock_kernel_sizes': [3, 7, 11],
    'resblock_dilation_sizes': [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
}


def _same_conv(channels: int, kernel: int, dilation: int = 1) -> nn.Conv1d:
    return nn.Conv1d(channels, channels, kernel, dilation=dilation,
                     padding=(kernel - 1) * dilation // 2)


class ResBlock1(nn.Module):
    """V1/V2 block: per dilation, lrelu -> dilated conv -> lrelu -> conv,
    added to the input."""

    def __init__(self, channels: int, kernel: int,
                 dilations: Sequence[int] = (1, 3, 5)) -> None:
        super().__init__()
        self.convs1 = nn.ModuleList([_same_conv(channels, kernel, d)
                                     for d in dilations])
        self.convs2 = nn.ModuleList([_same_conv(channels, kernel)
                                     for _ in dilations])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            y = c1(F.leaky_relu(x, LRELU_SLOPE))
            x = x + c2(F.leaky_relu(y, LRELU_SLOPE))
        return x


class ResBlock2(nn.Module):
    """V3 block: per dilation, lrelu -> dilated conv, added."""

    def __init__(self, channels: int, kernel: int,
                 dilations: Sequence[int] = (1, 3)) -> None:
        super().__init__()
        self.convs = nn.ModuleList([_same_conv(channels, kernel, d)
                                    for d in dilations])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.convs:
            x = x + c(F.leaky_relu(x, LRELU_SLOPE))
        return x


class HiFiGANGenerator(nn.Module):
    """mel (B, n_mels, T) -> waveform (B, T * prod(upsample_rates))."""

    def __init__(self, n_mels: int = 80, resblock: str = '1',
                 upsample_rates: Sequence[int] = (8, 8, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 upsample_initial_channel: int = 512,
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = (
                     (1, 3, 5), (1, 3, 5), (1, 3, 5))) -> None:
        super().__init__()
        self.n_mels = n_mels
        self.upsample_rates = tuple(upsample_rates)
        self.n_kernels = len(resblock_kernel_sizes)
        block = ResBlock1 if str(resblock) == '1' else ResBlock2
        ch = upsample_initial_channel
        self.conv_pre = nn.Conv1d(n_mels, ch, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for u, k in zip(upsample_rates, upsample_kernel_sizes):
            self.ups.append(nn.ConvTranspose1d(ch, ch // 2, k, u,
                                               padding=(k - u) // 2))
            ch //= 2
            for kr, dr in zip(resblock_kernel_sizes,
                              resblock_dilation_sizes):
                self.resblocks.append(block(ch, kr, tuple(dr)))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)
        self.eval()

    @classmethod
    def from_config(cls, config: Dict[str, Any], n_mels: int = 80
                    ) -> 'HiFiGANGenerator':
        """From an official config.json or the `hifigan.model` section of
        config.yaml; keys it lacks come from V1_CONFIG."""
        cfg = dict(V1_CONFIG)
        cfg.update({k: v for k, v in config.items() if k in V1_CONFIG})
        return cls(n_mels=n_mels, **cfg)

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.upsample_rates))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(mel)
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            blocks = self.resblocks[i * self.n_kernels:
                                    (i + 1) * self.n_kernels]
            x = sum(b(x) for b in blocks) / self.n_kernels
        # the official generator's last activation has torch's default
        # slope 0.01
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x)[:, 0]


# ------------------------------------------------------ weight normalisation

def fold_weight_norm(state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A state_dict with every weight_norm pair (`.weight_g`, `.weight_v`,
    norm over all dims but 0) folded into `.weight` = v (g / ||v||): a
    pair written by `weight_norm_state_dict` gives its weight back
    exactly."""
    out = {}
    for key, value in state_dict.items():
        value = torch.as_tensor(np.asarray(value)).float()
        if key.endswith('.weight_g'):
            continue
        if key.endswith('.weight_v'):
            base = key[:-len('.weight_v')]
            g = torch.as_tensor(np.asarray(state_dict[f'{base}.weight_g'])
                                ).float()
            norm = torch.sqrt((value ** 2).sum(
                dim=tuple(range(1, value.ndim)), keepdim=True))
            out[f'{base}.weight'] = value * (g / norm)
        else:
            out[key] = value
    return out


def weight_norm_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The inverse: every convolution of `model` as the weight_norm triple
    of a checkpoint written by torch's `weight_norm` (bias, then g = ||w||
    and v = w), the layout of official HiFi-GAN and hub MelGAN files."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
            w = m.weight.detach().float().cpu()
            out[f'{name}.bias'] = m.bias.detach().float().cpu().clone()
            out[f'{name}.weight_g'] = torch.sqrt((w ** 2).sum(
                dim=tuple(range(1, w.ndim)), keepdim=True))
            out[f'{name}.weight_v'] = w.clone()
    return out


# ------------------------------------------------------------------ loading

def make_generator(config: Dict[str, Any]) -> nn.Module:
    """The generator of `config['hifigan']['model']` with fresh weights:
    `generator_type` hifigan (default) or melgan."""
    from forwardtacotron_tpu_torch.models.melgan import MelGANGenerator
    model_cfg = config['hifigan']['model']
    n_mels = config['dsp']['num_mels']
    kind = str(model_cfg.get('generator_type', 'hifigan')).lower()
    if kind == 'melgan':
        return MelGANGenerator(
            n_mels=n_mels,
            base_channels=model_cfg.get('upsample_initial_channel', 512),
            upsample_rates=tuple(model_cfg.get('upsample_rates',
                                               (8, 8, 2, 2))))
    if kind != 'hifigan':
        raise ValueError(f'unknown generator_type: {kind}')
    return HiFiGANGenerator.from_config(model_cfg, n_mels=n_mels)


def _torch_file(path) -> Any:
    return torch.load(str(path), map_location='cpu', weights_only=True)


def load_hifigan(path, config: Optional[Dict[str, Any]] = None,
                 device='cuda') -> nn.Module:
    """A HiFi-GAN generator on `device` from the official torch file
    ({'generator': state_dict} or a bare state_dict, weight-normed; the
    config from `config`, else a config.json beside the file, else
    V1_CONFIG) or from a `.fjax` file of the JAX package's GAN trainer
    (its embedded config names the generator type, so a MelGAN `.fjax`
    loads here too)."""
    from forwardtacotron_tpu_torch.weights import (hifigan_state_dict,
                                                   load_fjax)
    device = resolve_device(device)
    path = Path(path)
    if path.suffix == '.fjax':
        payload = load_fjax(path, use_ema=False)
        model = make_generator(payload['config'])
        model.load_state_dict(hifigan_state_dict(
            payload['model'], payload['config']))
        return model.to(device).eval()
    if config is None:
        cand = path.parent / 'config.json'
        if cand.exists():
            with open(cand, encoding='utf-8') as f:
                config = json.load(f)
        else:
            config = V1_CONFIG
    ckpt = _torch_file(path)
    sd = fold_weight_norm(ckpt.get('generator', ckpt))
    model = HiFiGANGenerator.from_config(
        config, n_mels=sd['conv_pre.weight'].shape[1])
    model.load_state_dict(sd)
    return model.to(device).eval()


def load_gan_vocoder(path, voc_type: str = 'auto',
                     config: Optional[Dict[str, Any]] = None,
                     device='cuda') -> nn.Module:
    """Either GAN generator from any supported file. `.fjax` files name
    their generator type; for torch files `voc_type='auto'` sniffs the
    keys: HiFi-GAN files carry conv_pre / ups.* / resblocks keys, MelGAN
    hub files positional keys or a `model_g` wrapper."""
    if voc_type not in ('auto', 'hifigan', 'melgan'):
        raise ValueError(f'unknown voc_type: {voc_type}')
    path = Path(path)
    if path.suffix == '.fjax':
        return load_hifigan(path, config, device)
    if voc_type == 'auto':
        ckpt = _torch_file(path)
        if isinstance(ckpt, dict) and 'model_g' in ckpt:
            voc_type = 'melgan'
        else:
            sd = ckpt.get('generator', ckpt) if isinstance(ckpt, dict) \
                else ckpt
            hifi = any('conv_pre' in k or k.startswith('ups.')
                       or '.ups.' in k or 'resblocks' in k
                       for k in getattr(sd, 'keys', list)())
            voc_type = 'hifigan' if hifi else 'melgan'
    if voc_type == 'melgan':
        from forwardtacotron_tpu_torch.models.melgan import load_melgan
        return load_melgan(path, device=device)
    return load_hifigan(path, config, device)


# ----------------------------------------------------------------- vocoding

def bucketed_mel(mel, n_mels: int, frame_bucket: int, mode: str,
                 device) -> Tuple[torch.Tensor, int]:
    """A mel ((n_mels, T) or (T, n_mels)) as (1, n_mels, T_pad) on
    `device`, T padded to a `frame_bucket` multiple ('constant' zeros or
    'edge'), and its true T."""
    mel = np.asarray(mel, np.float32)
    if mel.ndim != 2:
        raise ValueError(f'mel must be 2-D, got {mel.shape}')
    if mel.shape[0] == n_mels and mel.shape[1] != n_mels:
        mel = mel.T                                   # -> (T, n_mels)
    t = mel.shape[0]
    t_pad = -(-t // frame_bucket) * frame_bucket
    mel = np.pad(mel, ((0, t_pad - t), (0, 0)), mode=mode)
    return torch.as_tensor(mel.T[None].copy(), device=device), t


@torch.no_grad()
def run_generator(model: nn.Module, mel, frame_bucket: int, mode: str,
                  pcm16: bool) -> np.ndarray:
    """Bucketed generator run on the model's device, exact trim."""
    device = next(model.parameters()).device
    x, t = bucketed_mel(mel, model.n_mels, frame_bucket, mode, device)
    wav = model(x)[0]
    if pcm16:
        wav = (torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)
    return wav[:t * model.hop_length].cpu().numpy()


def vocode_hifigan(model: HiFiGANGenerator, mel, frame_bucket: int = 64,
                   pcm16: bool = False) -> np.ndarray:
    """mel (n_mels, T) or (T, n_mels) -> waveform (T * hop,): T zero-padded
    to a `frame_bucket` multiple, the output trimmed exactly."""
    return run_generator(model, mel, frame_bucket, 'constant', pcm16)


def vocode_generator(gen: nn.Module, mel, pcm16: bool = False
                     ) -> np.ndarray:
    """Whole-utterance vocoding with either generator type."""
    from forwardtacotron_tpu_torch.models.melgan import (MelGANGenerator,
                                                         vocode_melgan)
    if isinstance(gen, MelGANGenerator):
        return vocode_melgan(gen, mel, pcm16=pcm16)
    return vocode_hifigan(gen, mel, pcm16=pcm16)
