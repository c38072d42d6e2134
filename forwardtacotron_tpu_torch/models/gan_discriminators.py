"""HiFi-GAN discriminators: multi-period and multi-scale.

Mirrors `forwardtacotron_tpu/models/gan_discriminators.py` (the official
HiFi-GAN setup's MPD and MSD) in the channels-first layout of
`F.conv2d` / `F.conv1d`:

- `PeriodDiscriminator` p (p in 2, 3, 5, 7, 11): audio (B, T) reflect-
  padded to a multiple of p and seen as (B, 1, T/p, p), through 2-D convs
  of kernel (5, 1) and stride (3, 1);
- `ScaleDiscriminator`: grouped 1-D convs over (B, 1, T), on x,
  avgpool(x) and avgpool(avgpool(x)) (kernel 4, stride 2, padding 2,
  padded zeros counted, as flax's `avg_pool`).

Plain convolutions, without weight or spectral norm, as in the JAX
package. Each sub-discriminator returns (logits (B, N), feature maps);
the maps are channels-first, (B, C, T/p, p) and (B, C, T'), where the JAX
package's are channels-last. The losses (`train/gan_losses.py`) compare
real against generated maps of one layout, element for element, so their
values do not depend on it. `discriminator_state_dict` in `weights.py`
takes the JAX package's parameters.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

LRELU_SLOPE = 0.1
PERIOD_CHANNELS = (32, 128, 512, 1024)
# (out channels, kernel, stride, groups) of the scale discriminator's convs
SCALE_SPECS = ((128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16),
               (512, 41, 4, 16), (1024, 41, 4, 16), (1024, 41, 1, 16),
               (1024, 5, 1, 1))

Output = Tuple[torch.Tensor, List[torch.Tensor]]


class PeriodDiscriminator(nn.Module):

    def __init__(self, period: int) -> None:
        super().__init__()
        self.period = period
        chans = (1,) + PERIOD_CHANNELS
        convs = [nn.Conv2d(cin, cout, (5, 1), (3, 1), padding=(2, 0))
                 for cin, cout in zip(chans, chans[1:])]
        convs.append(nn.Conv2d(chans[-1], 1024, (5, 1), padding=(2, 0)))
        self.convs = nn.ModuleList(convs)
        self.conv_post = nn.Conv2d(1024, 1, (3, 1), padding=(1, 0))

    def forward(self, x: torch.Tensor) -> Output:
        b, t = x.shape
        p = self.period
        pad = (p - t % p) % p
        if pad:
            x = F.pad(x[:, None], (0, pad), mode='reflect')[:, 0]
        x = x.reshape(b, 1, -1, p)
        fmaps = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmaps.append(x)
        x = self.conv_post(x)
        fmaps.append(x)
        return x.reshape(b, -1), fmaps


class ScaleDiscriminator(nn.Module):

    def __init__(self) -> None:
        super().__init__()
        convs, cin = [], 1
        for cout, k, s, g in SCALE_SPECS:
            convs.append(nn.Conv1d(cin, cout, k, s, padding=k // 2,
                                   groups=g))
            cin = cout
        self.convs = nn.ModuleList(convs)
        self.conv_post = nn.Conv1d(cin, 1, 3, padding=1)

    def forward(self, x: torch.Tensor) -> Output:
        b = x.shape[0]
        x = x[:, None]
        fmaps = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmaps.append(x)
        x = self.conv_post(x)
        fmaps.append(x)
        return x.reshape(b, -1), fmaps


def avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(B, T) -> (B, T // 2 + 1): the JAX package's `_avg_pool1d`."""
    return F.avg_pool1d(x[:, None], 4, 2, padding=2,
                        count_include_pad=True)[:, 0]


class HiFiGANDiscriminators(nn.Module):
    """MPD and MSD in one module. `forward(y, y_hat)` returns
    (logits_real, logits_gen, fmaps_real, fmaps_gen), one entry per
    sub-discriminator (the periods, then the scales). Real and generated
    audio go through each convolution as one batch."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 n_scales: int = 3) -> None:
        super().__init__()
        self.mpd = nn.ModuleList([PeriodDiscriminator(p) for p in periods])
        self.msd = nn.ModuleList([ScaleDiscriminator()
                                  for _ in range(n_scales)])

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        b = y.shape[0]
        logits_r, logits_g, fmaps_r, fmaps_g = [], [], [], []

        def run(d, x):
            logits, fmaps = d(x)
            logits_r.append(logits[:b])
            logits_g.append(logits[b:])
            fmaps_r.append([f[:b] for f in fmaps])
            fmaps_g.append([f[b:] for f in fmaps])

        x = torch.cat([y, y_hat])
        for d in self.mpd:
            run(d, x)
        for i, d in enumerate(self.msd):
            if i > 0:
                x = avg_pool(x)
            run(d, x)
        return logits_r, logits_g, fmaps_r, fmaps_g
