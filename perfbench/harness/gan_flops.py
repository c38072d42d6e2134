"""Model FLOPs of HiFi-GAN's adversarial training step, from its shapes.

A forward's FLOPs are twice the multiply-adds of its convolutions, as
`torch.utils.flop_counter.FlopCounterMode` counts them (a transposed
convolution over its input's length, a grouped one over its channels per
group); activations, pads, pools, the mel loss and the optimizers are
left out. A step (`gan_step_flops`) counts the work the model needs, as
jik876/hifi-gan's train.py does it: one generation (G); the
discriminators' update on it detached, their forward over real and
generated audio and their backward's two products (3 D); the
generator's update, the discriminators' forward over both waveforms
(the real feature maps are the feature-matching targets) and the
backward's products towards the generated input alone (1.5 D), then
the generator's backward (2 G): 3 G + 4.5 D, where D runs over both
waveforms of every row. The first layers' input gradients that nothing
needs are counted with the rest (under 0.1% of a step).

`gan_train_step` does G + 0.5 D more: it generates again, without
gradient, for the discriminators' update, and its generator's update
takes the discriminators' input gradient over the real rows too, since
they run as one batch with the generated ones.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

# the discriminators' convolutions: MPD channels; MSD (out, kernel,
# stride, groups), the layouts of perfbench/reference/hifigan_gan.py
PERIODS = (2, 3, 5, 7, 11)
PERIOD_CHANNELS = (1, 32, 128, 512, 1024)
SCALE_SPECS = ((128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16),
               (512, 41, 4, 16), (1024, 41, 4, 16), (1024, 41, 1, 16),
               (1024, 5, 1, 1))
N_SCALES = 3


def _out_len(t: int, k: int, stride: int, pad: int) -> int:
    return (t + 2 * pad - k) // stride + 1


def generator_flops(gcfg: Dict[str, Any], n_mels: int, B: int,
                    frames: int) -> float:
    """Forward FLOPs of the generator on B mels of `frames` frames."""
    ch = gcfg['upsample_initial_channel']
    t = frames
    f = 2.0 * B * t * n_mels * ch * 7
    kernels: Sequence[int] = gcfg['resblock_kernel_sizes']
    dilations = gcfg['resblock_dilation_sizes']
    for u, k in zip(gcfg['upsample_rates'], gcfg['upsample_kernel_sizes']):
        f += 2.0 * B * t * ch * (ch // 2) * k
        ch //= 2
        t *= u
        for kr, dr in zip(kernels, dilations):
            f += 2 * len(dr) * 2.0 * B * t * ch * ch * kr
    return f + 2.0 * B * t * ch * 7


def discriminator_flops(N: int, T: int) -> float:
    """Forward FLOPs of the MPD and MSD on N waveforms of T samples."""
    f = 0.0
    for p in PERIODS:
        h = -(-T // p)
        for cin, cout in zip(PERIOD_CHANNELS, PERIOD_CHANNELS[1:]):
            h = _out_len(h, 5, 3, 2)
            f += 2.0 * N * h * p * cin * cout * 5
        f += 2.0 * N * h * p * 1024 * 1024 * 5
        f += 2.0 * N * h * p * 1024 * 3
    t = T
    for i in range(N_SCALES):
        if i > 0:
            t = _out_len(t, 4, 2, 2)
        tt, cin = t, 1
        for cout, k, s, g in SCALE_SPECS:
            tt = _out_len(tt, k, s, k // 2)
            f += 2.0 * N * tt * cout * (cin // g) * k
            cin = cout
        f += 2.0 * N * tt * cin * 3
    return f


def gan_step_flops(cfg: Dict[str, Any], B: int, seg_len: int) -> float:
    """Model FLOPs of one step (both updates) at batch B of `seg_len`
    samples: 3 G + 4.5 D."""
    hop = cfg['dsp']['hop_length']
    G = generator_flops(cfg['hifigan']['model'], cfg['dsp']['num_mels'], B,
                        seg_len // hop)
    D = discriminator_flops(2 * B, seg_len)
    return 3.0 * G + 4.5 * D
