"""Plain PyTorch reference of HiFi-GAN V1's adversarial training step
(jik876/hifi-gan: train.py with models.py, config_v1.json).

- The generator of config_v1 (`perfbench/reference/hifigan.py`'s layers,
  batched and differentiable here).
- The multi-period discriminator, periods 2, 3, 5, 7, 11: the audio
  reflect-padded to a multiple of the period and seen as (B, 1, T/p, p),
  through 2-D convolutions of kernel (5, 1), stride (3, 1), channels 32,
  128, 512, 1024, then 1024 at stride 1 and a (3, 1) convolution to one
  channel.
- The multi-scale discriminator on 3 scales, the second and third after
  an average pool (kernel 4, stride 2, padding 2, padded zeros counted):
  grouped 1-D convolutions (128 k15; 128 k41 s2 g4; 256 k41 s2 g16; 512
  k41 s4 g16; 1024 k41 s4 g16; 1024 k41 g16; 1024 k5), then k3 to one
  channel.
- Leaky ReLU 0.1 after every convolution but the last of each net; the
  generator's last is torch's default slope 0.01, then tanh.
- The losses: LSGAN for the discriminators (sum over the 8 of
  mean((1 - D(y))^2) + mean(D(y_hat)^2)) and the generator (sum of
  mean((1 - D(y_hat))^2)), feature matching (2 x the sum of the mean
  absolute gaps of every feature map) and the mel L1 (x 45).
- AdamW written out (lr, betas 0.8 / 0.99, eps 1e-8 outside the root,
  weight decay 0.01 decoupled: p(1 - lr wd) first), in train.py's order.
  One generation a step; the discriminators update on it detached, then
  the generator against the updated discriminators, whose own weights
  take no gradient there.

Float32 on master weights. Run it inside a block that turns TF32 off
for matmuls and cuDNN (the harness's `strict_float32`). `dt` computes
the forwards in a lower type as the trainer's `precision: bf16` does:
each net's weights and inputs cast, its outputs back to float32, the
losses and the log-mels in float32.

Departures from the published recipe, each shared with the program
under test:

- Plain convolution weights. The official modules train weight norm
  (spectral norm on the first MSD scale); the forward is the same,
  Adam's trajectory is not.
- The mel loss compares the program's log-mels: 80 bands at 0-8 kHz
  (fmax 8000, the `dsp` section's; the official loss is full band,
  `fmax_for_loss` null), the signal reflect-padded by n_fft / 2 on each
  side (33 frames of an 8192-sample segment; the official pads
  (n_fft - hop) / 2 and takes 32) and the magnitude |STFT| (the official
  adds 1e-9 inside the root).
- The data are synthetic: 16-bit linear labels (MOL preprocessing) and
  random mels, not LJSpeech.
- The generator's convolutions that the official `init_weights` reaches
  (ups, resblocks, conv_post) are drawn N(0, 0.01); conv_pre, the biases
  and the discriminators keep torch's default U(+-1/sqrt(fan_in)). In the
  official code weight norm recomputes w from g and v at every forward,
  so its `init_weights` draw never reaches a forward; here the plain
  weights take it as written.
"""
from __future__ import annotations

import math
import pickle
from pathlib import Path
from typing import Any, Dict, List, Sequence

import numpy as np
import torch
from torch.nn import functional as F

from perfbench.reference import hifigan, spec

LRELU = 0.1
PERIODS = (2, 3, 5, 7, 11)
PERIOD_CHANNELS = (32, 128, 512, 1024)
# (out channels, kernel, stride, groups) of a scale's convolutions
SCALE_SPECS = ((128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16),
               (512, 41, 4, 16), (1024, 41, 4, 16), (1024, 41, 1, 16),
               (1024, 5, 1, 1))
N_SCALES = 3
BETAS = (0.8, 0.99)
EPS = 1e-8
WEIGHT_DECAY = 0.01
FM_WEIGHT = 2.0
MEL_WEIGHT = 45.0
INIT_STD = 0.01
LOSSES = ('disc_loss', 'gen_loss', 'gen_adv', 'gen_fm', 'gen_mel')

Params = Dict[str, torch.Tensor]


# ------------------------------------------------------------- weights

def generator_spec(gcfg: Dict[str, Any], n_mels: int) -> List[spec.Entry]:
    """The generator's tensors: N(0, 0.01) for the weights `init_weights`
    reaches, torch's default bound for the rest."""
    out = []
    for name, shape, init in hifigan.weight_spec(gcfg, n_mels):
        if name.endswith('.weight') and not name.startswith('conv_pre'):
            init = ('normal', INIT_STD)
        out.append((name, shape, init))
    return out


def _conv(pre: str, cout: int, cin_per_group: int, kernel: Sequence[int]
          ) -> List[spec.Entry]:
    fan_in = cin_per_group * math.prod(kernel)
    bound = spec.uniform(1.0 / math.sqrt(fan_in))
    return [(f'{pre}.weight', (cout, cin_per_group, *kernel), bound),
            (f'{pre}.bias', (cout,), bound)]


def discriminator_spec() -> List[spec.Entry]:
    """The MPD's and MSD's tensors under the program's names (`mpd.i`,
    `msd.i`), at torch's default bound 1/sqrt(fan_in)."""
    out = []
    chans = (1,) + PERIOD_CHANNELS
    for i in range(len(PERIODS)):
        for j, (cin, cout) in enumerate(zip(chans, chans[1:])):
            out += _conv(f'mpd.{i}.convs.{j}', cout, cin, (5, 1))
        out += _conv(f'mpd.{i}.convs.{len(chans) - 1}', 1024, 1024, (5, 1))
        out += _conv(f'mpd.{i}.conv_post', 1, 1024, (3, 1))
    for i in range(N_SCALES):
        cin = 1
        for j, (cout, k, _, g) in enumerate(SCALE_SPECS):
            out += _conv(f'msd.{i}.convs.{j}', cout, cin // g, (k,))
            cin = cout
        out += _conv(f'msd.{i}.conv_post', 1, cin, (3,))
    return out


# ------------------------------------------------------------- the nets

def generate(W: Params, gcfg: Dict[str, Any], mel: torch.Tensor,
             dt=torch.float32) -> torch.Tensor:
    """mel (B, n_mels, T) -> waveform (B, T * hop) in float32."""
    def conv(x, name, dilation=1):
        w = W[f'{name}.weight'].to(dt)
        pad = (w.shape[-1] - 1) * dilation // 2
        return F.conv1d(x, w, W[f'{name}.bias'].to(dt), padding=pad,
                        dilation=dilation)

    x = conv(mel.to(dt), 'conv_pre')
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
    return torch.tanh(x)[:, 0].float()


def _period(W: Params, pre: str, x: torch.Tensor, p: int):
    b, t = x.shape
    if t % p:
        x = F.pad(x[:, None], (0, p - t % p), mode='reflect')[:, 0]
    x = x.reshape(b, 1, -1, p)
    fmaps = []
    n = len(PERIOD_CHANNELS) + 1
    for j in range(n):
        x = F.conv2d(x, W[f'{pre}.convs.{j}.weight'].to(x.dtype),
                     W[f'{pre}.convs.{j}.bias'].to(x.dtype),
                     stride=(3, 1) if j < n - 1 else 1, padding=(2, 0))
        x = F.leaky_relu(x, LRELU)
        fmaps.append(x)
    x = F.conv2d(x, W[f'{pre}.conv_post.weight'].to(x.dtype),
                 W[f'{pre}.conv_post.bias'].to(x.dtype), padding=(1, 0))
    fmaps.append(x)
    return x.reshape(b, -1), fmaps


def _scale(W: Params, pre: str, x: torch.Tensor):
    b = x.shape[0]
    x = x[:, None]
    fmaps = []
    for j, (_, k, s, g) in enumerate(SCALE_SPECS):
        x = F.leaky_relu(F.conv1d(x, W[f'{pre}.convs.{j}.weight'].to(x.dtype),
                                  W[f'{pre}.convs.{j}.bias'].to(x.dtype),
                                  stride=s, padding=k // 2, groups=g), LRELU)
        fmaps.append(x)
    x = F.conv1d(x, W[f'{pre}.conv_post.weight'].to(x.dtype),
                 W[f'{pre}.conv_post.bias'].to(x.dtype), padding=1)
    fmaps.append(x)
    return x.reshape(b, -1), fmaps


def discriminate(W: Params, x: torch.Tensor, dt=torch.float32):
    """The 8 sub-discriminators on audio x (B, T), in models.py's order
    (the periods, then the scales): their logits and feature maps, in
    float32."""
    x = x.to(dt)
    outs = [_period(W, f'mpd.{i}', x, p) for i, p in enumerate(PERIODS)]
    for i in range(N_SCALES):
        if i > 0:
            x = F.avg_pool1d(x[:, None], 4, 2, padding=2)[:, 0]
        outs.append(_scale(W, f'msd.{i}', x))
    return ([logits.float() for logits, _ in outs],
            [[f.float() for f in fmaps] for _, fmaps in outs])


# --------------------------------------------------------------- losses

def mel_basis(dsp: Dict[str, Any]) -> np.ndarray:
    """Slaney-normalised triangular mel filters (librosa's
    `filters.mel(htk=False, norm='slaney')`), (n_mels, 1 + n_fft // 2),
    computed in float64."""
    f_sp, min_hz = 200.0 / 3, 1000.0
    min_mel, logstep = min_hz / f_sp, math.log(6.4) / 27.0

    def to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= min_hz, min_mel + np.log(np.maximum(f, 1e-10)
                                                      / min_hz) / logstep,
                        f / f_sp)

    def to_hz(m):
        return np.where(m >= min_mel, min_hz * np.exp(logstep
                                                      * (m - min_mel)),
                        f_sp * m)
    sr, n_fft, n_mels = dsp['sample_rate'], dsp['n_fft'], dsp['num_mels']
    fmax = dsp['fmax'] if dsp['fmax'] is not None else sr / 2
    hz = to_hz(np.linspace(to_mel(dsp['fmin']), to_mel(fmax), n_mels + 2))
    freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    ramps = hz[:, None] - freqs[None, :]
    fdiff = np.diff(hz)
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    return weights * (2.0 / (hz[2:] - hz[:-2]))[:, None]


def log_mel(y: torch.Tensor, basis: torch.Tensor, dsp: Dict[str, Any]
            ) -> torch.Tensor:
    """log(max(mel |STFT|, 1e-5)) of y (B, N): a periodic Hann window,
    the signal reflect-padded by n_fft / 2 each side; (B, n_mels, T)."""
    window = torch.hann_window(dsp['win_length'], device=y.device)
    spec_ = torch.stft(y.float(), dsp['n_fft'], dsp['hop_length'],
                       dsp['win_length'], window=window, center=True,
                       pad_mode='reflect', return_complex=True)
    return torch.log(torch.clamp(basis @ spec_.abs(), min=1e-5))


def disc_loss(logits_r, logits_g) -> torch.Tensor:
    return sum(torch.mean((1.0 - r) ** 2) + torch.mean(g ** 2)
               for r, g in zip(logits_r, logits_g))


def adv_loss(logits_g) -> torch.Tensor:
    return sum(torch.mean((1.0 - g) ** 2) for g in logits_g)


def fm_loss(fmaps_r, fmaps_g) -> torch.Tensor:
    return FM_WEIGHT * sum(torch.mean(torch.abs(r - g))
                           for rs, gs in zip(fmaps_r, fmaps_g)
                           for r, g in zip(rs, gs))


# ------------------------------------------------------------ the steps

def adamw(P: Params, grads: Params, m: Params, v: Params, step: int,
          lr: float) -> None:
    """One AdamW step of P (float32) in place of its entries."""
    bc1, bc2 = 1.0 - BETAS[0] ** step, 1.0 - BETAS[1] ** step
    with torch.no_grad():
        for n in P:
            g = grads[n]
            m[n].mul_(BETAS[0]).add_(g, alpha=1.0 - BETAS[0])
            v[n].mul_(BETAS[1]).addcmul_(g, g, value=1.0 - BETAS[1])
            p = P[n] * (1.0 - lr * WEIGHT_DECAY)
            P[n] = p - (lr / bc1) * m[n] / (v[n].sqrt() / math.sqrt(bc2)
                                           + EPS)


def _grad(loss: torch.Tensor, P: Params) -> Params:
    names = list(P)
    grads = torch.autograd.grad(loss, [P[n] for n in names])
    return {n: g.detach() for n, g in zip(names, grads)}


def run_steps(gen: Params, disc: Params, batches: Sequence[Dict[str, Any]],
              gcfg: Dict[str, Any], dsp: Dict[str, Any], lr: float,
              dt=torch.float32) -> Dict[str, Any]:
    """len(batches) steps from the weights `gen` and `disc` (float32, not
    modified); a batch holds 'mel' (B, n_mels, T) and 'audio' (B, T *
    hop). Returns each step's losses (`LOSSES`), each net's first-step
    gradients and its weights after the last step."""
    P = {'gen': {n: w.detach().clone() for n, w in gen.items()},
         'disc': {n: w.detach().clone() for n, w in disc.items()}}
    m = {k: {n: torch.zeros_like(w) for n, w in P[k].items()} for k in P}
    v = {k: {n: torch.zeros_like(w) for n, w in P[k].items()} for k in P}
    device = next(iter(gen.values())).device
    basis = torch.as_tensor(mel_basis(dsp), dtype=torch.float32,
                            device=device)
    losses: List[List[float]] = []
    first: Dict[str, Params] = {}
    for step, batch in enumerate(batches, 1):
        y = batch['audio']
        G = {n: w.detach().requires_grad_(True) for n, w in P['gen'].items()}
        y_hat = generate(G, gcfg, batch['mel'], dt)
        D = {n: w.detach().requires_grad_(True)
             for n, w in P['disc'].items()}
        logits_r, _ = discriminate(D, y, dt)
        logits_g, _ = discriminate(D, y_hat.detach(), dt)
        d_loss = disc_loss(logits_r, logits_g)
        d_grads = _grad(d_loss, D)
        adamw(P['disc'], d_grads, m['disc'], v['disc'], step, lr)
        D = P['disc']
        logits_r, fmaps_r = discriminate(D, y, dt)
        logits_g, fmaps_g = discriminate(D, y_hat, dt)
        adv = adv_loss(logits_g)
        fm = fm_loss(fmaps_r, fmaps_g)
        mel_l = MEL_WEIGHT * torch.mean(torch.abs(
            log_mel(y_hat, basis, dsp) - log_mel(y, basis, dsp)))
        g_loss = adv + fm + mel_l
        g_grads = _grad(g_loss, G)
        adamw(P['gen'], g_grads, m['gen'], v['gen'], step, lr)
        losses.append([float(t.detach()) for t in (d_loss, g_loss, adv, fm,
                                                    mel_l)])
        if step == 1:
            first = {'gen': g_grads, 'disc': d_grads}
        del G, y_hat, logits_r, logits_g, fmaps_r, fmaps_g
    return {'losses': losses, 'first_grad': first, 'final': P}


# ---------------------------------------------------------------- data

def read_batch(data: Path, indices: Sequence[int], offsets: Sequence[int],
               seg_len: int, hop: int, max_mel_len: int, device
               ) -> Dict[str, torch.Tensor]:
    """A training batch read from the raw files: row r is item
    `indices[r]` of train_dataset.pkl (those of at most `max_mel_len`
    frames, in the file's order), its mel frames from `offsets[r]` on and
    the `seg_len` 16-bit linear labels from `offsets[r] * hop` on,
    decoded to [-1, 1] in float32. A window that runs past the item's
    clip raises."""
    with open(Path(data) / 'train_dataset.pkl', 'rb') as f:
        ids = [i for i, n in pickle.load(f) if n <= max_mel_len]
    win = seg_len // hop
    mels, audio = [], []
    for j, o in zip(indices, offsets):
        mel = np.load(Path(data) / 'mel' / f'{ids[j]}.npy')
        labels = np.load(Path(data) / 'quant' / f'{ids[j]}.npy')
        if o < 0 or o + win > min(mel.shape[1], len(labels) // hop):
            raise ValueError(f'item {ids[j]}: window at frame {o} runs past '
                             'its clip')
        mels.append(mel[:, o:o + win])
        seg = labels[o * hop:o * hop + seg_len].astype(np.float32)
        audio.append(2 * seg / (2 ** 16 - 1.0) - 1.0)
    return {'mel': torch.from_numpy(np.stack(mels).astype(np.float32)
                                    ).to(device),
            'audio': torch.from_numpy(np.stack(audio)).to(device)}


def half(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The batch's first half of rows (a fault: half the batch left out)."""
    n = batch['audio'].shape[0] // 2
    return {k: v[:n] for k, v in batch.items()}
