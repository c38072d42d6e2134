"""Plain PyTorch reference of FastPitch as ForwardTacotron's repository
publishes it (models/fast_pitch.py): FFT blocks (multi-head
self-attention with a key-padding mask, a conv of kernel 9 and one of
kernel 1, post-norm residuals) behind a scaled sinusoidal positional
encoding, in the duration, pitch and energy predictors (each an
embedding, a transformer and a linear head), the prenet and the postnet;
pitch and energy projections (conv k=3) added to the encoding; the
length regulator; a linear mel head.

Training (`forward`): blocks run unmasked over the padded batch, the text
mask from the pad token, the postnet's from each mel length, frames past
the batch's longest mel set to -11.5129; dropout is inverted dropout with
keep mask `rand >= p` drawn from the step's generator in layer order.
Inference (`infer`): one text at its exact length, no dropout, the
durations rounded half up.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
from torch.nn import functional as F

from perfbench.reference import nn, spec
from perfbench.reference.frontend import SYMBOLS

PADDING_VALUE = -11.5129


def _transformer_spec(pre: str, d: int, fft: int, layers: int, k1: int,
                      k2: int) -> List[spec.Entry]:
    out = [(f'{pre}.pos_encoder.scale', (1,), spec.const(1.0))]
    for i in range(layers):
        p = f'{pre}.layers.{i}'
        xav = math.sqrt(6.0 / (d + 3 * d))
        out += [(f'{p}.self_attn.in_proj_weight', (3 * d, d),
                 spec.uniform(xav)),
                (f'{p}.self_attn.in_proj_bias', (3 * d,), spec.const(0.0)),
                (f'{p}.self_attn.out_proj.weight', (d, d),
                 spec.uniform(math.sqrt(3.0 / d))),
                (f'{p}.self_attn.out_proj.bias', (d,), spec.const(0.0))]
        out += spec.conv(f'{p}.conv1', d, fft, k1)
        out += spec.conv(f'{p}.conv2', fft, d, k2)
        out += spec.layer_norm(f'{p}.norm1', d)
        out += spec.layer_norm(f'{p}.norm2', d)
    return out + spec.layer_norm(f'{pre}.norm', d)


def weight_spec(cfg: Dict[str, Any]) -> List[spec.Entry]:
    m = cfg['fast_pitch']['model']
    n_mels = cfg['dsp']['num_mels']
    n = len(SYMBOLS)
    k1, k2 = m['conv1_kernel'], m['conv2_kernel']
    out = spec.embedding('embedding', n, m['d_model'])
    for name, key in (('dur_pred', 'durpred'), ('pitch_pred', 'pitch'),
                      ('energy_pred', 'energy')):
        d = m[f'{key}_d_model']
        out += spec.embedding(f'{name}.embedding', n, d)
        out += _transformer_spec(f'{name}.transformer', d, m[f'{key}_d_fft'],
                                 m[f'{key}_layers'], k1, k2)
        out += spec.linear(f'{name}.lin', d, 1)
    out += _transformer_spec('prenet', m['d_model'], m['prenet_fft'],
                             m['prenet_layers'], k1, k2)
    out += _transformer_spec('postnet', m['d_model'], m['postnet_fft'],
                             m['postnet_layers'], k1, k2)
    out += spec.conv('pitch_proj', 1, m['d_model'], 3)
    out += spec.conv('energy_proj', 1, m['d_model'], 3)
    out += spec.linear('lin', m['d_model'], n_mels)
    return out


def positional_table(d: int, n: int, device) -> torch.Tensor:
    """(n, d) sinusoids: sin at even channels, cos at odd, wavelengths
    from 2 pi to 10000 * 2 pi."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                 device=device) * (-math.log(10000.0) / d))
    pe = torch.zeros(n, d, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def _conv(P, pre: str, x: torch.Tensor) -> torch.Tensor:
    w = P[f'{pre}.weight'].to(x.dtype)
    y = F.conv1d(x.transpose(1, 2), w, P[f'{pre}.bias'].to(x.dtype),
                 padding=w.shape[-1] // 2)
    return y[:, :, :x.shape[1]].transpose(1, 2)


def _norm(P, pre: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), P[f'{pre}.weight'].to(x.dtype),
                        P[f'{pre}.bias'].to(x.dtype), 1e-5)


def _attention(P, pre: str, x, pad, heads: int, p: float, gen):
    B, T, D = x.shape
    qkv = nn.linear(x, P[f'{pre}.in_proj_weight'], P[f'{pre}.in_proj_bias'])
    q, k, v = (t.reshape(B, T, heads, D // heads).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(D // heads)
    if pad is not None:
        scores = scores.masked_fill(pad[:, None, None, :], float('-inf'))
    attn = nn.generator_dropout(torch.softmax(scores, dim=-1), p, gen)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(B, T, D)
    return nn.linear(out, P[f'{pre}.out_proj.weight'],
                     P[f'{pre}.out_proj.bias'])


def _transformer(P, pre: str, x, pad, heads: int, layers: int, p: float,
                 gen: Optional[torch.Generator]) -> torch.Tensor:
    T, D = x.shape[1], x.shape[2]
    pe = positional_table(D, T, x.device).to(x.dtype)
    x = x + P[f'{pre}.pos_encoder.scale'].to(x.dtype) * pe
    x = nn.generator_dropout(x, p, gen)
    for i in range(layers):
        b = f'{pre}.layers.{i}'
        a = _attention(P, f'{b}.self_attn', x, pad, heads, p, gen)
        x = _norm(P, f'{b}.norm1', x + nn.generator_dropout(a, p, gen))
        h = _conv(P, f'{b}.conv2', F.relu(_conv(P, f'{b}.conv1', x)))
        x = _norm(P, f'{b}.norm2', x + nn.generator_dropout(h, p, gen))
    return _norm(P, f'{pre}.norm', x)


def _predictor(P, name: str, key: str, m, x, pad, gen, dt):
    h = nn.embed(P[f'{name}.embedding.weight'], x, dt)
    p = m[f'{key}_dropout'] if gen is not None else 0.0
    h = _transformer(P, f'{name}.transformer', h, pad, m[f'{key}_n_heads'],
                     m[f'{key}_layers'], p, gen)
    return nn.linear(h, P[f'{name}.lin.weight'], P[f'{name}.lin.bias'])[..., 0]


def _series_proj(P, h, pitch, energy, m):
    for series, pre, strength in ((pitch, 'pitch_proj', m['pitch_strength']),
                                  (energy, 'energy_proj',
                                   m['energy_strength'])):
        h = h + _conv(P, pre, series[..., None].to(h.dtype)) * strength
    return h


def forward(P: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
            cfg: Dict[str, Any], gen: torch.Generator,
            dt=torch.float32) -> Dict[str, torch.Tensor]:
    """The teacher-forced training forward, dropout from `gen`; the
    predictions in float32."""
    m = cfg['fast_pitch']['model']
    x, mel_len = batch['x'], batch['mel_len']
    max_t = batch['mel'].shape[1]
    pad = x == 0
    out = {name: _predictor(P, f'{name}_pred', key, m, x, pad, gen, dt)
           for name, key in (('dur', 'durpred'), ('pitch', 'pitch'),
                             ('energy', 'energy'))}
    h = _transformer(P, 'prenet', nn.embed(P['embedding.weight'], x, dt), pad,
                     m['prenet_heads'], m['prenet_layers'],
                     m['prenet_dropout'], gen)
    h = _series_proj(P, h, batch['pitch'], batch['energy'], m)
    h = nn.length_regulate(h, batch['dur'], max_t)
    frames = torch.arange(max_t, device=x.device)
    h = _transformer(P, 'postnet', h, frames[None, :] >= mel_len[:, None],
                     m['postnet_heads'], m['postnet_layers'],
                     m['postnet_dropout'], gen)
    mel = nn.linear(h, P['lin.weight'], P['lin.bias'])
    mel = torch.where(frames[None, :, None] < mel_len.max(), mel,
                      torch.full_like(mel, PADDING_VALUE))
    out['mel'] = out['mel_post'] = mel
    return {k: v.float() for k, v in out.items()}


@torch.no_grad()
def infer(P: Dict[str, torch.Tensor], ids: torch.Tensor,
          cfg: Dict[str, Any], dt=torch.float32) -> torch.Tensor:
    """One text's token ids (T,) -> its mel (frames, n_mels) in `dt`."""
    m = cfg['fast_pitch']['model']
    x = ids[None]
    series = {name: _predictor(P, f'{name}_pred', key, m, x, None, None, dt)
              for name, key in (('dur', 'durpred'), ('pitch', 'pitch'),
                                ('energy', 'energy'))}
    h = _transformer(P, 'prenet', nn.embed(P['embedding.weight'], x, dt),
                     None, m['prenet_heads'], m['prenet_layers'], 0.0, None)
    h = _series_proj(P, h, series['pitch'], series['energy'], m)
    reps = torch.floor(torch.clamp(series['dur'].float(), min=0.0) + 0.5)
    h = nn.length_regulate(h, reps, int(reps.sum()))
    h = _transformer(P, 'postnet', h, None, m['postnet_heads'],
                     m['postnet_layers'], 0.0, None)
    return nn.linear(h, P['lin.weight'], P['lin.bias'])[0]
