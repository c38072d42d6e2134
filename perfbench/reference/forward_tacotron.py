"""Plain PyTorch reference of ForwardTacotron's training forward and loss
(as-ideas/ForwardTacotron: models/forward_tacotron.py, trainer/
forward_trainer.py), from the published equations.

Series predictors (embedding, three conv-relu-batchnorm-dropout layers,
a BiGRU, a linear head), the CBHG prenet over the token embeddings
(conv bank of kernels 1..K, max pool, dropout, two projections, residual,
highways, BiGRU), pitch and energy projections added, the length
regulator on the true durations, the decoder BiLSTM over each mel's true
length (padded outputs -11.5129), the linear mel head and the CBHG
postnet with its projection. Training mode: batch norms use the batch's
statistics; dropout draws from the device's global generator in the
order the layers run. The loss is the masked L1 of both mels plus 0.1 x
the duration, pitch and energy terms.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch.nn import functional as F

from perfbench.reference import nn, spec
from perfbench.reference.frontend import SYMBOLS

PADDING_VALUE = -11.5129


def weight_spec(cfg: Dict[str, Any]) -> List[spec.Entry]:
    m = cfg['forward_tacotron']['model']
    n_mels = cfg['dsp']['num_mels']
    n = len(SYMBOLS)
    out = spec.embedding('embedding', n, m['embed_dims'])
    out += spec.cbhg('prenet', m['prenet_k'], m['embed_dims'],
                     m['prenet_dims'], [m['prenet_dims'], m['embed_dims']],
                     m['prenet_num_highways'])
    for name, conv, rnn in (('dur_pred', 'durpred_conv_dims',
                             'durpred_rnn_dims'),
                            ('pitch_pred', 'pitch_conv_dims',
                             'pitch_rnn_dims'),
                            ('energy_pred', 'energy_conv_dims',
                             'energy_rnn_dims')):
        e, c, h = m['series_embed_dims'], m[conv], m[rnn]
        out += spec.embedding(f'{name}.embedding', n, e)
        for i in range(3):
            out += spec.bn_conv(f'{name}.convs.{i}', e if i == 0 else c, c, 5)
        out += spec.rnn(f'{name}.rnn', 'gru', c, h)
        out += spec.linear(f'{name}.lin', 2 * h, 1)
    out += spec.conv('pitch_proj', 1, 2 * m['prenet_dims'], 3)
    out += spec.conv('energy_proj', 1, 2 * m['prenet_dims'], 3)
    out += spec.rnn('lstm', 'lstm', 2 * m['prenet_dims'], m['rnn_dims'])
    out += spec.linear('lin', 2 * m['rnn_dims'], n_mels)
    out += spec.cbhg('postnet', m['postnet_k'], n_mels, m['postnet_dims'],
                     [m['postnet_dims'], n_mels], m['postnet_num_highways'])
    out += spec.linear('post_proj', 2 * m['postnet_dims'], n_mels, bias=False)
    return out


def _series(P, pre: str, x: torch.Tensor, p: float, dt) -> torch.Tensor:
    h = nn.embed(P[f'{pre}.embedding.weight'], x, dt)
    for i in range(3):
        h = nn.global_dropout(nn.bn_conv(P, f'{pre}.convs.{i}', h, 5), p)
    h = nn.birnn(P, f'{pre}.rnn', 'gru', h)
    return nn.linear(h, P[f'{pre}.lin.weight'], P[f'{pre}.lin.bias'])[..., 0]


def _cbhg(P, pre: str, x: torch.Tensor, K: int, highways: int,
          p: float) -> torch.Tensor:
    T = x.shape[1]
    residual = x
    x = torch.cat([nn.bn_conv(P, f'{pre}.conv1d_bank.{k - 1}', x, k)
                   for k in range(1, K + 1)], dim=-1)
    x = F.max_pool1d(x.transpose(1, 2), 2, stride=1, padding=1)
    x = nn.global_dropout(x.transpose(1, 2)[:, :T], p)
    x = nn.global_dropout(nn.bn_conv(P, f'{pre}.conv_project1', x, 3), p)
    x = nn.bn_conv(P, f'{pre}.conv_project2', x, 3, relu=False) + residual
    x = nn.linear(x, P[f'{pre}.pre_highway.weight'])
    for i in range(highways):
        x = nn.highway(P, f'{pre}.highways.{i}', x)
    return nn.birnn(P, f'{pre}.rnn', 'gru', x)


def _proj(P, pre: str, series: torch.Tensor) -> torch.Tensor:
    s = series[..., None].to(series.dtype)
    return F.conv1d(s.transpose(1, 2), P[f'{pre}.weight'].to(s.dtype),
                    P[f'{pre}.bias'].to(s.dtype), padding=1).transpose(1, 2)


def forward(P: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
            cfg: Dict[str, Any], dt=torch.float32) -> Dict[str, torch.Tensor]:
    """The teacher-forced training forward over a padded batch (x, mel,
    mel_len, dur, pitch, energy), every layer in `dt`; the predictions in
    float32."""
    m = cfg['forward_tacotron']['model']
    x, mel_len = batch['x'], batch['mel_len']
    out = {'dur': _series(P, 'dur_pred', x, m['durpred_dropout'], dt),
           'pitch': _series(P, 'pitch_pred', x, m['pitch_dropout'], dt),
           'energy': _series(P, 'energy_pred', x, m['energy_dropout'], dt)}
    h = nn.embed(P['embedding.weight'], x, dt)
    h = _cbhg(P, 'prenet', h, m['prenet_k'], m['prenet_num_highways'],
              m['prenet_dropout'])
    h = h + _proj(P, 'pitch_proj', batch['pitch'].to(dt)) \
        * m['pitch_strength']
    h = h + _proj(P, 'energy_proj', batch['energy'].to(dt)) \
        * m['energy_strength']
    h = nn.length_regulate(h, batch['dur'], batch['mel'].shape[1])
    y = nn.birnn(P, 'lstm', 'lstm', h, mel_len, PADDING_VALUE)
    mel = nn.linear(y, P['lin.weight'], P['lin.bias'])
    post = _cbhg(P, 'postnet', mel, m['postnet_k'],
                 m['postnet_num_highways'], m['postnet_dropout'])
    out['mel'] = mel
    out['mel_post'] = nn.linear(post, P['post_proj.weight'])
    return {k: v.float() for k, v in out.items()}


def loss(pred: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
         train_cfg: Dict[str, Any]) -> torch.Tensor:
    """Masked L1 of both mels, plus the weighted duration, pitch and
    energy terms over the valid phonemes."""
    mel, ml, xl = batch['mel'], batch['mel_len'], batch['x_len']
    return (nn.masked_l1(pred['mel'], mel, ml)
            + nn.masked_l1(pred['mel_post'], mel, ml)
            + train_cfg['dur_loss_factor']
            * nn.masked_l1(pred['dur'], batch['dur'], xl)
            + train_cfg['pitch_loss_factor']
            * nn.masked_l1(pred['pitch'], batch['pitch'], xl)
            + train_cfg['energy_loss_factor']
            * nn.masked_l1(pred['energy'], batch['energy'], xl))
