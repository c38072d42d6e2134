"""The yardstick's arithmetic: published H100 peaks, the bound of a
kernel launch from its operations and bytes (a copy of chip_smoke.py's
`bound_ms` and of its arithmetic for kernels #2 and #3), and the model
FLOPs of a training step from its batch's shapes.

A step's model FLOPs are twice the multiply-adds of the products of its
forward (convolutions, linear maps, the recurrences' input and hidden
products over every padded step, attention's two batched products) over
the padded batch, times three for the forward and the backward's two
products of each; norms, activations and the optimizer are left out.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM
PEAK_FLOPS = {'bf16': 989e12, 'tf32': 495e12, 'fp32': 67e12}


def bound_s(n_bytes: float, flops: float, peak: str) -> Tuple[float, str]:
    """The least time of a launch: bytes over HBM bandwidth or operations
    over the peak of their type, whichever is longer."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[peak]
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


# ------------------------------------------------ kernels #2 and #3

def birnn_train_bounds(cell: str, T: int, B: int, H: int,
                       lengths: Iterable[int], S: int = 2
                       ) -> Tuple[float, float]:
    """Bounds (s) of one float32 launch of #2 (training forward) and of #3
    (its backward) over S streams of B lanes and T steps: the products of
    the active steps; #2 reads gi, W_hh, b_hh and the lengths once and
    writes y and the stash of 5 values a step, #3 reads the stash and dy
    and writes dgi (and, for a GRU, dgh)."""
    ng = 4 if cell == 'lstm' else 3
    active = S * sum(min(int(n), T) for n in lengths)
    flops = 2.0 * active * ng * H * H
    gi = T * B * S * ng * H
    small = (S * ng * H * H + S * ng * H + B) * 4
    fwd_bytes = (gi + B * T * S * H * (1 + 5)) * 4 + small
    bwd_bytes = (T * B * S * 5 * H + T * B * S * H
                 + (1 if cell == 'lstm' else 2) * gi) * 4 + small
    return (bound_s(fwd_bytes, flops, 'fp32')[0],
            bound_s(bwd_bytes, flops, 'fp32')[0])


def forward_tacotron_recurrences(m: Dict[str, Any], Tx: int, Tm: int,
                                 mel_len: Iterable[int]
                                 ) -> List[Tuple[str, int, int, List[int]]]:
    """(cell, T, H, lengths) of the student's six recurrences in a
    training step: the three predictors' and the prenet's BiGRUs over the
    padded text, the decoder BiLSTM over each mel's length and the
    postnet's BiGRU over the padded mel."""
    return [('gru', Tx, m['durpred_rnn_dims'], None),
            ('gru', Tx, m['pitch_rnn_dims'], None),
            ('gru', Tx, m['energy_rnn_dims'], None),
            ('gru', Tx, m['prenet_dims'], None),
            ('lstm', Tm, m['rnn_dims'], list(mel_len)),
            ('gru', Tm, m['postnet_dims'], None)]


def forward_tacotron_kernel_bound_s(m: Dict[str, Any], B: int, Tx: int,
                                    Tm: int, mel_len: Iterable[int]) -> float:
    """Summed bounds of a training step's launches of #2 and #3."""
    total = 0.0
    for cell, T, H, lens in forward_tacotron_recurrences(m, Tx, Tm, mel_len):
        f, b = birnn_train_bounds(cell, T, B, H, lens or [T] * B)
        total += f + b
    return total


# ------------------------------------------------------- model FLOPs

def _conv(B, T, cin, cout, k):
    """A convolution with 'same' padding k // 2: an even kernel computes
    one frame more, which the models cut."""
    return 2.0 * B * (T + 1 - k % 2) * cin * cout * k


def _birnn(B, T, D, H, ng):
    return 2 * (2.0 * B * T * D * ng * H + 2.0 * B * T * H * ng * H)


def _cbhg(B, T, K, cin, ch, proj, highways):
    f = sum(_conv(B, T, cin, ch, k) for k in range(1, K + 1))
    f += _conv(B, T, K * ch, proj[0], 3) + _conv(B, T, proj[0], proj[1], 3)
    f += 2.0 * B * T * proj[1] * ch
    f += highways * 2 * (2.0 * B * T * ch * ch)
    return f + _birnn(B, T, ch, ch, 3)


def forward_tacotron_forward_flops(cfg: Dict[str, Any], B: int, Tx: int,
                                   Tm: int) -> float:
    m = cfg['forward_tacotron']['model']
    n_mels = cfg['dsp']['num_mels']
    f = 0.0
    for conv, rnn in (('durpred_conv_dims', 'durpred_rnn_dims'),
                      ('pitch_conv_dims', 'pitch_rnn_dims'),
                      ('energy_conv_dims', 'energy_rnn_dims')):
        e, c, h = m['series_embed_dims'], m[conv], m[rnn]
        f += _conv(B, Tx, e, c, 5) + 2 * _conv(B, Tx, c, c, 5)
        f += _birnn(B, Tx, c, h, 3) + 2.0 * B * Tx * 2 * h
    f += _cbhg(B, Tx, m['prenet_k'], m['embed_dims'], m['prenet_dims'],
               [m['prenet_dims'], m['embed_dims']], m['prenet_num_highways'])
    f += 2 * _conv(B, Tx, 1, 2 * m['prenet_dims'], 3)
    f += _birnn(B, Tm, 2 * m['prenet_dims'], m['rnn_dims'], 4)
    f += 2.0 * B * Tm * 2 * m['rnn_dims'] * n_mels
    f += _cbhg(B, Tm, m['postnet_k'], n_mels, m['postnet_dims'],
               [m['postnet_dims'], n_mels], m['postnet_num_highways'])
    f += 2.0 * B * Tm * 2 * m['postnet_dims'] * n_mels
    return f


def _fft_block(B, T, d, fft, k1, k2):
    return (2.0 * B * T * d * 3 * d + 2 * 2.0 * B * T * T * d
            + 2.0 * B * T * d * d + _conv(B, T, d, fft, k1)
            + _conv(B, T, fft, d, k2))


def fast_pitch_forward_flops(cfg: Dict[str, Any], B: int, Tx: int,
                             Tm: int) -> float:
    m = cfg['fast_pitch']['model']
    n_mels = cfg['dsp']['num_mels']
    k1, k2 = m['conv1_kernel'], m['conv2_kernel']
    f = 0.0
    for key in ('durpred', 'pitch', 'energy'):
        d = m[f'{key}_d_model']
        f += m[f'{key}_layers'] * _fft_block(B, Tx, d, m[f'{key}_d_fft'],
                                             k1, k2)
        f += 2.0 * B * Tx * d
    d = m['d_model']
    f += m['prenet_layers'] * _fft_block(B, Tx, d, m['prenet_fft'], k1, k2)
    f += 2 * _conv(B, Tx, 1, d, 3)
    f += m['postnet_layers'] * _fft_block(B, Tm, d, m['postnet_fft'], k1, k2)
    return f + 2.0 * B * Tm * d * n_mels


FORWARD_FLOPS = {'forward_tacotron': forward_tacotron_forward_flops,
                 'fast_pitch': fast_pitch_forward_flops}


def train_step_flops(cfg: Dict[str, Any], B: int, Tx: int, Tm: int) -> float:
    """Model FLOPs of one training step (forward and backward) of the
    configuration's model at a padded batch (B, Tx, Tm)."""
    return 3.0 * FORWARD_FLOPS[cfg['tts_model']](cfg, B, Tx, Tm)
