"""Weight specifications of the benchmark's models: (name, shape, init)
entries under the published `state_dict` keys, from which
`perfbench/harness/weights.py` draws every tensor from the run's seed.

init is ('uniform', bound) for U(-bound, bound) or ('const', value).
Weights of convolutions and linear maps take torch's default bound
1/sqrt(fan_in); recurrences 1/sqrt(H); embeddings sqrt(3) (unit
variance); normalisation scales 1 and shifts 0.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

Entry = Tuple[str, Tuple[int, ...], Tuple[str, float]]


def uniform(bound: float) -> Tuple[str, float]:
    return ('uniform', float(bound))


def const(value: float) -> Tuple[str, float]:
    return ('const', float(value))


def linear(pre: str, fin: int, fout: int, bias: bool = True) -> List[Entry]:
    b = 1.0 / math.sqrt(fin)
    out = [(f'{pre}.weight', (fout, fin), uniform(b))]
    if bias:
        out.append((f'{pre}.bias', (fout,), uniform(b)))
    return out


def conv(pre: str, cin: int, cout: int, k: int, bias: bool = True
         ) -> List[Entry]:
    b = 1.0 / math.sqrt(cin * k)
    out = [(f'{pre}.weight', (cout, cin, k), uniform(b))]
    if bias:
        out.append((f'{pre}.bias', (cout,), uniform(b)))
    return out


def conv_transpose(pre: str, cin: int, cout: int, k: int) -> List[Entry]:
    # torch's ConvTranspose1d weight is (cin, cout, k), fan_in cout * k
    b = 1.0 / math.sqrt(cout * k)
    return [(f'{pre}.weight', (cin, cout, k), uniform(b)),
            (f'{pre}.bias', (cout,), uniform(b))]


def batch_norm(pre: str, c: int) -> List[Entry]:
    return [(f'{pre}.weight', (c,), const(1.0)),
            (f'{pre}.bias', (c,), const(0.0)),
            (f'{pre}.running_mean', (c,), const(0.0)),
            (f'{pre}.running_var', (c,), const(1.0))]


def layer_norm(pre: str, c: int) -> List[Entry]:
    return [(f'{pre}.weight', (c,), const(1.0)),
            (f'{pre}.bias', (c,), const(0.0))]


def embedding(pre: str, n: int, d: int) -> List[Entry]:
    return [(f'{pre}.weight', (n, d), uniform(math.sqrt(3.0)))]


def rnn(pre: str, cell: str, d: int, h: int) -> List[Entry]:
    g = 4 if cell == 'lstm' else 3
    b = 1.0 / math.sqrt(h)
    out = []
    for sfx in ('', '_reverse'):
        out += [(f'{pre}.weight_ih_l0{sfx}', (g * h, d), uniform(b)),
                (f'{pre}.weight_hh_l0{sfx}', (g * h, h), uniform(b)),
                (f'{pre}.bias_ih_l0{sfx}', (g * h,), uniform(b)),
                (f'{pre}.bias_hh_l0{sfx}', (g * h,), uniform(b))]
    return out


def bn_conv(pre: str, cin: int, cout: int, k: int) -> List[Entry]:
    return conv(f'{pre}.conv', cin, cout, k, bias=False) \
        + batch_norm(f'{pre}.bnorm', cout)


def cbhg(pre: str, K: int, cin: int, channels: int,
         proj: Sequence[int], highways: int) -> List[Entry]:
    out = []
    for k in range(1, K + 1):
        out += bn_conv(f'{pre}.conv1d_bank.{k - 1}', cin, channels, k)
    out += bn_conv(f'{pre}.conv_project1', K * channels, proj[0], 3)
    out += bn_conv(f'{pre}.conv_project2', proj[0], proj[1], 3)
    out += linear(f'{pre}.pre_highway', proj[1], channels, bias=False)
    for i in range(highways):
        w1 = linear(f'{pre}.highways.{i}.W1', channels, channels)
        w1[1] = (w1[1][0], w1[1][1], const(0.0))
        out += w1 + linear(f'{pre}.highways.{i}.W2', channels, channels)
    out += rnn(f'{pre}.rnn', 'gru', channels, channels)
    return out


def duration_head(entries: List[Entry], pre: str, frames: float,
                  gain: float) -> List[Entry]:
    """The duration head `pre` (a Linear to one output) set so that a
    phoneme lasts `frames` frames: its bias `frames` and its weight's
    bound scaled by `gain`, which keeps the predicted durations within
    rounding-safe reach of `frames`."""
    out = []
    for name, shape, init in entries:
        if name == f'{pre}.bias':
            init = const(frames)
        elif name == f'{pre}.weight':
            init = uniform(init[1] * gain)
        out.append((name, shape, init))
    return out
