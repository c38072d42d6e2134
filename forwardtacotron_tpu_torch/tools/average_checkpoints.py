"""Checkpoint averaging: merge k checkpoints of one model into one by the
arithmetic mean of their float weights (the JAX package's
`tools/average_checkpoints.py` over the port's payload).

    python -m forwardtacotron_tpu_torch.tools.average_checkpoints \\
        checkpoints/ljspeech_tts.forward/forward_step80k.pt \\
        checkpoints/ljspeech_tts.forward/forward_step90k.pt \\
        --output averaged.pt

Inputs are `.pt` files or `.dcp` directories of this package, or JAX
`.fjax` files (converted by `weights.py`); the output is a `.pt`, or a
`.dcp` directory where `--output` ends in `.dcp`. Rules, as JAX's:

- float tensors of 'model' are averaged in float64 and cast back;
  integer ones (`num_batches_tracked`, the `step` buffer) come from the
  LAST input, as do 'config' and 'step';
- 'raw_model' (a run with EMA) is averaged as well when every input
  carries one; an input without one among inputs with one is refused;
- the output has no optimizer state ('optim' None);
- inputs whose keys or shapes differ from the last one's are refused by
  name. GAN checkpoints are not averaged.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from forwardtacotron_tpu_torch.tools.checkpoint_files import read_payload
from forwardtacotron_tpu_torch.utils.checkpoints import (DIRECTORY_SUFFIX,
                                                         save_directory,
                                                         save_payload)


def _mean(tensors: List[torch.Tensor]) -> torch.Tensor:
    last = tensors[-1]
    if not last.is_floating_point():
        return last.clone()              # int counters etc.: keep the last
    return torch.from_numpy(np.mean([t.double().numpy() for t in tensors],
                                    axis=0)).to(last.dtype)


def _average(states: List[Dict[str, torch.Tensor]], what: str
             ) -> Dict[str, torch.Tensor]:
    ref = states[-1]
    for i, state in enumerate(states):
        missing, extra = sorted(set(ref) - set(state)), \
            sorted(set(state) - set(ref))
        if missing or extra:
            raise ValueError(f'checkpoint #{i}: {what} keys differ from the '
                             f'last one (missing {missing[:5]}, extra '
                             f'{extra[:5]}) — not the same model')
        for k, v in ref.items():
            if state[k].shape != v.shape:
                raise ValueError(f'checkpoint #{i}: {what} {k} has shape '
                                 f'{tuple(state[k].shape)}, the last one '
                                 f'{tuple(v.shape)} — not the same model '
                                 'config')
    return {k: _mean([s[k] for s in states]) for k in ref}


def average_payloads(payloads: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The average of `read_payload` payloads: 'model' (and 'raw_model'
    where every input has one) averaged, the rest from the last one, no
    optimizer state."""
    for i, p in enumerate(payloads):
        if p['family'] == 'hifigan':
            raise ValueError(f'checkpoint #{i} is a GAN checkpoint; this '
                             'tool averages TTS, Tacotron, WaveRNN and '
                             'aligner checkpoints')
    raw = [p['raw_model'] is not None for p in payloads]
    if any(raw) and not all(raw):
        raise ValueError(f'checkpoints {[i for i, r in enumerate(raw) if r]}'
                         ' carry EMA weights and the others do not — '
                         'average runs of one kind')
    last = payloads[-1]
    out = {'model': _average([p['model'] for p in payloads], "'model'"),
           'optim': None, 'config': last['config'], 'step': last['step']}
    if all(raw):
        out['raw_model'] = _average([p['raw_model'] for p in payloads],
                                    "'raw_model'")
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(
        description='Average k checkpoints into one')
    parser.add_argument('checkpoints', nargs='+',
                        help='two or more .pt / .dcp / .fjax checkpoints of '
                             'the same model')
    parser.add_argument('--output', required=True,
                        help='output .pt file (or .dcp directory)')
    args = parser.parse_args(argv)
    if len(args.checkpoints) < 2:
        parser.error('need at least two checkpoints to average')

    payloads = [read_payload(p) for p in args.checkpoints]
    merged = average_payloads(payloads)
    if Path(args.output).suffix == DIRECTORY_SUFFIX:
        save_directory(merged, args.output)
    else:
        save_payload(merged, args.output)
    print(f'Averaged {len(payloads)} checkpoints '
          f'(steps {[p["step"] for p in payloads]}) -> {args.output}')
    return merged


if __name__ == '__main__':
    main()
