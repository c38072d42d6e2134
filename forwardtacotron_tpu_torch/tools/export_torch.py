"""Export a checkpoint as a reference-format torch `.pt`, or as the
official HiFi-GAN generator file (the JAX package's
`tools/export_torch.py` over the port's formats):

    python -m forwardtacotron_tpu_torch.tools.export_torch \\
        --checkpoint checkpoints/ljspeech_tts.forward/latest_model.pt \\
        --out forward_latest.pt

The input is a `.pt` or `.dcp` checkpoint of this package or a JAX
`.fjax` file. The output is what the reference's own save_checkpoint
writes, {'model': state_dict, 'optim': None, 'config': config}, for
ForwardTacotron, FastPitch, Tacotron and WaveRNN (the port's state_dict
already carries the reference's keys, buffers included); the `step`
buffer holds the checkpoint's step and Tacotron's `decoder.r` holds
`--r`. `--family hifigan` writes {'generator': state_dict} with weight
norm split back into `weight_v` = w and `weight_g` = ||w|| (norm over
all dims but 0), which the official repository's inference loads. EMA
weights are exported where the checkpoint has them (`--no_ema` for the
raw ones). Multi-speaker models are refused: the reference has no speaker
conditioning.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from forwardtacotron_tpu_torch.tools.checkpoint_files import read_payload

REFERENCE_FAMILIES = ('forward_tacotron', 'fast_pitch', 'tacotron',
                      'wavernn')


def weight_norm_split(state: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """Every `.weight` of a folded generator state_dict as the
    (`weight_v`, `weight_g`) pair of torch's weight_norm at dim 0, in
    float32 numpy as the JAX exporter computes it (v = w, g = ||w||), so
    the two files agree bit for bit; biases as they are."""
    out = {}
    for key, value in state.items():
        if not key.endswith('.weight'):
            out[key] = value
            continue
        base = key[:-len('.weight')]
        w = np.ascontiguousarray(value.numpy(), np.float32)
        g = np.sqrt((w ** 2).sum(axis=tuple(range(1, w.ndim)),
                                 keepdims=True))
        out[f'{base}.weight_v'] = torch.from_numpy(w)
        out[f'{base}.weight_g'] = torch.from_numpy(g)
    return out


def reference_state_dict(payload: Dict[str, Any], use_ema: bool = True,
                         r: int = 1) -> Dict[str, torch.Tensor]:
    """The reference's state_dict of a `read_payload` payload: the EMA
    weights unless `use_ema` is False (then the raw ones where the file
    has them), the step buffer at the payload's step, Tacotron's
    `decoder.r` at `r`."""
    state = payload['model']
    if not use_ema and payload['raw_model'] is not None:
        state = payload['raw_model']
    if any(k.startswith(('speaker_embedding', 'speaker_proj'))
           for k in state):
        raise ValueError(
            'checkpoint is multi-speaker; the reference architecture has no '
            'speaker conditioning, so it cannot be exported to a reference '
            '.pt. Re-train with n_speakers: 1 for torch deployment.')
    state = dict(state)
    state['step'] = torch.tensor([int(payload['step'])], dtype=torch.long)
    if payload['family'] == 'tacotron':
        state['decoder.r'] = torch.tensor(int(r), dtype=torch.int)
    return state


def hifigan_generator_file(payload: Dict[str, Any]) -> Dict[str, Any]:
    """The official HiFi-GAN generator file of a GAN payload: a file of
    this package's GAN trainer holds that layout already and is copied as
    it is; a `.fjax` generator is split."""
    model_cfg = (payload['config'] or {}).get('hifigan', {}).get('model', {})
    if str(model_cfg.get('generator_type', 'hifigan')).lower() != 'hifigan':
        raise ValueError('the official generator format holds HiFi-GAN '
                         'generators; this checkpoint is a '
                         f'{model_cfg["generator_type"]} generator')
    if payload['generator'] is not None:
        return {'generator': payload['generator']}
    return {'generator': weight_norm_split(payload['model'])}


def main(argv: Optional[Sequence[str]] = None) -> str:
    parser = argparse.ArgumentParser(
        description='Export a checkpoint as a reference torch .pt')
    parser.add_argument('--checkpoint', required=True,
                        help='[path] .pt / .dcp / .fjax checkpoint to export')
    parser.add_argument('--out', required=True, help='[path] output .pt')
    parser.add_argument('--family', default=None,
                        choices=[*REFERENCE_FAMILIES, 'hifigan'],
                        help='architecture (default: auto-detect). '
                             'hifigan writes the OFFICIAL '
                             "{'generator': sd} format instead of the "
                             'reference .pt')
    parser.add_argument('--no_ema', action='store_true',
                        help='export raw weights even when EMA weights '
                             'are tracked')
    parser.add_argument('--r', type=int, default=1,
                        help='reduction factor buffer for tacotron '
                             'exports')
    args = parser.parse_args(argv)

    payload = read_payload(args.checkpoint)
    family = payload['family']
    if args.family is not None and args.family != family:
        parser.error(f'--family {args.family}, but the checkpoint holds a '
                     f'{family} model')
    if family == 'hifigan':
        torch.save(hifigan_generator_file(payload), args.out)
    elif family in REFERENCE_FAMILIES:
        torch.save({'model': reference_state_dict(payload, not args.no_ema,
                                                  args.r),
                    'optim': None, 'config': payload['config']}, args.out)
    else:
        parser.error(f'no reference format for a {family} checkpoint')
    print(f'Exported {family} step {payload["step"]} -> {args.out}')
    return family


if __name__ == '__main__':
    main()
