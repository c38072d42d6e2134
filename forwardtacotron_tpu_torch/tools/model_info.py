"""Checkpoint and artifact inspector: model family, step, parameter count
and the embedded config of a `.pt` / `.dcp` checkpoint of this package, a
JAX `.fjax` file, or an export artifact of `export_forward` (the JAX
package's `tools/model_info.py` over the port's formats).

    python -m forwardtacotron_tpu_torch.tools.model_info \\
        checkpoints/ljspeech_tts.forward/latest_model.pt [--config]

`param_count` counts parameters only, as JAX counts its `params` tree:
buffers (BatchNorm statistics, `step`, `num_batches_tracked`, FastPitch's
positional table, the teacher's `decoder.r`) are not counted. A GAN
file's count is its generator with weight norm folded, plus its
discriminators where it holds them.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

from forwardtacotron_tpu_torch.tools.checkpoint_files import (build_model,
                                                              read_payload)
from forwardtacotron_tpu_torch.utils.export import MAGIC


def _parameters(payload: Dict[str, Any]) -> Dict[str, Any]:
    """name -> tensor of the payload's parameters (of 'model', the served
    weights)."""
    if payload['family'] == 'hifigan':
        return {**payload['model'],
                **{f'discriminator.{k}': v for k, v in
                   (payload['discriminator'] or {}).items()}}
    names = dict(build_model(payload['family'],
                             payload['config']).named_parameters())
    return {k: payload['model'][k] for k in names}


def describe_checkpoint(path, payload: Optional[Dict[str, Any]] = None
                        ) -> Dict[str, Any]:
    """The fields of JAX's `describe_checkpoint` (and the family) of the
    checkpoint at `path`, whose `read_payload` may be given."""
    payload = read_payload(path) if payload is None else payload
    config = payload['config'] or {}
    params = _parameters(payload)
    info = {
        'path': str(path),
        'format': payload['format'],
        'family': payload['family'],
        'step': payload['step'],
        'tts_model': config.get('tts_model'),
        'param_count': sum(int(v.numel()) for v in params.values()),
        'has_optim': payload['optim'] is not None,
        'has_ema': payload['raw_model'] is not None,
        'param_roots': sorted({k.split('.')[0] for k in params})[:12],
    }
    spk = None
    for section in ('forward_tacotron', 'fast_pitch'):
        model_cfg = config.get(section, {})
        if isinstance(model_cfg, dict):
            spk = model_cfg.get('model', {}).get('n_speakers', spk)
    if spk:
        info['n_speakers'] = spk
    return info


def is_artifact(path) -> bool:
    path = Path(path)
    if not path.is_file():
        return False
    with open(path, 'rb') as f:
        return f.read(len(MAGIC)) == MAGIC


def describe_artifact(path) -> Dict[str, Any]:
    from forwardtacotron_tpu_torch.utils.export import ExportedTTS
    exported = ExportedTTS(path)
    return {
        'path': str(path),
        'format': 'ftpt (torch.export artifact)',
        'meta': exported.meta,
        'buckets': sorted(exported.buckets),
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description='Inspect a checkpoint '
                                                 'or export artifact')
    parser.add_argument('path')
    parser.add_argument('--config', action='store_true',
                        help='also print the embedded config (JSON)')
    args = parser.parse_args(argv)

    config = None
    if is_artifact(args.path):
        info = describe_artifact(args.path)
    else:
        payload = read_payload(args.path)
        info = describe_checkpoint(args.path, payload)
        if args.config:
            config = payload['config']

    width = max(len(k) for k in info)
    for k, v in info.items():
        print(f'{k:<{width}}  {v}')
    if config is not None:
        print('\n--- embedded config ---')
        print(json.dumps(config, indent=2, default=str))
    return info


if __name__ == '__main__':
    main()
