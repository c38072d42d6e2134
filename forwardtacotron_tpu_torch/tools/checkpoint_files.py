"""Checkpoints of either package as the port's payload, for the operator
tools (`average_checkpoints`, `model_info`, `export_torch`).

`read_payload(path)` reads a `.pt` file or `.dcp` directory of this
package, or a JAX `.fjax` file through `weights.py`'s converters, as

    {'model': state_dict (the EMA weights where the file has them),
     'raw_model': the raw weights, or None without EMA,
     'discriminator': a GAN file's discriminators, or None,
     'generator': a GAN `.pt` file's generator as stored (weight norm
                  split), or None,
     'optim', 'config', 'step', 'format', 'family'}

under the reference's torch key names. `family` (forward_tacotron,
fast_pitch, tacotron, wavernn, aligner or hifigan) is read from the
weights' names. A GAN file's generator comes with its
weight norm folded (`.weight`), as `models/hifigan.py` holds it.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Mapping, Union

import torch

from forwardtacotron_tpu_torch.utils.checkpoints import load_checkpoint

def state_family(state: Mapping[str, Any]) -> str:
    """The family of a port state_dict, by its keys."""
    if 'I.weight' in state:
        return 'wavernn'
    if 'decoder.attn_rnn.weight_ih' in state:
        return 'tacotron'
    if 'lstm.weight_ih_l0' in state:
        return 'forward_tacotron'
    if any(k.startswith('dur_pred.transformer.') for k in state):
        return 'fast_pitch'
    if 'text_enc.lin.weight' in state:
        return 'aligner'
    raise ValueError('unrecognised weights: not a model of this package')


def fjax_family(variables: Mapping[str, Any]) -> str:
    """The family of a JAX `.fjax` file's flax variables, by the rules of
    the JAX package's `models/torch_export.py:detect_family` (and the
    aligner's encoders)."""
    params = variables.get('params', variables)
    if 'I_kernel' in params:
        return 'wavernn'
    if 'dec_prenet' in params:
        return 'tacotron'
    if 'lstm' in params:
        return 'forward_tacotron'
    if 'dur_pred' in params and 'transformer' in params['dur_pred']:
        return 'fast_pitch'
    if 'text_enc' in params:
        return 'aligner'
    if 'generator' in params or ('conv_pre' in params and 'ups_0' in params):
        return 'hifigan'
    raise ValueError('unrecognised flax variables: not a model of the JAX '
                     'package that the port holds')


def _convert(family: str, variables: Dict[str, Any], config: Dict[str, Any],
             step: int) -> Dict[str, torch.Tensor]:
    from forwardtacotron_tpu_torch import weights
    if family in ('forward_tacotron', 'fast_pitch'):
        return weights.tts_state_dict(variables, config, step)
    if family == 'tacotron':
        return weights.tacotron_state_dict(
            variables, config['tacotron']['model'], step)
    if family == 'wavernn':
        return weights.wavernn_state_dict(
            variables, config['vocoder']['model'], step)
    if family == 'aligner':
        return weights.aligner_state_dict(variables, step)
    return weights.hifigan_state_dict(variables, config)


def _read_fjax(path: Path) -> Dict[str, Any]:
    from forwardtacotron_tpu_torch.weights import (discriminator_state_dict,
                                                   load_fjax)
    payload = load_fjax(path)
    family = fjax_family(payload['model'])
    config, step = payload['config'], payload['step']
    out = {'model': _convert(family, payload['model'], config, step),
           'raw_model': None, 'discriminator': None, 'generator': None,
           'optim': payload['optim'], 'config': config, 'step': step,
           'format': 'fjax (the JAX package)', 'family': family}
    if payload['has_ema'] and family != 'hifigan':
        out['raw_model'] = _convert(
            family, load_fjax(path, use_ema=False)['model'], config, step)
    if family == 'hifigan' and 'discriminator' in payload['model']['params']:
        out['discriminator'] = discriminator_state_dict(payload['model'])
    return out


def _gan_config(path: Path, payload: Dict[str, Any]) -> Dict[str, Any]:
    """A GAN file's config: its own, else the generator section from the
    config.json that the trainer writes beside it (else none)."""
    if payload.get('config'):
        return payload['config']
    beside = path.parent / 'config.json'
    if beside.is_file():
        return {'hifigan': {'model': json.loads(beside.read_text())}}
    return {}


def read_payload(path: Union[str, Path]) -> Dict[str, Any]:
    """The payload (module docstring) of a `.pt`, `.dcp` or `.fjax`
    checkpoint, tensors on the CPU. Unpickling a `.fjax` runs code from
    the file: read only checkpoints you trust."""
    from forwardtacotron_tpu_torch.models.hifigan import fold_weight_norm
    path = Path(path)
    if path.suffix == '.fjax':
        return _read_fjax(path)
    if path.suffix not in ('.pt', '.dcp'):
        raise ValueError(f'{path}: checkpoints are .pt or .dcp (this '
                         'package) or .fjax (the JAX package)')
    payload = load_checkpoint(path)
    fmt = payload.get('format', 'pt (this package)')
    if 'generator' in payload:
        return {'model': fold_weight_norm(payload['generator']),
                'raw_model': None,
                'discriminator': payload.get('discriminator'),
                'generator': payload['generator'],
                'optim': payload.get('optim_g'),
                'config': _gan_config(path, payload),
                'step': int(payload.get('step', 0)), 'format': fmt,
                'family': 'hifigan'}
    if 'model' not in payload:
        raise ValueError(f'{path}: not a checkpoint of this package (no '
                         "'model' or 'generator')")
    return {'model': payload['model'],
            'raw_model': payload.get('raw_model'), 'discriminator': None,
            'generator': None, 'optim': payload.get('optim'),
            'config': payload['config'],
            'step': int(payload['step']), 'format': fmt,
            'family': state_family(payload['model'])}


def build_model(family: str, config: Dict[str, Any]) -> torch.nn.Module:
    """The model of `family` that `config` describes, on the meta device
    (names and shapes, no storage); not for the GAN family."""
    from forwardtacotron_tpu_torch.align.aligner import aligner_from_config
    from forwardtacotron_tpu_torch.models.tacotron import Tacotron
    from forwardtacotron_tpu_torch.models.wavernn import WaveRNN
    from forwardtacotron_tpu_torch.utils.checkpoints import init_tts_model
    constructors = {'forward_tacotron': init_tts_model,
                    'fast_pitch': init_tts_model,
                    'tacotron': Tacotron.from_config,
                    'wavernn': WaveRNN.from_config,
                    'aligner': aligner_from_config}
    if family not in constructors:
        raise ValueError(f'no model constructor for {family}')
    if family in ('forward_tacotron', 'fast_pitch'):
        config = dict(config, tts_model=family)
    with torch.device('meta'):
        return constructors[family](config)
