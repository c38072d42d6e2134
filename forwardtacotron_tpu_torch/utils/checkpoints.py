"""Training checkpoints of the port, in the reference's torch format.

A `.pt` file holds {'model': state_dict, 'optim': optimizer state_dict,
'config', 'step'} (the reference's utils/checkpoints.py), with the step
also in the model's `step` buffer. That is the format the JAX package's
`utils/checkpoints.py:load_tts_checkpoint` converts
(`models/torch_compat.py`), so a model trained here loads there too.
With EMA weights (`training.ema_decay` > 0), 'model' holds the EMA
parameters with the live buffers, the weights meant to be served (what
the JAX package's `export_forward_tacotron(..., use_ema=True)` writes),
and 'raw_model' the raw training parameters, from which a run resumes.
Loading uses torch's weights-only unpickler: tensors, numbers, strings
and containers, no code. `init_tts_model` builds the TTS model a config
names.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch

from forwardtacotron_tpu_torch.models.fast_pitch import FastPitch
from forwardtacotron_tpu_torch.models.forward_tacotron import ForwardTacotron


def init_tts_model(config: Dict[str, Any]) -> torch.nn.Module:
    """The TTS model that `config['tts_model']` names (the JAX package's
    `utils/checkpoints.py:init_tts_model`), built from its config section
    with the global RNG's draws."""
    model_type = config.get('tts_model', 'forward_tacotron')
    if model_type == 'forward_tacotron':
        return ForwardTacotron.from_config(config)
    if model_type == 'fast_pitch':
        return FastPitch.from_config(config)
    raise ValueError(f'Model type not supported: {model_type}')


def save_payload(payload: Dict[str, Any], path: Union[str, Path]) -> None:
    """`torch.save` atomically: a temporary file, then rename."""
    path = Path(path)
    tmp = path.with_suffix(path.suffix + '.tmp')
    torch.save(payload, tmp)
    tmp.replace(path)


def checkpoint_payload(model: torch.nn.Module,
                       optimizer: Optional[torch.optim.Optimizer],
                       config: Dict[str, Any], step: int,
                       ema=None) -> Dict[str, Any]:
    """The payload of a checkpoint, tensors as they are (not copied);
    `ema` (`train/common.py:EMA`) puts its weights under 'model' and the
    raw ones under 'raw_model'."""
    model.step.fill_(int(step))
    state = model.state_dict()
    payload = {'model': state,
               'optim': None if optimizer is None else optimizer.state_dict(),
               'config': config, 'step': int(step)}
    if ema is not None:
        payload['model'] = {**state, **ema.params}
        payload['raw_model'] = state
    return payload


def save_checkpoint(model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer],
                    config: Dict[str, Any], path: Union[str, Path],
                    step: int, ema=None) -> None:
    """Write the checkpoint atomically (`save_payload`)."""
    save_payload(checkpoint_payload(model, optimizer, config, step, ema),
                 path)


def load_checkpoint(path: Union[str, Path]) -> Dict[str, Any]:
    """The payload of a `.pt` checkpoint, tensors on the CPU."""
    return torch.load(str(path), map_location='cpu', weights_only=True)


def restore(model: torch.nn.Module,
            optimizer: Optional[torch.optim.Optimizer],
            payload: Dict[str, Any], ema=None) -> int:
    """Load the raw weights (and the optimizer state when both are
    present) from a payload; returns its step. Optimizer state follows the
    parameters' device. `ema` takes the file's EMA weights, or a copy of
    the raw ones where the file has none."""
    raw = payload.get('raw_model')
    model.load_state_dict(payload['model'] if raw is None else raw)
    if optimizer is not None and payload.get('optim') is not None:
        optimizer.load_state_dict(payload['optim'])
    if ema is not None:
        ema.load(None if raw is None else payload['model'], model)
    return int(payload['step'])
