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

A path with the suffix `.dcp` is a checkpoint directory instead (the
counterpart of the JAX package's orbax directory, `.orbax`): the
payload's tensors under `state/` through `torch.distributed.checkpoint`,
every rank of a process group writing its part, and `meta.pt` with the
config, the step, the format and whether it holds an optimizer. All ranks
call `save_checkpoint` together; any one process can load it. An orbax
directory cannot be read here (orbax is JAX's).
"""
from __future__ import annotations

import io
import shutil
import warnings
from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch
import torch.distributed as dist

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


DIRECTORY_SUFFIX = '.dcp'
DIRECTORY_FORMAT = 'forwardtacotron_tpu_torch.dcp.v1'


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def save_directory(payload: Dict[str, Any], path: Union[str, Path]) -> None:
    """A payload as a checkpoint directory: its tensors (every key but
    'config' and 'step') under `path/state` through
    `torch.distributed.checkpoint` and `path/meta.pt`. With a process
    group up every rank calls it with its (equal) payload and writes its
    part; rank 0 clears an old `state/` first and writes `meta.pt`."""
    import torch.distributed.checkpoint as dcp
    path = Path(path).absolute()
    main = not _group_up() or dist.get_rank() == 0
    if main:
        shutil.rmtree(path / 'state', ignore_errors=True)
        path.mkdir(parents=True, exist_ok=True)
    if _group_up():
        dist.barrier()
    tensors = {k: v for k, v in payload.items()
               if k not in ('config', 'step') and v is not None}
    with warnings.catch_warnings():
        # one process without a group is the intended single-writer case
        warnings.filterwarnings('ignore', message='torch.distributed is')
        dcp.save(tensors, checkpoint_id=str(path / 'state'))
    if main:
        save_payload({'config': payload['config'],
                      'step': int(payload['step']),
                      'format': DIRECTORY_FORMAT,
                      'has_optim': payload.get('optim') is not None},
                     path / 'meta.pt')
    if _group_up():
        dist.barrier()


def _load_directory(path: Path) -> Dict[str, Any]:
    """The payload of a checkpoint directory, tensors on the CPU, read by
    this process alone."""
    from torch.distributed.checkpoint.format_utils import dcp_to_torch_save
    meta = torch.load(str(path / 'meta.pt'), map_location='cpu',
                      weights_only=True)
    buffer = io.BytesIO()
    with warnings.catch_warnings():
        warnings.filterwarnings('ignore', message='torch.distributed is')
        dcp_to_torch_save(str(path / 'state'), buffer)
    buffer.seek(0)
    payload = torch.load(buffer, map_location='cpu', weights_only=True)
    optim = payload.get('optim')
    if optim is not None:
        # the directory keys every mapping by string; an optimizer's
        # state is keyed by the parameter's index
        optim['state'] = {int(k): v for k, v in optim['state'].items()}
    return {**payload, 'optim': optim, 'config': meta['config'],
            'step': meta['step'], 'format': meta['format']}


def save_checkpoint(model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer],
                    config: Dict[str, Any], path: Union[str, Path],
                    step: int, ema=None) -> None:
    """Write the checkpoint: atomically to one file (`save_payload`), or,
    for a path ending in `.dcp`, as a checkpoint directory
    (`save_directory`, which every rank of a process group calls)."""
    payload = checkpoint_payload(model, optimizer, config, step, ema)
    if Path(path).suffix == DIRECTORY_SUFFIX:
        save_directory(payload, path)
    else:
        save_payload(payload, path)


def load_checkpoint(path: Union[str, Path]) -> Dict[str, Any]:
    """The payload of a `.pt` checkpoint or of a checkpoint directory,
    tensors on the CPU."""
    path = Path(path)
    if path.is_dir():
        return _load_directory(path)
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
