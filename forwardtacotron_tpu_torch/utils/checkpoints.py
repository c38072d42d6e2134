"""Training checkpoints of the port, in the reference's torch format.

A `.pt` file holds {'model': state_dict, 'optim': optimizer state_dict,
'config', 'step'} (the reference's utils/checkpoints.py), with the step
also in the model's `step` buffer. That is the format the JAX package's
`utils/checkpoints.py:load_tts_checkpoint` converts
(`models/torch_compat.py`), so a model trained here loads there too.
Loading uses torch's weights-only unpickler: tensors, numbers, strings
and containers, no code.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch


def save_payload(payload: Dict[str, Any], path: Union[str, Path]) -> None:
    """`torch.save` atomically: a temporary file, then rename."""
    path = Path(path)
    tmp = path.with_suffix(path.suffix + '.tmp')
    torch.save(payload, tmp)
    tmp.replace(path)


def save_checkpoint(model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer],
                    config: Dict[str, Any], path: Union[str, Path],
                    step: int) -> None:
    """Write the checkpoint atomically (`save_payload`)."""
    model.step.fill_(int(step))
    save_payload({'model': model.state_dict(),
                  'optim': None if optimizer is None
                  else optimizer.state_dict(),
                  'config': config, 'step': int(step)}, path)


def load_checkpoint(path: Union[str, Path]) -> Dict[str, Any]:
    """The payload of a `.pt` checkpoint, tensors on the CPU."""
    return torch.load(str(path), map_location='cpu', weights_only=True)


def restore(model: torch.nn.Module,
            optimizer: Optional[torch.optim.Optimizer],
            payload: Dict[str, Any]) -> int:
    """Load weights (and the optimizer state when both are present) from
    a payload; returns its step. Optimizer state follows the parameters'
    device."""
    model.load_state_dict(payload['model'])
    if optimizer is not None and payload.get('optim') is not None:
        optimizer.load_state_dict(payload['optim'])
    return int(payload['step'])
