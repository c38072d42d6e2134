"""File listing, pickle helpers and the training-schedule parser.

A copy of the JAX package's `utils/files.py` (the reference's
utils/files.py:7-43), without its YAML helpers: `config.read_config`
reads YAML where `pyyaml` is installed.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, List, Tuple, Union


def get_files(path: Union[str, Path], extension: str = '.wav') -> List[Path]:
    """Every file under `path` (recursively) with `extension`, sorted."""
    if isinstance(path, str):
        path = Path(path).expanduser().resolve()
    return sorted(path.rglob(f'*{extension}'))


def pickle_binary(data: object, file: Union[str, Path]) -> None:
    with open(str(file), 'wb') as f:
        pickle.dump(data, f)


def unpickle_binary(file: Union[str, Path]) -> Any:
    """Unpickling runs code from the file: read only files this program
    (or the repository's preprocessing) wrote."""
    with open(str(file), 'rb') as f:
        return pickle.load(f)


def parse_schedule(schedule: List[str]) -> List[Tuple]:
    """Parse training schedule rows.

    Each row is a comma-separated string. Four fields mean
    (r, lr, max_step, batch_size); three mean (lr, max_step, batch_size).
    Underscores in numbers are allowed ('10_000').
    """
    out: List[Tuple] = []
    for line in schedule:
        parts = [p.strip() for p in str(line).split(',')]
        if len(parts) == 4:
            r, lr, step, bs = parts
            out.append((int(r), float(lr), int(step), int(bs)))
        elif len(parts) == 3:
            lr, step, bs = parts
            out.append((float(lr), int(step), int(bs)))
        else:
            raise ValueError(f'Cannot parse schedule row: {line!r}')
    return out
