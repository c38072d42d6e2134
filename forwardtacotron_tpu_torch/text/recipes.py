"""Dataset metadata recipes: a copy of the JAX package's
`text/recipes.py` (the reference's utils/text/recipes.py:6-14). Only the
LJSpeech layout is ported; multi-speaker metadata is refused."""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Union

from forwardtacotron_tpu_torch.utils.files import get_files


def ljspeech(path: Union[str, Path]) -> Dict[str, str]:
    """{item id: text} of the one `.csv` under `path` (`id|...|text`)."""
    csv_file = get_files(path, extension='.csv')
    if len(csv_file) != 1:
        raise ValueError(f'Expected exactly one .csv in {path}, found '
                         f'{len(csv_file)}')
    text_dict = {}
    with open(str(csv_file[0]), encoding='utf-8') as f:
        for line in f:
            split = line.split('|')
            text_dict[split[0]] = split[-1]
    return text_dict
