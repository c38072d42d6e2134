"""Dataset metadata recipes: a copy of the JAX package's
`text/recipes.py` (the reference's utils/text/recipes.py:6-14): the
LJSpeech layout (`id|...|text`) and the multi-speaker one
(`id|speaker|text`)."""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple, Union

from forwardtacotron_tpu_torch.utils.files import get_files


def _one_csv(path: Union[str, Path]) -> Path:
    csv_file = get_files(path, extension='.csv')
    if len(csv_file) != 1:
        raise ValueError(f'Expected exactly one .csv in {path}, found '
                         f'{len(csv_file)}')
    return csv_file[0]


def ljspeech(path: Union[str, Path]) -> Dict[str, str]:
    """{item id: text} of the one `.csv` under `path` (`id|...|text`)."""
    text_dict = {}
    with open(str(_one_csv(path)), encoding='utf-8') as f:
        for line in f:
            split = line.split('|')
            text_dict[split[0]] = split[-1]
    return text_dict


def multispeaker(path: Union[str, Path]
                 ) -> Tuple[Dict[str, str], Dict[str, int]]:
    """({item id: text}, {item id: speaker id}) of the one `.csv` under
    `path` (`id|speaker|text`, blank lines skipped). Speaker names map to
    dense ids in sorted name order, so preprocessing again keeps them."""
    text_dict: Dict[str, str] = {}
    speaker_names: Dict[str, str] = {}
    with open(str(_one_csv(path)), encoding='utf-8') as f:
        for line in f:
            if not line.strip():
                continue
            split = line.split('|')
            if len(split) < 3:
                raise ValueError('multispeaker metadata needs '
                                 f'id|speaker|text, got: {line!r}')
            text_dict[split[0]] = split[-1]
            speaker_names[split[0]] = split[1].strip()
    index = {name: i for i, name
             in enumerate(sorted(set(speaker_names.values())))}
    return text_dict, {item: index[name]
                       for item, name in speaker_names.items()}
