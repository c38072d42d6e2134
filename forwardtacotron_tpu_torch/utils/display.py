"""Console progress helpers and audio samples: a copy of `stream`,
`progbar`, `simple_table` and `log_audio` of the JAX package's
`utils/display.py` (the reference's utils/display.py:10-60). Plots are
not ported."""
from __future__ import annotations

import sys
from pathlib import Path
from typing import List, Tuple

import numpy as np


def progbar(i: int, n: int, size: int = 16) -> str:
    done = int(round(size * i / max(n, 1)))
    return '█' * done + '░' * (size - done)


def stream(message: str) -> None:
    sys.stdout.write(f'\r{message}')
    sys.stdout.flush()


def simple_table(item_tuples: List[Tuple[str, object]]) -> None:
    border_pattern = '+---------------------------------------'
    whitespace = '                                            '

    headings, cells = [], []
    for item in item_tuples:
        heading, cell = str(item[0]), str(item[1])
        pad_head = True if len(heading) < len(cell) else False
        pad = abs(len(heading) - len(cell))
        pad = whitespace[:pad]
        pad_left = pad[:len(pad) // 2]
        pad_right = pad[len(pad) // 2:]
        if pad_head:
            heading = pad_left + heading + pad_right
        else:
            cell = pad_left + cell + pad_right
        headings += [heading]
        cells += [cell]

    border, head, body = '', '', ''
    for i in range(len(item_tuples)):
        temp_head = f'| {headings[i]} '
        temp_body = f'| {cells[i]} '
        border += border_pattern[:len(temp_head)]
        head += temp_head
        body += temp_body
        if i == len(item_tuples) - 1:
            head += '|'
            body += '|'
            border += '+'
    print(border)
    print(head)
    print(border)
    print(body)
    print(border)
    print(' ')


def log_audio(writer, tag: str, wav: np.ndarray, step: int,
              sample_rate: int, fallback_dir=None) -> None:
    """`writer.add_audio` where the writer has it and can encode audio,
    else a 16-bit wav `<tag>_step<step>.wav` in `fallback_dir` (when
    given): tensorboardX's encoder needs soundfile, and the trainers'
    writers may only take scalars."""
    wav = np.asarray(wav, dtype=np.float32)
    add_audio = getattr(writer, 'add_audio', None)
    if add_audio is not None:
        try:
            add_audio(tag, wav, step, sample_rate)
            return
        except ImportError:
            pass
    if fallback_dir is not None:
        from scipy.io import wavfile
        out = Path(fallback_dir)
        out.mkdir(parents=True, exist_ok=True)
        wavfile.write(str(out / f"{tag.replace('/', '_')}_step{step}.wav"),
                      sample_rate,
                      (np.clip(wav, -1, 1) * 32767).astype(np.int16))
