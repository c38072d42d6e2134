"""Console progress helpers: a copy of `stream`, `progbar` and
`simple_table` of the JAX package's `utils/display.py` (the reference's
utils/display.py:10-60). Plots are not ported."""
from __future__ import annotations

import sys
from typing import List, Tuple


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
