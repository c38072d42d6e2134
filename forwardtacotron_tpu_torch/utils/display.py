"""Console progress, figures and audio samples: a copy of the JAX
package's `utils/display.py` (the reference's utils/display.py:10-131):
`stream`, `progbar`, `simple_table`, `time_since`, `plot_mel`,
`plot_pitch`, `plot_attention`, `save_attention`, `save_spectrogram` and
`log_audio`. matplotlib is imported only when a figure is made (`_plt`,
the Agg backend), so importing the port never needs it."""
from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import List, Optional, Tuple

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


def time_since(started: float) -> str:
    elapsed = time.time() - started
    m = int(elapsed // 60)
    s = int(elapsed % 60)
    if m >= 60:
        h = int(m // 60)
        m = m % 60
        return f'{h}h {m}m {s}s'
    return f'{m}m {s}s'


def _plt():
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def can_plot() -> bool:
    """Whether matplotlib can be imported (`_plt`)."""
    try:
        _plt()
    except ImportError:
        return False
    return True


def plot_mel(mel: np.ndarray):
    """A (12, 6) figure of a mel in (n_mels, T) or (T, n_mels) layout,
    frequency up."""
    plt = _plt()
    mel = np.asarray(mel)
    if mel.shape[0] > mel.shape[1]:
        mel = mel.T
    fig = plt.figure(figsize=(12, 6))
    plt.imshow(mel, interpolation='nearest', aspect='auto', origin='lower')
    return fig


def plot_pitch(pitch: np.ndarray):
    """A (12, 3) figure of a series, flattened."""
    plt = _plt()
    fig = plt.figure(figsize=(12, 3))
    plt.plot(np.asarray(pitch).flatten())
    return fig


def plot_attention(attn: np.ndarray):
    """A (12, 6) figure of an attention matrix as it is."""
    plt = _plt()
    fig = plt.figure(figsize=(12, 6))
    plt.imshow(np.asarray(attn), interpolation='nearest', aspect='auto')
    return fig


def save_attention(attn: np.ndarray, path) -> None:
    """`plot_attention` written to `<path>.png`."""
    plt = _plt()
    fig = plot_attention(attn)
    fig.savefig(f'{path}.png', bbox_inches='tight')
    plt.close(fig)


def save_spectrogram(M: np.ndarray, path, length: Optional[int] = None
                     ) -> None:
    """`plot_mel` of M's first `length` columns (all where None) written
    to `<path>.png`."""
    plt = _plt()
    M = np.asarray(M)
    if length:
        M = M[:, :length]
    fig = plot_mel(M)
    fig.savefig(f'{path}.png', bbox_inches='tight')
    plt.close(fig)


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
