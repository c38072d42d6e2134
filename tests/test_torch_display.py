"""The port's figures and timers (`utils/display.py`) against the JAX
package's on the same seeded arrays: each figure's size, its image arrays
and its line data equal (exactly: both draw the same numpy arrays through
matplotlib), a mel in both orientations; `save_attention` and
`save_spectrogram` write a png; `time_since` equals JAX's at fixed
times; importing the port's module imports no matplotlib."""
import subprocess
import sys

import numpy as np
import pytest


def _content(fig):
    """(size in inches, image arrays, line data) of a figure's axes, then
    the figure closed."""
    import matplotlib.pyplot as plt
    ax = fig.axes[0]
    out = (tuple(fig.get_size_inches()),
           [np.asarray(im.get_array()) for im in ax.images],
           [np.asarray(line.get_ydata()) for line in ax.lines],
           [im.origin for im in ax.images])
    plt.close(fig)
    return out


def _same(a, b):
    assert a[0] == b[0] and a[3] == b[3]
    assert len(a[1]) == len(b[1]) and len(a[2]) == len(b[2])
    for x, y in zip(a[1] + a[2], b[1] + b[2]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize('layout', ('n_mels_first', 'time_first'))
def test_plot_mel_matches_jax(layout):
    from forwardtacotron_tpu.utils import display as jd
    from forwardtacotron_tpu_torch.utils import display as pd
    mel = np.random.RandomState(0).randn(80, 123).astype(np.float32)
    if layout == 'time_first':
        mel = mel.T
    got, want = _content(pd.plot_mel(mel)), _content(jd.plot_mel(mel))
    _same(got, want)
    assert got[0] == (12.0, 6.0) and got[1][0].shape == (80, 123)


@pytest.mark.parametrize('shape', ((57,), (1, 57)))
def test_plot_pitch_matches_jax(shape):
    from forwardtacotron_tpu.utils import display as jd
    from forwardtacotron_tpu_torch.utils import display as pd
    pitch = np.random.RandomState(1).randn(*shape).astype(np.float32)
    got, want = _content(pd.plot_pitch(pitch)), _content(jd.plot_pitch(pitch))
    _same(got, want)
    assert got[0] == (12.0, 3.0) and got[2][0].shape == (57,)


def test_plot_attention_matches_jax():
    from forwardtacotron_tpu.utils import display as jd
    from forwardtacotron_tpu_torch.utils import display as pd
    attn = np.random.RandomState(2).rand(40, 17).astype(np.float32)
    got = _content(pd.plot_attention(attn))
    _same(got, _content(jd.plot_attention(attn)))
    assert got[1][0].shape == (40, 17)


def test_save_attention_and_spectrogram_write_pngs(tmp_path):
    from forwardtacotron_tpu_torch.utils import display as pd
    rng = np.random.RandomState(3)
    pd.save_attention(rng.rand(20, 9), tmp_path / 'att')
    pd.save_spectrogram(rng.randn(80, 50), tmp_path / 'spec', length=30)
    pd.save_spectrogram(rng.randn(80, 50), tmp_path / 'whole')
    for name in ('att', 'spec', 'whole'):
        data = (tmp_path / f'{name}.png').read_bytes()
        assert data[:8] == b'\x89PNG\r\n\x1a\n' and len(data) > 1000


@pytest.mark.parametrize('elapsed', (0.0, 59.9, 61.0, 3599.0, 3600.0,
                                     7384.5))
def test_time_since_matches_jax(monkeypatch, elapsed):
    from forwardtacotron_tpu.utils import display as jd
    from forwardtacotron_tpu_torch.utils import display as pd
    monkeypatch.setattr('time.time', lambda: 1000.0 + elapsed)
    assert pd.time_since(1000.0) == jd.time_since(1000.0)
    assert pd.time_since(1000.0).endswith('s')


def test_import_needs_no_matplotlib():
    code = ('import sys; sys.modules["matplotlib"] = None; '
            'from forwardtacotron_tpu_torch.utils import display; '
            'import forwardtacotron_tpu_torch.train.forward_trainer; '
            'import forwardtacotron_tpu_torch.train.taco_trainer; '
            'assert not display.can_plot(); print("ok")')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == 'ok', out.stderr
