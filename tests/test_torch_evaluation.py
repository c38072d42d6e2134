"""The port's objective evaluation (`evaluation.py`, `eval_tts`) against
the JAX package's on the same inputs at 1e-5, and the step tracing of
`utils/profiling.py`.

`eval_wav_pair` runs each package's DSP on the CPU (mels and F0 of the
port's plain path against JAX's); `eval_tts` in wav mode and in `--mels`
mode gives the JSON summary line of `tools/eval_tts.py`. The
`StepTraceController` writes one Chrome trace of the steps that
FTT_PROFILE_* name, and does nothing without FTT_PROFILE_DIR.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SR = 22050


def _wav(f0, seconds=0.6, seed=0):
    """A voiced tone at `f0` Hz with two harmonics and a little noise,
    silent for its first tenth."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * SR)) / SR
    phase = 2 * np.pi * f0 * t
    y = 0.4 * np.sin(phase) + 0.2 * np.sin(2 * phase) \
        + 0.1 * np.sin(3 * phase) + 0.01 * rng.randn(len(t))
    y[:len(t) // 10] = 0.003 * rng.randn(len(t) // 10)
    return y.astype(np.float32)


def _assert_metrics(got, want, atol=1e-5):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float) and np.isnan(v):
            assert np.isnan(got[k]), k
        else:
            np.testing.assert_allclose(got[k], v, atol=atol, rtol=1e-5,
                                       err_msg=k)


def test_metrics_equal_jax():
    from forwardtacotron_tpu import evaluation as jev
    from forwardtacotron_tpu_torch import evaluation as ev
    rng = np.random.RandomState(1)
    a = (rng.randn(37, 80) - 5).astype(np.float32)
    b = (a[::2][:15] + 0.3 * rng.randn(15, 80)).astype(np.float32)
    got, path = ev.mcd_dtw(a, b)
    want, jpath = jev.mcd_dtw(a, b)
    np.testing.assert_array_equal(path, jpath)
    _assert_metrics(got, want)
    f0a = np.where(rng.rand(40) > 0.3, rng.uniform(80, 300, 40), 0.0)
    f0b = np.where(rng.rand(40) > 0.3, rng.uniform(80, 300, 40), 0.0)
    for p in (None, path):
        _assert_metrics(ev.f0_metrics(f0a, f0b, p),
                        jev.f0_metrics(f0a, f0b, p))
    _assert_metrics(ev.f0_metrics(np.zeros(5), np.zeros(5)),
                    jev.f0_metrics(np.zeros(5), np.zeros(5)))
    d_pred, d_true = rng.uniform(0, 5, 20), rng.randint(0, 5, 20)
    _assert_metrics(ev.duration_metrics(d_pred, d_true),
                    jev.duration_metrics(d_pred, d_true))
    # both layouts of the mel pair
    _assert_metrics(ev.eval_mel_pair(a.T, b), jev.eval_mel_pair(a.T, b))
    with pytest.raises(ValueError):
        ev.duration_metrics(d_pred, d_true[:3])
    per_file = {'x': got, 'y': dict(got, mcd_db=float('nan'))}
    assert ev.summarize(per_file) == jev.summarize(per_file)


def _dsps():
    from forwardtacotron_tpu.dsp.audio import DSP as JaxDSP
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.dsp.audio import DSP
    cfg = default_config()
    return DSP.from_config(cfg, 'cpu'), JaxDSP.from_config(cfg)


def test_eval_wav_pair_equals_jax():
    from forwardtacotron_tpu import evaluation as jev
    from forwardtacotron_tpu_torch import evaluation as ev
    dsp, jdsp = _dsps()
    ref, syn = _wav(140.0), _wav(140.0 * 2 ** (100 / 1200), seed=2)
    got = ev.eval_wav_pair(ref, syn, dsp)
    _assert_metrics(got, jev.eval_wav_pair(ref, syn, jdsp))
    # a shift of 100 cents reads as about 100 cents
    assert 70 < got['f0_rmse_cents'] < 130
    same = ev.eval_wav_pair(ref, ref, dsp)
    assert same['mcd_db'] == 0.0 and same['f0_rmse_cents'] == 0.0


def _write_pairs(root):
    from scipy.io import wavfile
    for d in ('ref', 'gen', 'ref_mel', 'gen_mel'):
        (root / d).mkdir()
    rng = np.random.RandomState(3)
    for i, f0 in enumerate((120.0, 180.0)):
        wavfile.write(root / 'ref' / f'{i}.wav', SR,
                      (_wav(f0, seed=i) * 32767).astype(np.int16))
        wavfile.write(root / 'gen' / f'{i}.wav', SR,
                      (_wav(f0 * 1.05, seed=i + 5) * 32767).astype(np.int16))
        mel = (rng.randn(80, 30) - 5).astype(np.float32)
        np.save(root / 'ref_mel' / f'{i}.npy', mel)
        np.save(root / 'gen_mel' / f'{i}.npy',
                mel[:, :25] + 0.2 * rng.randn(80, 25).astype(np.float32))
    np.save(root / 'gen_mel' / 'unpaired.npy', np.zeros((80, 4), np.float32))


@pytest.mark.parametrize('mels', [False, True])
def test_eval_tts_equals_jax(tmp_path, capsys, mels):
    import importlib.util
    from forwardtacotron_tpu_torch import eval_tts
    spec = importlib.util.spec_from_file_location(
        'jax_eval_tts', ROOT / 'tools' / 'eval_tts.py')
    jax_eval_tts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_eval_tts)
    _write_pairs(tmp_path)
    sfx = '_mel' if mels else ''
    args = ['--gen_dir', str(tmp_path / f'gen{sfx}'),
            '--ref_dir', str(tmp_path / f'ref{sfx}')] \
        + (['--mels'] if mels else [])
    assert eval_tts.main(args + ['--device', 'cpu', '--json',
                                 str(tmp_path / 'ours.json')]) == 0
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_eval_tts.main(args + ['--config', str(ROOT / 'config.yaml'),
                                     '--json',
                                     str(tmp_path / 'jax.json')]) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ours['metric'] == theirs['metric'] == 'mcd_db'
    assert ours['extra']['n_files'] == 2
    _assert_metrics(ours['extra'], theirs['extra'])
    report = json.loads((tmp_path / 'ours.json').read_text())
    assert sorted(report['per_file']) == ['0', '1']
    if not mels:
        assert 50 < ours['extra']['f0_rmse_cents'] < 120   # 84.5 cents
    assert eval_tts.main(['--gen_dir', str(tmp_path / 'ref'), '--ref_dir',
                          str(tmp_path / 'ref_mel')]) == 2


def _work():
    a = torch.randn(16, 16)
    return (a @ a).sum()


def test_step_trace_controller(tmp_path, monkeypatch):
    from forwardtacotron_tpu_torch.utils import profiling
    for key in ('DIR', 'START', 'STEPS'):
        monkeypatch.delenv(f'FTT_PROFILE_{key}', raising=False)
    idle = profiling.StepTraceController()
    for step in range(1, 6):
        _work()
        idle.tick(step)
    idle.close()
    assert idle.dir is None and idle.path is None

    monkeypatch.setenv('FTT_PROFILE_DIR', str(tmp_path / 'trace'))
    monkeypatch.setenv('FTT_PROFILE_START', '2')
    monkeypatch.setenv('FTT_PROFILE_STEPS', '2')
    tracer = profiling.StepTraceController()
    for step in range(1, 8):
        with profiling.annotate(f'step {step}'):
            _work()
        tracer.tick(step)
    tracer.close()
    files = list((tmp_path / 'trace').glob('*.pt.trace.json'))
    assert files == [tracer.path]
    names = {e.get('name') for e in
             json.loads(files[0].read_text())['traceEvents']}
    # steps 3 and 4 are inside the window, 2 and 5 are not
    assert {'step 3', 'step 4'} <= names and not names & {'step 2',
                                                          'step 5'}
    # the spans stored are those the window traced
    assert [s.name for s in profiling.spans()[-2:]] == ['step 3', 'step 4']
    with profiling.trace(tmp_path / 'region') as prof:
        with profiling.annotate('region'):
            _work()
    assert len(list((tmp_path / 'region').glob('*.json'))) == 1
    assert prof.key_averages()
    assert profiling.spans()[-1].name == 'region'


def test_kernel_launches_by_name():
    """`kernel_launches` maps every `__global__` kernel of the shipped
    CUDA sources to one key of the wrappers' launch counters, and counts
    only the card's events whose name holds that kernel's, each once."""
    import re
    from types import SimpleNamespace
    from forwardtacotron_tpu_torch.kernels.birnn import recurrence
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        train_backward, train_forward)
    from forwardtacotron_tpu_torch.utils.profiling import (KERNEL_NAMES,
                                                           kernel_launches)
    csrc = ROOT / 'forwardtacotron_tpu_torch' / 'csrc'
    shipped = set()
    for name in ('birnn.cu', 'birnn_train.cu', 'wavernn_sample.cu'):
        shipped |= set(re.findall(
            r'__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(',
            (csrc / name).read_text()))
    assert {k.rstrip('<') for k in KERNEL_NAMES} == shipped
    keys = ({f'birnn_{p}' for p in recurrence.path_launches}
            | {f'birnn_train_fwd_{p}' for p in train_forward.path_launches}
            | {f'birnn_train_bwd_{p}' for p in train_backward.path_launches}
            | {'wavernn_sample'})
    assert set(KERNEL_NAMES.values()) == keys

    def event(name, device='DeviceType.CUDA'):
        return SimpleNamespace(name=name, device_type=device)
    events = [event(f'void {k}float, true, 4>(Args)') for k in KERNEL_NAMES]
    events += [event('void train_fwd_cl_kernel<__nv_bfloat16, true, 8, '
                     '4, true>(ClArgs)'),
               event('cudaLaunchKernelExC', 'DeviceType.CPU'),
               event('void birnn_sl_kernel<float>(SlArgs)',
                     'DeviceType.CPU'),
               event('ampere_sgemm_128x64_nn')]
    counted = kernel_launches(SimpleNamespace(events=lambda: events))
    assert counted == {**dict.fromkeys(keys, 1),
                       'birnn_train_fwd_cluster': 2}
