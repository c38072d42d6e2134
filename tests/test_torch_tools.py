"""The port's operator tools (`forwardtacotron_tpu_torch/tools/`) against
the JAX package's `tools/` scripts on the CPU, on the same tiny
checkpoints written by the JAX package (ForwardTacotron with EMA weights,
FastPitch, the Tacotron teacher, WaveRNN, a HiFi-GAN generator) and on
the port's `.pt` / `.dcp` conversions of them:

- `average_checkpoints`: equal, at atol 0, to the conversion of JAX's
  `average_payloads` of the `.fjax` files (integer leaves from the last
  file); mismatched models refused by name;
- `model_info`: `param_count` and `has_ema` equal JAX's
  `describe_checkpoint`, as `.fjax` and as the port's `.pt`;
- `export_torch`: the file of JAX's `tools/export_torch.py`, key for key
  and tensor for tensor (atol 0);
- `make_synthetic_dataset`: the files of JAX's for seed 0;
- `f0_bound`: within the pinned bounds of
  `tests/test_dsp_golden.py::test_f0_quantified_bound` (PARITY.md).
"""
import copy
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / 'tools'))

HOP, N_MELS = 16, 12
TINY_FT = {
    'embed_dims': 16, 'series_embed_dims': 8,
    'durpred_conv_dims': 8, 'durpred_rnn_dims': 4, 'durpred_dropout': 0.5,
    'pitch_conv_dims': 8, 'pitch_rnn_dims': 4, 'pitch_dropout': 0.5,
    'pitch_strength': 1.0,
    'energy_conv_dims': 8, 'energy_rnn_dims': 4, 'energy_dropout': 0.5,
    'energy_strength': 1.0,
    'rnn_dims': 8, 'prenet_dims': 8, 'prenet_k': 2,
    'postnet_num_highways': 1, 'prenet_dropout': 0.5,
    'postnet_dims': 8, 'postnet_k': 2, 'prenet_num_highways': 1,
    'postnet_dropout': 0.0,
}
TINY_FP = {
    'durpred_dropout': 0.5, 'durpred_d_model': 8, 'durpred_n_heads': 2,
    'durpred_layers': 1, 'durpred_d_fft': 8,
    'pitch_dropout': 0.5, 'pitch_d_model': 8, 'pitch_n_heads': 2,
    'pitch_layers': 1, 'pitch_d_fft': 8,
    'energy_dropout': 0.5, 'energy_d_model': 8, 'energy_n_heads': 2,
    'energy_layers': 1, 'energy_d_fft': 8,
    'pitch_strength': 1.0, 'energy_strength': 1.0,
    'd_model': 16, 'conv1_kernel': 9, 'conv2_kernel': 1,
    'prenet_layers': 2, 'prenet_heads': 2, 'prenet_fft': 16,
    'prenet_dropout': 0.1,
    'postnet_layers': 2, 'postnet_heads': 2, 'postnet_fft': 16,
    'postnet_dropout': 0.1,
}
TINY_TACO = {'embed_dims': 16, 'encoder_dims': 128, 'decoder_dims': 256,
             'postnet_dims': 8, 'encoder_k': 2, 'lstm_dims': 32,
             'postnet_k': 3, 'num_highways': 1, 'dropout': 0.5,
             'stop_threshold': -11}
TINY_VOC = {'mode': 'RAW', 'upsample_factors': [4, 4], 'rnn_dims': 16,
            'fc_dims': 16, 'compute_dims': 8, 'res_out_dims': 8,
            'res_blocks': 1, 'pad': 2}
TINY_HIFI = {'generator_type': 'hifigan', 'resblock': '1',
             'upsample_rates': [4, 4], 'upsample_kernel_sizes': [8, 8],
             'upsample_initial_channel': 16, 'resblock_kernel_sizes': [3, 5],
             'resblock_dilation_sizes': [[1, 3], [1, 3]]}
FAMILIES = ('forward_tacotron', 'fast_pitch', 'tacotron', 'wavernn',
            'hifigan')


def _config(family='forward_tacotron', **model_updates):
    from forwardtacotron_tpu.utils.files import read_config
    cfg = read_config(ROOT / 'config.yaml')
    cfg['dsp'].update(n_fft=64, win_length=64, hop_length=HOP,
                      num_mels=N_MELS)
    cfg['forward_tacotron']['model'] = dict(TINY_FT, **model_updates)
    cfg['fast_pitch']['model'] = dict(TINY_FP)
    cfg['tacotron']['model'] = dict(TINY_TACO)
    cfg['vocoder']['model'] = dict(TINY_VOC)
    cfg['hifigan']['model'] = dict(TINY_HIFI)
    if family in ('forward_tacotron', 'fast_pitch'):
        cfg['tts_model'] = family
    return cfg


def _fill_stats(tree, rng):
    """Batch-norm statistics drawn at random (means ~0.1, variances in
    [0.5, 1.5]), so that averages and conversions see distinct values."""
    return {k: _fill_stats(v, rng) if isinstance(v, dict) else
            (rng.randn(*v.shape) * 0.1 if k == 'mean'
             else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
            for k, v in tree.items()}


def _jax_variables(family, cfg, seed):
    """Numpy flax variables of `family` at `cfg`'s widths from `seed`."""
    key = jax.random.PRNGKey(seed)
    if family == 'forward_tacotron':
        from forwardtacotron_tpu.models.forward_tacotron import (
            ForwardTacotron)
        v = ForwardTacotron.from_config(cfg).init(
            {'params': key}, jnp.ones((1, 8), jnp.int32), 32,
            method='generate', x_len=jnp.asarray([8]))
    elif family == 'fast_pitch':
        from forwardtacotron_tpu.models.fast_pitch import FastPitch
        batch = {'x': jnp.ones((2, 6), jnp.int32),
                 'x_len': jnp.asarray([6, 4]),
                 'mel': jnp.zeros((2, 10, N_MELS)),
                 'mel_len': jnp.asarray([8, 6]),
                 'dur': jnp.ones((2, 6)), 'pitch': jnp.zeros((2, 6)),
                 'energy': jnp.zeros((2, 6))}
        v = FastPitch.from_config(cfg).init({'params': key}, batch,
                                            train=False)
    elif family == 'tacotron':
        from forwardtacotron_tpu.models.tacotron import Tacotron
        v = Tacotron.from_config(cfg).init(
            {'params': key}, jnp.ones((2, 9), jnp.int32),
            jnp.zeros((2, 20, N_MELS)), 5, train=False)
    elif family == 'wavernn':
        from forwardtacotron_tpu.models.wavernn import WaveRNN
        v = WaveRNN.from_config(cfg).init(key, jnp.zeros((1, 6 * HOP)),
                                          jnp.zeros((1, 10, N_MELS)))
    else:
        from forwardtacotron_tpu.models.hifigan import HiFiGANGenerator
        v = HiFiGANGenerator.from_config(TINY_HIFI).init(
            key, jnp.zeros((1, 8, N_MELS)))
        return {'params': {'generator': jax.tree.map(np.asarray,
                                                     v['params'])}}
    v = jax.tree.map(np.asarray, dict(v))
    if 'batch_stats' in v:
        v['batch_stats'] = _fill_stats(v['batch_stats'],
                                       np.random.RandomState(seed))
    return v


def _save_fjax(path, family, seed, step, ema=False, **model_updates):
    from forwardtacotron_tpu.utils.checkpoints import save_checkpoint
    cfg = _config(family, **model_updates)
    variables = _jax_variables(family, cfg, seed)
    if ema:
        variables['ema_params'] = jax.tree.map(lambda a: a * 0.5 + 0.01,
                                               variables['params'])
    save_checkpoint(variables, cfg, path, step=step)
    return path


def _port_payload(fjax_path, family='forward_tacotron'):
    """The port's payload of a `.fjax` (its `.pt` layout), converted by
    `weights.py`: 'model' the EMA weights where the file has them and
    'raw_model' the raw ones."""
    from forwardtacotron_tpu_torch import weights
    payload = weights.load_fjax(fjax_path)
    cfg, step = payload['config'], payload['step']
    convert = {
        'forward_tacotron': lambda v: weights.tts_state_dict(v, cfg, step),
        'fast_pitch': lambda v: weights.tts_state_dict(v, cfg, step),
        'tacotron': lambda v: weights.tacotron_state_dict(
            v, cfg['tacotron']['model'], step),
        'wavernn': lambda v: weights.wavernn_state_dict(
            v, cfg['vocoder']['model'], step)}[family]
    out = {'model': convert(payload['model']), 'optim': None, 'config': cfg,
           'step': step}
    if payload['has_ema']:
        out['raw_model'] = convert(
            weights.load_fjax(fjax_path, use_ema=False)['model'])
    return out


def _write_port(fjax_path, suffix, family='forward_tacotron'):
    """The port's `.pt` file or `.dcp` directory beside a `.fjax`."""
    from forwardtacotron_tpu_torch.utils.checkpoints import (save_directory,
                                                             save_payload)
    path = fjax_path.with_suffix(suffix)
    payload = _port_payload(fjax_path, family)
    if suffix == '.dcp':
        save_directory(payload, path)
    else:
        save_payload(payload, path)
    return path


def _assert_equal_states(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


@pytest.fixture(scope='module')
def tts_runs(tmp_path_factory):
    """Three ForwardTacotron `.fjax` files of one config (steps 10, 20,
    30) and three with EMA weights."""
    d = tmp_path_factory.mktemp('avg')
    plain = [_save_fjax(d / f'plain{i}.fjax', 'forward_tacotron', i, 10 * i)
             for i in (1, 2, 3)]
    ema = [_save_fjax(d / f'ema{i}.fjax', 'forward_tacotron', i + 3,
                      10 * i, ema=True) for i in (1, 2, 3)]
    return plain, ema


def _jax_average(paths):
    from average_checkpoints import average_payloads
    from forwardtacotron_tpu.utils.checkpoints import restore_checkpoint
    return average_payloads([restore_checkpoint(p) for p in paths])


@pytest.mark.parametrize('kind', ['.pt', '.fjax', '.dcp'])
def test_average_equals_jax(tts_runs, tmp_path, kind):
    from forwardtacotron_tpu_torch.tools import average_checkpoints
    from forwardtacotron_tpu_torch.utils.checkpoints import load_checkpoint
    from forwardtacotron_tpu_torch.weights import tts_state_dict
    fjax = tts_runs[0]
    inputs = fjax if kind == '.fjax' else [_write_port(p, kind)
                                           for p in fjax]
    out = tmp_path / f'avg{".dcp" if kind == ".dcp" else ".pt"}'
    average_checkpoints.main([str(p) for p in inputs] + ['--output',
                                                         str(out)])
    got = load_checkpoint(out)
    ref = _jax_average(fjax)
    assert got['step'] == ref['step'] == 30 and got.get('optim') is None
    assert got['config'] == ref['config']
    want = tts_state_dict(ref['model'], ref['config'], ref['step'])
    _assert_equal_states(got['model'], want)
    assert 'raw_model' not in got
    # integer leaves come from the last file, floats are not its own
    assert int(got['model']['step'][0]) == 30
    last = _port_payload(fjax[-1])['model']
    assert not torch.equal(got['model']['lin.weight'], last['lin.weight'])


def test_average_with_ema_equals_jax(tts_runs, tmp_path):
    from forwardtacotron_tpu_torch.tools import average_checkpoints
    from forwardtacotron_tpu_torch.utils.checkpoints import load_checkpoint
    from forwardtacotron_tpu_torch.weights import tts_state_dict
    fjax = tts_runs[1]
    out = tmp_path / 'avg.pt'
    average_checkpoints.main([str(_write_port(p, '.pt')) for p in fjax]
                             + ['--output', str(out)])
    got = load_checkpoint(out)
    ref = _jax_average(fjax)['model']
    raw = {k: v for k, v in ref.items() if k != 'ema_params'}
    _assert_equal_states(got['model'], tts_state_dict(
        dict(raw, params=ref['ema_params']), _config(), 30))
    _assert_equal_states(got['raw_model'], tts_state_dict(raw, _config(),
                                                          30))


def test_average_refuses_mismatched_models(tts_runs, tmp_path):
    from forwardtacotron_tpu_torch.tools.average_checkpoints import (
        average_payloads)
    from forwardtacotron_tpu_torch.tools.checkpoint_files import (
        read_payload)
    plain, ema = tts_runs
    a = read_payload(plain[0])
    wide = read_payload(_save_fjax(tmp_path / 'wide.fjax',
                                   'forward_tacotron', 9, 5, rnn_dims=12))
    with pytest.raises(ValueError, match=r"checkpoint #0: 'model' "
                                         r'lstm\..* has shape'):
        average_payloads([wide, a])
    missing = copy.deepcopy(a)
    del missing['model']['lin.bias']
    with pytest.raises(ValueError, match=r"checkpoint #0: 'model' keys "
                                         r"differ .*missing \['lin.bias'\]"):
        average_payloads([missing, a])
    with pytest.raises(ValueError, match='carry EMA weights'):
        average_payloads([a, read_payload(ema[0])])
    gan = read_payload(_save_fjax(tmp_path / 'g.fjax', 'hifigan', 1, 1))
    with pytest.raises(ValueError, match='GAN checkpoint'):
        average_payloads([gan, gan])


@pytest.fixture(scope='module')
def family_files(tmp_path_factory):
    """A `.fjax` of each family (ForwardTacotron with EMA) and the port's
    `.pt` of it (HiFi-GAN: the official generator layout with the
    config)."""
    from forwardtacotron_tpu_torch.models.hifigan import (
        load_hifigan, weight_norm_state_dict)
    d = tmp_path_factory.mktemp('families')
    out = {}
    for i, family in enumerate(FAMILIES):
        fjax = _save_fjax(d / f'{family}.fjax', family, 20 + i, 1000 + i,
                          ema=family == 'forward_tacotron')
        if family == 'hifigan':
            pt = d / 'hifigan.pt'
            gen = load_hifigan(fjax, device='cpu')
            torch.save({'generator': weight_norm_state_dict(gen),
                        'config': _config(), 'step': 1000 + i}, pt)
        else:
            pt = _write_port(fjax, '.pt', family)
        out[family] = (fjax, pt)
    return out


@pytest.mark.parametrize('family', FAMILIES)
def test_model_info_counts_equal_jax(family_files, family, capsys):
    from model_info import describe_checkpoint as jax_describe
    from forwardtacotron_tpu_torch.tools import model_info
    fjax, pt = family_files[family]
    ref = jax_describe(fjax)
    for path in (fjax, pt):
        got = model_info.main([str(path)])
        assert got['family'] == family, path
        assert got['param_count'] == ref['param_count'], path
        assert got['has_ema'] == ref['has_ema'], path
        assert got['step'] == ref['step'], path
    assert ref['has_ema'] == (family == 'forward_tacotron')
    printed = capsys.readouterr().out
    assert f'param_count  {ref["param_count"]}' in printed


def test_model_info_reads_directories_and_artifacts(family_files,
                                                     tmp_path, capsys):
    from forwardtacotron_tpu_torch.gen_forward import load_tts
    from forwardtacotron_tpu_torch.tools import model_info
    from forwardtacotron_tpu_torch.utils.export import save_exported_tts
    fjax, pt = family_files['forward_tacotron']
    dcp = _write_port(fjax, '.dcp')
    got = model_info.main([str(dcp), '--config'])
    assert got['format'] == 'forwardtacotron_tpu_torch.dcp.v1'
    assert got['param_count'] == model_info.describe_checkpoint(pt)[
        'param_count']
    assert '"tts_model": "forward_tacotron"' in capsys.readouterr().out
    model, _, _ = load_tts(str(pt), _config(), device='cpu')
    artifact = tmp_path / 'tts.ftpt'
    save_exported_tts(model, artifact, buckets=((16, 64),))
    info = model_info.main([str(artifact)])
    assert info['buckets'] == [(16, 64)]
    assert info['meta']['device'] == 'cpu' and info['meta']['vocoder'] is None


def _jax_export(monkeypatch, argv):
    import export_torch as jax_tool
    monkeypatch.setattr(sys, 'argv', ['export_torch.py', *argv])
    jax_tool.main()


@pytest.mark.parametrize('family', FAMILIES)
def test_export_torch_equals_jax(family_files, family, tmp_path,
                                 monkeypatch):
    from forwardtacotron_tpu_torch.tools import export_torch
    fjax, pt = family_files[family]
    extra = ['--r', '2'] if family == 'tacotron' else []
    cases = [([], fjax)]
    if family != 'hifigan':
        cases.append(([], pt))
    if family == 'forward_tacotron':
        cases += [(['--no_ema'], fjax), (['--no_ema'], pt)]
    for flags, source in cases:
        ref, got = tmp_path / 'ref.pt', tmp_path / 'got.pt'
        _jax_export(monkeypatch, ['--checkpoint', str(fjax), '--out',
                                  str(ref), *extra, *flags])
        assert export_torch.main(['--checkpoint', str(source), '--out',
                                  str(got), *extra, *flags]) == family
        want = torch.load(ref, weights_only=True)
        have = torch.load(got, weights_only=True)
        assert set(have) == set(want), (flags, source)
        key = 'generator' if family == 'hifigan' else 'model'
        _assert_equal_states(have[key], want[key])
        if family != 'hifigan':
            assert have['optim'] is None and have['config'] == want['config']
        if family == 'tacotron':
            assert int(have['model']['decoder.r']) == 2


def test_export_torch_refusals(family_files, tmp_path):
    from forwardtacotron_tpu_torch.tools import export_torch
    fjax, _ = family_files['wavernn']
    with pytest.raises(SystemExit):
        export_torch.main(['--checkpoint', str(fjax), '--out',
                           str(tmp_path / 'x.pt'), '--family', 'tacotron'])
    spk = _save_fjax(tmp_path / 'spk.fjax', 'forward_tacotron', 3, 1,
                     n_speakers=4)
    with pytest.raises(ValueError, match='multi-speaker'):
        export_torch.main(['--checkpoint', str(spk), '--out',
                           str(tmp_path / 'x.pt')])
    from forwardtacotron_tpu.models.melgan import MelGANGenerator
    from forwardtacotron_tpu.utils.checkpoints import save_checkpoint
    cfg = _config()
    cfg['hifigan']['model'] = dict(generator_type='melgan',
                                   upsample_initial_channel=16,
                                   upsample_rates=[4, 4])
    melgan = MelGANGenerator(n_mels=N_MELS, base_channels=16,
                             upsample_rates=(4, 4))
    v = melgan.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, N_MELS)))
    save_checkpoint({'params': {'generator': jax.tree.map(
        np.asarray, v['params'])}}, cfg, tmp_path / 'm.fjax', step=1)
    with pytest.raises(ValueError, match='melgan generator'):
        export_torch.main(['--checkpoint', str(tmp_path / 'm.fjax'),
                           '--out', str(tmp_path / 'x.pt')])


def test_make_synthetic_dataset_equals_jax(tmp_path, monkeypatch):
    import json
    from make_synthetic_dataset import make_dataset as jax_make
    from forwardtacotron_tpu.utils.paths import Paths as JaxPaths
    from forwardtacotron_tpu_torch.tools import make_synthetic_dataset
    from forwardtacotron_tpu_torch.utils.paths import Paths
    cfg = _config()
    jax_make(JaxPaths(str(tmp_path / 'jax'), 'v', 't', base=tmp_path / 'a'),
             cfg, n_items=10, n_val=2, seed=0)
    cfg['data_path'] = str(tmp_path / 'port')
    (tmp_path / 'cfg.json').write_text(json.dumps(cfg))
    monkeypatch.setenv('FTT_BASE', str(tmp_path / 'b'))
    assert make_synthetic_dataset.main(
        ['--config', str(tmp_path / 'cfg.json'), '--seed', '0']) == 10
    assert Paths(cfg['data_path'], 't').data == tmp_path / 'port'
    want = sorted(p.relative_to(tmp_path / 'jax')
                  for p in (tmp_path / 'jax').rglob('*') if p.is_file())
    got = sorted(p.relative_to(tmp_path / 'port')
                 for p in (tmp_path / 'port').rglob('*') if p.is_file())
    assert got == want and len(want) == 6 * 10 + 4
    for rel in want:
        assert (tmp_path / 'port' / rel).read_bytes() == \
            (tmp_path / 'jax' / rel).read_bytes(), rel


def test_f0_bound_within_the_pinned_bounds(capsys):
    from f0_bound import run as jax_run
    from forwardtacotron_tpu_torch.tools import f0_bound
    out = f0_bound.main(['--device', 'cpu'])
    assert '"nac_vs_truth"' in capsys.readouterr().out
    # tests/test_dsp_golden.py::test_f0_quantified_bound's floors
    nt = out['nac_vs_truth']
    assert nt['vuv_agreement'] >= 0.99, nt
    assert nt['cents_rmse_voiced'] <= 5.0, nt
    ny = out['nac_vs_yin']
    assert ny['vuv_agreement'] >= 0.85, ny
    assert ny['cents_rmse_voiced'] <= 20.0, ny
    yt = out['yin_vs_truth']
    assert yt['cents_rmse_voiced'] <= 20.0, yt
    # the oracle is the JAX tool's, on the same signal
    assert yt == jax_run()['yin_vs_truth']


@pytest.mark.parametrize('entry', ['Synthesizer', 'benchmark_serving',
                                   'f0_bound'])
def test_entry_points_default_to_cuda(entry, monkeypatch):
    """Without `device` / `--device` the entry points ask for CUDA, and
    raise where it is missing rather than run on the CPU."""
    from forwardtacotron_tpu_torch.notebook_utils.synthesize import (
        Synthesizer)
    from forwardtacotron_tpu_torch.tools import benchmark_serving, f0_bound
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    runs = {'Synthesizer': lambda: Synthesizer(None),
            'benchmark_serving': lambda: benchmark_serving.main([]),
            'f0_bound': lambda: f0_bound.main([])}
    with pytest.raises(RuntimeError, match='CUDA device requested'):
        runs[entry]()
