"""Contracts of the PyTorch port that need no model run: the weight
converter against the JAX package's torch exporter, the built-in config
against config.yaml, the text front-end's token ids, the import guard,
and the refusal to drop silently to the CPU."""
import ast
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

ROOT = Path(__file__).resolve().parent.parent
FT_CFG = {
    'embed_dims': 16, 'series_embed_dims': 8,
    'durpred_conv_dims': 12, 'durpred_rnn_dims': 4, 'durpred_dropout': 0.5,
    'pitch_conv_dims': 12, 'pitch_rnn_dims': 6, 'pitch_dropout': 0.5,
    'pitch_strength': 1.0,
    'energy_conv_dims': 12, 'energy_rnn_dims': 3, 'energy_dropout': 0.5,
    'energy_strength': 1.0,
    'rnn_dims': 12, 'prenet_dims': 8, 'prenet_k': 3, 'prenet_dropout': 0.5,
    'prenet_num_highways': 2, 'postnet_dims': 8, 'postnet_k': 2,
    'postnet_num_highways': 1, 'postnet_dropout': 0.0,
}
VOC_CFG = dict(rnn_dims=16, fc_dims=16, pad=2, upsample_factors=[2, 2],
               compute_dims=8, res_out_dims=8, res_blocks=2, mode='MOL')


def _assert_same(sd, ref):
    assert set(sd) == set(ref)
    for k in ref:
        assert sd[k].dtype == ref[k].dtype and torch.equal(sd[k], ref[k]), k


def test_forward_tacotron_state_dict_equals_torch_export():
    from forwardtacotron_tpu.models.forward_tacotron import (
        ForwardTacotron as JaxFT)
    from forwardtacotron_tpu.models.torch_export import (
        export_forward_tacotron)
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.weights import forward_tacotron_state_dict
    jmodel = JaxFT(num_chars=30, n_mels=5, **FT_CFG)
    variables = jax.jit(lambda k: jmodel.init(
        {'params': k}, jnp.ones((1, 4), jnp.int32), 16, method='generate',
        x_len=jnp.asarray([4])))(jax.random.PRNGKey(1))
    variables = jax.tree.map(np.asarray, variables)
    sd = forward_tacotron_state_dict(variables, FT_CFG, step=42)
    _assert_same(sd, export_forward_tacotron(variables, FT_CFG, step=42))
    ForwardTacotron(num_chars=30, n_mels=5, **FT_CFG).load_state_dict(
        sd, strict=True)
    # a single-speaker model has no speaker parameter (the multi-speaker
    # ones: tests/test_torch_multispeaker.py)
    assert not any('speaker' in k or 'spk' in k for k in sd)


def test_wavernn_state_dict_equals_torch_export():
    from forwardtacotron_tpu.models.torch_export import export_wavernn
    from forwardtacotron_tpu.models.wavernn import WaveRNN as JaxWaveRNN
    from forwardtacotron_tpu_torch.models.wavernn import WaveRNN
    from forwardtacotron_tpu_torch.weights import wavernn_state_dict
    kw = dict(VOC_CFG, upsample_factors=tuple(VOC_CFG['upsample_factors']),
              feat_dims=6, hop_length=4)
    mel = jnp.zeros((1, 10, 6))
    variables = jax.jit(JaxWaveRNN(**kw).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 24)), mel)
    variables = jax.tree.map(np.asarray, variables)
    sd = wavernn_state_dict(variables, VOC_CFG, step=7)
    _assert_same(sd, export_wavernn(variables, VOC_CFG, step=7))
    WaveRNN(**kw).load_state_dict(sd, strict=True)


def test_load_fjax_round_trip(tmp_path):
    from forwardtacotron_tpu.utils.checkpoints import save_checkpoint
    from forwardtacotron_tpu_torch.weights import load_fjax
    params = {'a': np.arange(3, dtype=np.float32)}
    ema = {'a': np.ones(3, np.float32)}
    path = tmp_path / 'm.fjax'
    save_checkpoint({'params': params, 'ema_params': ema}, {'x': 1}, path,
                    step=5)
    got = load_fjax(path)
    assert got['step'] == 5 and got['config'] == {'x': 1}
    np.testing.assert_array_equal(got['model']['params']['a'], ema['a'])
    raw = load_fjax(path, use_ema=False)
    np.testing.assert_array_equal(raw['model']['params']['a'], params['a'])


def test_builtin_config_equals_config_yaml():
    import yaml
    from forwardtacotron_tpu_torch.config import default_config
    with open(ROOT / 'config.yaml', encoding='utf-8') as f:
        ref = yaml.safe_load(f)
    cfg = default_config()
    for key in ('tts_model', 'data_path', 'tts_model_id', 'voc_model_id'):
        assert cfg[key] == ref[key], key
    for section in ('dsp', 'preprocessing'):
        assert cfg[section] == ref[section], section
    for section in ('forward_tacotron', 'vocoder', 'tacotron', 'fast_pitch',
                    'aligner'):
        assert cfg[section]['model'] == ref[section]['model'], section
    for section in ('forward_tacotron', 'tacotron', 'vocoder', 'hifigan',
                    'fast_pitch', 'aligner'):
        assert cfg[section]['training'] == ref[section]['training'], section
    assert cfg['hifigan']['model'] == ref['hifigan']['model']
    assert cfg['tpu']['mesh'] == ref['tpu']['mesh']


def test_token_ids_equal_jax_front_end():
    from forwardtacotron_tpu.text.cleaners import Cleaner as JCleaner
    from forwardtacotron_tpu.text.tokenizer import Tokenizer as JTokenizer
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.text.cleaners import Cleaner
    from forwardtacotron_tpu_torch.text.tokenizer import Tokenizer
    cfg = default_config()
    ours, theirs = Cleaner.from_config(cfg), JCleaner.from_config(cfg)
    tok, jtok = Tokenizer(), JTokenizer()
    lines = (ROOT / 'sentences.txt').read_text(encoding='utf-8').splitlines()
    lines += ['Dr. Smith paid $3.50 on the 2nd of May, 1999!']
    for line in lines:
        ids = tok(ours(line))
        assert ids and ids == jtok(theirs(line)), line


# the JAX package, its frameworks, and the repository's JAX-side notebook
# helper and tools
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'forwardtacotron_tpu',
             'notebook_utils', 'tools')


def _imports(path):
    tree = ast.parse(path.read_text(encoding='utf-8'))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / 'forwardtacotron_tpu_torch').rglob('*.py'))
    files.append(ROOT / 'chip_smoke.py')
    assert len(files) > 10
    # the serving, data, vocoder-training and trainer-option paths'
    # modules are scanned, and FastPitch's, the teacher's synthesis,
    # evaluation and tracing, the custom ops and the export, and the data
    # parallelism, the notebook Synthesizer and the operator tools
    names = {p.relative_to(ROOT).as_posix() for p in files}
    for module in ('dsp/stft', 'dsp/griffinlim', 'dsp/audio',
                   'text/segmenter', 'models/hifigan', 'models/melgan',
                   'models/streaming', 'serving', 'serve_forward',
                   'dsp/pitch', 'dsp/vad', 'text/recipes', 'preprocess',
                   'models/tacotron', 'align/metrics', 'align/duration',
                   'align/features', 'train/taco_trainer', 'train_tacotron',
                   'utils/display', 'utils/files', 'utils/paths',
                   'ops/mol', 'models/gan_discriminators',
                   'train/gan_losses', 'train/voc_trainer',
                   'train/hifigan_trainer', 'train_wavernn',
                   'train_hifigan', 'utils/async_ckpt', 'train/common',
                   'utils/checkpoints', 'models/fast_pitch', 'gen_tacotron',
                   'evaluation', 'eval_tts', 'utils/profiling', 'weights',
                   'gen_forward', 'train_forward', 'train/forward_trainer',
                   'kernels/ops', 'utils/export', 'export_forward',
                   'parallel/__init__', 'parallel/mesh',
                   'parallel/distributed', 'notebook_utils/synthesize',
                   'tools/benchmark_serving', 'tools/average_checkpoints',
                   'tools/model_info', 'tools/export_torch',
                   'tools/f0_bound', 'tools/make_synthetic_dataset',
                   'tools/checkpoint_files'):
        assert f'forwardtacotron_tpu_torch/{module}.py' in names, module
    for path in files:
        for name in _imports(path):
            top = name.split('.')[0]
            assert top not in FORBIDDEN, f'{path}: imports {name}'


# the repository's `native/` directory (the JAX package's host library) or
# one of its `libftt_*.so`: a path through `native/` not inside the port's
# own `forwardtacotron_tpu_torch/native/`, or the bare directory name
REPO_NATIVE = re.compile(r'libftt_|(?<![\w/])native/|^native$')


def _strings(path):
    tree = ast.parse(path.read_text(encoding='utf-8'))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.value


def test_port_names_no_repo_native_library():
    """No string of the port's Python files or of chip_smoke.py, and no
    line of its C++ and CUDA sources, names the repository's `native/`
    or a `libftt_*.so`: the port builds its host library from its own
    sources (`forwardtacotron_tpu_torch/native/`)."""
    pkg = ROOT / 'forwardtacotron_tpu_torch'
    files = sorted(p for p in pkg.rglob('*.py') if 'build' not in p.parts)
    files.append(ROOT / 'chip_smoke.py')
    names = {p.relative_to(ROOT).as_posix() for p in files}
    for module in ('native/__init__', 'utils/native_audio',
                   'data/native_loader', 'data/dataset', 'dsp/audio'):
        assert f'forwardtacotron_tpu_torch/{module}.py' in names, module
    for path in files:
        for s in _strings(path):
            for line in s.splitlines() or ['']:
                assert not REPO_NATIVE.search(line.strip()), \
                    f'{path}: {line!r}'
    sources = sorted(p for ext in ('*.cc', '*.cu', '*.cuh')
                     for p in pkg.rglob(ext) if 'build' not in p.parts)
    assert {'audio_io.cc', 'batch_loader.cc'} <= {p.name for p in sources}
    for path in sources:
        for line in path.read_text(encoding='utf-8').splitlines():
            assert not REPO_NATIVE.search(line), f'{path}: {line!r}'
    # the pattern catches what it is for
    for bad in ('native', "Path(__file__).parent / 'native/x.so'",
                'see native/Makefile', 'libftt_audio.so'):
        assert REPO_NATIVE.search(bad), bad
    assert not REPO_NATIVE.search('forwardtacotron_tpu_torch/native/a.cc')


def test_cuda_request_without_cuda_raises(monkeypatch):
    from forwardtacotron_tpu_torch import resolve_device
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        resolve_device('cuda')
    assert resolve_device('cpu').type == 'cpu'
