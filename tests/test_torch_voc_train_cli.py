"""The port's vocoder-training entry points on the CPU at a tiny width
against the JAX package: the student's top-k checkpoints, the student's
GTA mels, `train_forward --force_gta` and `train_wavernn --gta` end to
end with checkpoints resumed and served, a port-written WaveRNN `.pt`
vocoding in the JAX package, and the CLIs refusing to fall back to the
CPU.

Tolerances: GTA mels atol 1e-4 (the teacher-forced bar of
docs/benchmarks.md); greedy trajectories 1e-6 (RAW) / 1e-5 (MOL) as
tests/test_torch_vocode.py.
"""
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

# _one_thread is test_torch_voc_train's autouse fixture, applied here too
from test_torch_voc_train import (  # noqa: F401
    HOP, N_MELS, SEQ_LEN, TINY, _inputs, _make_voc_dataset, _one_thread)


TINY_FT = {
    'embed_dims': 16, 'series_embed_dims': 8,
    'durpred_conv_dims': 8, 'durpred_rnn_dims': 4, 'durpred_dropout': 0.0,
    'pitch_conv_dims': 8, 'pitch_rnn_dims': 4, 'pitch_dropout': 0.0,
    'pitch_strength': 1.0,
    'energy_conv_dims': 8, 'energy_rnn_dims': 4, 'energy_dropout': 0.0,
    'energy_strength': 1.0,
    'rnn_dims': 12, 'prenet_dims': 8, 'prenet_k': 2, 'prenet_dropout': 0.0,
    'prenet_num_highways': 1, 'postnet_dims': 8, 'postnet_k': 2,
    'postnet_num_highways': 1, 'postnet_dropout': 0.0,
}


def _config(data, mode='RAW'):
    from forwardtacotron_tpu_torch.config import default_config
    cfg = default_config()
    cfg['data_path'] = str(data)
    cfg['dsp'].update(n_fft=256, win_length=256, hop_length=HOP,
                      num_mels=N_MELS, sample_rate=TINY['sample_rate'],
                      fmax=4000, voc_mode=mode)
    cfg['forward_tacotron']['model'] = dict(TINY_FT)
    ft = cfg['forward_tacotron']['training']
    ft.update(schedule=['1e-3, 2, 3'], checkpoint_every=1000,
              keep_top_k=2)
    voc = {k: TINY[k] for k in ('rnn_dims', 'fc_dims', 'pad',
                                'compute_dims', 'res_out_dims',
                                'res_blocks')}
    cfg['vocoder']['model'].update(voc, mode=mode,
                                   upsample_factors=[4, 4, 4])
    cfg['vocoder']['training'].update(
        schedule=['1e-3, 4, 2'], checkpoint_every=2, gen_samples_every=2,
        num_gen_samples=1, keep_top_k=2, seq_len=SEQ_LEN, target=600,
        overlap=50)
    return cfg


class _Scalars:
    def __init__(self):
        self.values = []

    def add_scalar(self, tag, value, step):
        self.values.append((tag, float(value), int(step)))


def test_student_top_k_matches_jax_tracker(tmp_path):
    """The student keeps its `keep_top_k` best checkpoints by validation
    mel loss as the JAX trainer does: the JAX tracker offered the same
    (loss, step) pairs keeps the same index and files."""
    from forwardtacotron_tpu.train.common import TopKTracker as JTopK
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.train.forward_trainer import (
        ForwardTrainer)
    from forwardtacotron_tpu_torch.utils.checkpoints import load_checkpoint
    from forwardtacotron_tpu_torch.utils.files import unpickle_binary
    from forwardtacotron_tpu_torch.utils.paths import Paths
    cfg = _config(_make_voc_dataset(tmp_path / 'data'))
    paths = Paths(cfg['data_path'], 'tts', base=tmp_path)
    writer = _Scalars()
    torch.manual_seed(0)
    model = ForwardTacotron.from_config(cfg)
    cfg['forward_tacotron']['training']['schedule'] = ['1e-3, 7, 3']
    assert ForwardTrainer(paths, cfg, 'cpu', writer=writer).train(model) == 7
    offers = [(v, s) for t, v, s in writer.values if t == 'Mel_Loss/val']
    assert len(offers) == 3
    jax_dir = tmp_path / 'jax_top_k'
    jax_dir.mkdir()
    jtrack = JTopK(jax_dir, 2, 'forward')
    for score, step in offers:
        jtrack.update(score, {'params': {}}, {}, None, step)
    ours = unpickle_binary(paths.forward_top_k / 'top_k.pkl')
    theirs = unpickle_binary(jax_dir / 'top_k.pkl')
    assert [(s, st, n[:-3]) for s, st, n in ours] == \
        [(s, st, n[:-5]) for s, st, n in theirs]
    assert sorted(p.name for p in paths.forward_top_k.glob('*.pt')) == \
        sorted(n for _, _, n in ours)
    best = load_checkpoint(paths.forward_top_k / ours[0][2])
    assert best['step'] == ours[0][1] and best['optim'] is not None


def test_gta_features_match_jax(tmp_path):
    """The port's `create_gta_features` against the JAX package's (the
    root `train_forward.py`), same weights and dataset: every item's file,
    (n_mels, mel_len), within 1e-4."""
    import train_forward as jtf
    from forwardtacotron_tpu.data.dataset import get_tts_datasets as jget
    from forwardtacotron_tpu.models.forward_tacotron import (
        ForwardTacotron as JaxFT)
    from forwardtacotron_tpu_torch import train_forward
    from forwardtacotron_tpu_torch.data.dataset import get_tts_datasets
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.weights import forward_tacotron_state_dict
    data = _make_voc_dataset(tmp_path / 'data', n_items=6)
    jmodel = JaxFT(num_chars=len(_symbols()), n_mels=N_MELS, **TINY_FT)
    kw = dict(r=1, model_type='forward', filter_attention=False,
              max_mel_len=None)
    jtrain, jval = jget(data, 4, **kw)
    example = {k: jnp.asarray(v) for k, v in next(iter(jtrain)).items()
               if isinstance(v, np.ndarray)}
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda k: jmodel.init({'params': k}, example, train=False))(
            jax.random.PRNGKey(3)))
    (tmp_path / 'jax').mkdir()
    (tmp_path / 'ours').mkdir()
    jtf.create_gta_features(jmodel, types.SimpleNamespace(
        variables=variables), jtrain, jval, tmp_path / 'jax')
    tmodel = ForwardTacotron(num_chars=len(_symbols()), n_mels=N_MELS,
                             **TINY_FT)
    tmodel.load_state_dict(forward_tacotron_state_dict(variables, TINY_FT))
    train, val = get_tts_datasets(data, 4, **kw)
    n = train_forward.create_gta_features(tmodel, train, val,
                                          tmp_path / 'ours')
    assert n == 6
    for item_id, frames in [(str(i), np.load(data / 'mel' / f'{i}.npy')
                             .shape[1]) for i in range(6)]:
        got = np.load(tmp_path / 'ours' / f'{item_id}.npy')
        want = np.load(tmp_path / 'jax' / f'{item_id}.npy')
        assert got.shape == want.shape == (N_MELS, frames)
        np.testing.assert_allclose(got, want, atol=1e-4, err_msg=item_id)


def _symbols():
    from forwardtacotron_tpu_torch.text.symbols import phonemes
    return phonemes


def _write_config(cfg, path):
    import yaml
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_force_gta_and_train_wavernn_end_to_end(tmp_path, monkeypatch):
    """wavs' labels and mels -> the student (2 steps) -> `train_forward
    --force_gta` -> `train_wavernn --gta` for 4 steps (checkpoints, top-k
    by the samples' mel L1, audio samples) -> resumed to 6 steps, equal to
    an uninterrupted run -> `gen_forward wavernn --voc_checkpoint`."""
    from forwardtacotron_tpu_torch import (gen_forward, train_forward,
                                           train_wavernn)
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.train.forward_trainer import (
        ForwardTrainer)
    from forwardtacotron_tpu_torch.utils.checkpoints import load_checkpoint
    from forwardtacotron_tpu_torch.utils.files import unpickle_binary
    from forwardtacotron_tpu_torch.utils.paths import Paths
    monkeypatch.setenv('FTT_BASE', str(tmp_path))
    monkeypatch.chdir(tmp_path)
    cfg = _config(_make_voc_dataset(tmp_path / 'data'))
    paths = Paths(cfg['data_path'], cfg['tts_model_id'],
                  voc_id=cfg['voc_model_id'])
    torch.manual_seed(0)
    assert ForwardTrainer(paths, cfg, 'cpu').train(
        ForwardTacotron.from_config(cfg)) == 2
    config_file = _write_config(cfg, tmp_path / 'config.yaml')
    assert train_forward.main(['--force_gta', '--config', config_file,
                               '--device', 'cpu']) == 2
    for i in range(8):
        gta = np.load(paths.gta / f'{i}.npy')
        assert gta.shape == np.load(paths.mel / f'{i}.npy').shape
        assert np.isfinite(gta).all()

    writer = _Scalars()
    assert train_wavernn.main(['--gta', '--config', config_file,
                               '--device', 'cpu'], writer=writer) == 4
    ckpt = paths.voc_checkpoints
    assert {'latest_model.pt', 'wave_step0k.pt'} <= {
        p.name for p in ckpt.iterdir()}
    gen_l1 = [(v, s) for t, v, s in writer.values
              if t == 'Loss/generated_mel_l1']
    assert [s for _, s in gen_l1] == [2, 4]
    assert all(np.isfinite(v) for v, _ in gen_l1)
    index = unpickle_binary(paths.voc_top_k / 'top_k.pkl')
    assert sorted(e[1] for e in index) == [2, 4]
    assert sorted(p.name for p in paths.voc_top_k.glob('*.pt')) == \
        sorted(e[2] for e in index)
    assert len(list((paths.voc_log / 'audio').glob('*.wav'))) == 2
    losses = [v for t, v, _ in writer.values if t == 'Loss/train']
    assert len(losses) == 4 and all(np.isfinite(losses))

    # resumed to 6 steps, against one run of 6 steps from scratch
    cfg['vocoder']['training']['schedule'] = ['1e-3, 6, 2']
    config_file = _write_config(cfg, tmp_path / 'config6.yaml')
    assert train_wavernn.main(['--gta', '--config', config_file,
                               '--device', 'cpu']) == 6
    resumed = load_checkpoint(ckpt / 'latest_model.pt')
    assert resumed['step'] == 6
    for p in ckpt.glob('*.pt'):
        p.unlink()
    (paths.voc_top_k / 'top_k.pkl').unlink()
    assert train_wavernn.main(['--gta', '--config', config_file,
                               '--device', 'cpu']) == 6
    full = load_checkpoint(ckpt / 'latest_model.pt')
    for k, v in full['model'].items():
        np.testing.assert_allclose(resumed['model'][k].numpy(), v.numpy(),
                                   atol=1e-6, err_msg=k)

    tts = paths.forward_checkpoints / 'latest_model.pt'
    (tmp_path / 'sentences.txt').write_text('Hello.\n')
    gen_forward.main(['--checkpoint', str(tts), '--device', 'cpu',
                      'wavernn', '--voc_checkpoint',
                      str(ckpt / 'latest_model.pt'), '--target', '600',
                      '--overlap', '50'])
    wavs = list((tmp_path / 'model_outputs').glob('*wavernn*.wav'))
    assert wavs


@pytest.mark.parametrize('mode', ['RAW', 'MOL'])
def test_port_written_wavernn_vocodes_in_jax(tmp_path, monkeypatch, mode):
    """A `.pt` written by the port's trainer, through the JAX package's
    `convert_wavernn`, vocodes greedily as the port does (the JAX scan
    sampler patched to greedy float32, as tests/test_torch_vocode.py
    does)."""
    from forwardtacotron_tpu.models import streaming as js
    from forwardtacotron_tpu.models import wavernn as jw
    from forwardtacotron_tpu.models.torch_compat import convert_wavernn
    from forwardtacotron_tpu.models.wavernn import WaveRNN as JaxWaveRNN
    from forwardtacotron_tpu.models.wavernn import generate_wav as jgen
    from forwardtacotron_tpu_torch.models.wavernn import (WaveRNN,
                                                          generate_wav)
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.voc_trainer import voc_train_step
    from forwardtacotron_tpu_torch.utils.checkpoints import (load_checkpoint,
                                                             save_checkpoint)
    torch.manual_seed(1)
    model = WaveRNN(mode=mode, **TINY)
    x, mel, y = _inputs(mode, 5, batch=2)
    voc_train_step(model, tc.make_optimizer(model), {
        'x': torch.from_numpy(x), 'mel': torch.from_numpy(mel),
        'y': torch.from_numpy(y)}, mode, 4.0)
    model_cfg = dict(TINY, mode=mode)
    save_checkpoint(model, None, {'vocoder': {'model': model_cfg}},
                    tmp_path / 'voc.pt', step=1)
    payload = load_checkpoint(tmp_path / 'voc.pt')
    variables, step = convert_wavernn(
        {k: v.numpy() for k, v in payload['model'].items()}, model_cfg)
    assert step == 1
    test_mel = np.random.RandomState(6).randn(N_MELS, 12).astype(
        np.float32) - 2
    orig = jw.WaveRNN.sample_scan

    def greedy_f32(self, mels_up, aux, key, greedy=False,
                   weights_dtype=None):
        return orig(self, mels_up, aux, key, greedy=True,
                    weights_dtype=jnp.float32)
    monkeypatch.setattr(jw.WaveRNN, 'sample_scan', greedy_f32)
    monkeypatch.setattr(jw, '_GEN_JIT_CACHE', {})
    monkeypatch.setattr(js, '_STREAM_JIT_CACHE', {})
    want = jgen(JaxWaveRNN(mode=mode, **TINY), variables, test_mel,
                batched=True, target=300, overlap=30, use_pallas=False,
                fused=False)
    model.eval()
    got = generate_wav(model, test_mel, batched=True, target=300,
                       overlap=30, greedy=True,
                       compute_dtype=torch.float32)
    np.testing.assert_allclose(got, np.asarray(want),
                               atol=1e-6 if mode == 'RAW' else 1e-5)


@pytest.mark.parametrize('cli,argv', [('train_wavernn', ['--gta']),
                                      ('train_hifigan', []),
                                      ('train_forward', ['--force_gta'])])
def test_vocoder_training_clis_refuse_to_fall_back(monkeypatch, tmp_path,
                                                   cli, argv):
    """Without a card the entry points raise on their default `--device
    cuda` before touching any file, instead of running on the CPU."""
    import importlib
    module = importlib.import_module(f'forwardtacotron_tpu_torch.{cli}')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match='CUDA'):
        module.main(argv)
    assert not any(tmp_path.iterdir())
