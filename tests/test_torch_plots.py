"""The trainers' plots and audio samples (`ForwardTrainer.generate_plots`
for ForwardTacotron and FastPitch, `TacoTrainer.generate_plots`) against
the JAX package's `generate_plots`, with recording writers, the same
weights (through `weights.py`) and the same validation sample on the
CPU:

- the same tags in the same order on both sides (JAX's decorator
  swallows a failure, so a tag missing on its side fails the test too);
- teacher-forced figure data within atol 1e-4 (docs/benchmarks.md's
  teacher-forced bar), figure sizes equal;
- generated mels of equal length with a mean |port - JAX| below 1e-3,
  the generated pitch and energy within atol 1e-4;
- wavs of equal length, each bit-equal to the port's Griffin-Lim of the
  port's mel, with the same initial phase (JAX's draw put into the port's
  `initial_phase`); the target's wav (the same mel on both sides) within
  tests/test_torch_dsp.py's Griffin-Lim bound of JAX's, 1e-3 of the peak.
  Griffin-Lim's momentum of 0.99 turns float32 rounding into chaos: on the
  untrained postnet mel, the port's and JAX's 32 iterations of one and the
  same linear spectrogram end 1.6% of the peak apart (measured; 1.2e-6
  after 4 iterations). So the postnet's and the generated wavs are held
  through their mels (above), and the two Griffin-Lims are held to each
  other on JAX's mel over 4 iterations at that bound.

Also: `first_batch` equals JAX's key by key; without matplotlib the
figures are skipped with a note and the audio is still written; a
writer whose `add_figure` raises makes `generate_plots` raise; the
trainers' default writer is a tensorboardX `SummaryWriter` under JAX's log
paths, and `train_tacotron`, `train_aligner` and `train_forward` write
event files there."""
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_train_pipeline import N_MELS, TINY_MODEL, _make_dataset

TF_ATOL, GEN_L1, GL_REL = 1e-4, 1e-3, 1e-3
TACO = {'embed_dims': 16, 'encoder_dims': 128, 'decoder_dims': 256,
        'postnet_dims': 8, 'encoder_k': 2, 'lstm_dims': 32, 'postnet_k': 3,
        'num_highways': 1, 'dropout': 0.5, 'stop_threshold': -11}
FAST_PITCH = {
    'durpred_dropout': 0.0, 'durpred_d_model': 8, 'durpred_n_heads': 2,
    'durpred_layers': 1, 'durpred_d_fft': 8,
    'pitch_dropout': 0.0, 'pitch_d_model': 8, 'pitch_n_heads': 2,
    'pitch_layers': 1, 'pitch_d_fft': 8,
    'energy_dropout': 0.0, 'energy_d_model': 8, 'energy_n_heads': 2,
    'energy_layers': 1, 'energy_d_fft': 8,
    'pitch_strength': 1.0, 'energy_strength': 1.0,
    'd_model': 16, 'conv1_kernel': 9, 'conv2_kernel': 1,
    'prenet_layers': 1, 'prenet_heads': 2, 'prenet_fft': 16,
    'prenet_dropout': 0.0, 'postnet_layers': 1, 'postnet_heads': 2,
    'postnet_fft': 16, 'postnet_dropout': 0.0}
STEP = 7


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


class Recorder:
    """A writer that keeps, in order, each figure's size, image arrays and
    line data, and each wav."""

    def __init__(self):
        self.calls = []

    def add_scalar(self, tag, value, step):
        pass

    def add_figure(self, tag, fig, step):
        import matplotlib.pyplot as plt
        ax = fig.axes[0]
        self.calls.append((tag, int(step), 'figure', {
            'size': tuple(fig.get_size_inches()),
            'images': [np.asarray(im.get_array(), np.float64)
                       for im in ax.images],
            'lines': [np.asarray(line.get_ydata(), np.float64)
                      for line in ax.lines]}))
        plt.close(fig)

    def add_audio(self, tag, wav, step, sample_rate):
        self.calls.append((tag, int(step), 'audio',
                           {'wav': np.asarray(wav, np.float64),
                            'sr': int(sample_rate)}))

    def tags(self):
        return [c[0] for c in self.calls]


@pytest.fixture
def same_phase(monkeypatch):
    """The port's Griffin-Lim starts from JAX's initial phase draw."""
    from forwardtacotron_tpu_torch.dsp import griffinlim
    monkeypatch.setattr(griffinlim, 'initial_phase', lambda shape, seed:
                        torch.from_numpy(np.asarray(jax.random.uniform(
                            jax.random.PRNGKey(seed), tuple(shape)))))


def _config(data, tts_model='forward_tacotron'):
    from forwardtacotron_tpu_torch.config import default_config
    cfg = default_config()
    cfg['data_path'] = str(data)
    cfg['tts_model'] = tts_model
    cfg['forward_tacotron']['model'] = dict(TINY_MODEL)
    cfg['fast_pitch']['model'] = dict(FAST_PITCH)
    cfg['tacotron']['model'] = dict(TACO)
    return cfg


def _sets(data, r, model_type):
    """(JAX's validation batcher, the port's) of `data`."""
    from forwardtacotron_tpu.data.dataset import get_tts_datasets as jsets
    from forwardtacotron_tpu_torch.data.dataset import get_tts_datasets
    kw = dict(path=data, batch_size=4, r=r, max_mel_len=None,
              model_type=model_type, filter_attention=False)
    return jsets(**kw)[1], get_tts_datasets(**kw)[1]


# each wav's mel: the figure that shows it (plot_mel's image is the mel
# in (n_mels, T) layout)
WAV_MELS = {'Ground_Truth_Aligned/target_wav': 'Ground_Truth_Aligned/target',
            'Ground_Truth_Aligned/postnet_wav':
                'Ground_Truth_Aligned/postnet',
            'Generated/postnet_wav': 'Generated/postnet'}


def _jax_griffinlim(jdsp, mel, n_iter):
    """JAX's `DSP.griffinlim` (seed 0) at `n_iter` iterations (the DSP's
    own runs 32)."""
    from forwardtacotron_tpu.dsp.griffinlim import mel_to_wav_fn
    if mel.shape[0] == jdsp.n_mels:
        mel = mel.T
    fn = mel_to_wav_fn(jdsp.mel_basis, jdsp.n_fft, jdsp.hop_length,
                       jdsp.win_length, n_iter=n_iter)
    return np.asarray(fn(jnp.asarray(mel), jax.random.PRNGKey(0)))


def _compare(got, want, dsp, jdsp, generated=('Generated/postnet',)):
    """The two records: tags in order, then each figure and each wav (as
    the module's docstring says)."""
    assert got.tags() == want.tags()
    g_rec = {c[0]: c[3] for c in got.calls}
    w_rec = {c[0]: c[3] for c in want.calls}
    worst = {}
    for (tag, step, kind, g), (_, jstep, _, w) in zip(got.calls,
                                                      want.calls):
        assert step == jstep == STEP
        if kind == 'audio':
            assert g['sr'] == w['sr'] and g['wav'].shape == w['wav'].shape
            mel = WAV_MELS[tag]
            np.testing.assert_array_equal(
                g['wav'], dsp.griffinlim(g_rec[mel]['images'][0]), tag)
            ours, theirs = g['wav'], w['wav']
            if tag != 'Ground_Truth_Aligned/target_wav':
                jmel = w_rec[mel]['images'][0].astype(np.float32)
                ours = dsp.griffinlim(jmel, n_iter=4)
                theirs = _jax_griffinlim(jdsp, jmel, 4)
            err = float(np.abs(ours - theirs).max())
            peak = float(np.abs(theirs).max())
            assert err <= GL_REL * peak, (tag, err, peak)
            worst[tag] = err / peak
            continue
        assert g['size'] == w['size'], tag
        assert len(g['images']) == len(w['images']) \
            and len(g['lines']) == len(w['lines']), tag
        for x, y in zip(g['images'] + g['lines'], w['images'] + w['lines']):
            assert x.shape == y.shape, tag
            if tag in generated:
                err = float(np.abs(x - y).mean())
                assert err < GEN_L1, (tag, err)
            else:
                err = float(np.abs(x - y).max())
                assert err <= TF_ATOL, (tag, err)
            worst[tag] = err
    print({k: f'{v:.3g}' for k, v in worst.items()})


def _jax_paths(base, data):
    from forwardtacotron_tpu.utils.paths import Paths as JPaths
    return JPaths(str(data), 'voc', 'tts', base=base)


def _port_trainer(kind, cfg, base, writer):
    from forwardtacotron_tpu_torch.dsp.audio import DSP
    from forwardtacotron_tpu_torch.train.forward_trainer import (
        ForwardTrainer)
    from forwardtacotron_tpu_torch.train.taco_trainer import TacoTrainer
    from forwardtacotron_tpu_torch.utils.paths import Paths
    paths = Paths(cfg['data_path'], 'tts', base=base)
    cls = TacoTrainer if kind == 'tacotron' else ForwardTrainer
    return cls(paths, cfg, device='cpu', writer=writer,
               dsp=DSP.from_config(cfg, device='cpu'))


def _student(kind, tmp_path):
    """(JAX trainer and model and variables, the port's trainer and model,
    the JAX and the port's validation sample) of the tiny student."""
    from forwardtacotron_tpu.dsp.audio import DSP as JDSP
    from forwardtacotron_tpu.models.fast_pitch import FastPitch as JFP
    from forwardtacotron_tpu.models.forward_tacotron import (
        ForwardTacotron as JFT)
    from forwardtacotron_tpu.train.forward_trainer import (
        ForwardTrainer as JTrainer)
    from forwardtacotron_tpu_torch.models.fast_pitch import FastPitch
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.text.symbols import phonemes
    from forwardtacotron_tpu_torch.weights import tts_state_dict
    data = tmp_path / 'data'
    _make_dataset(data)
    cfg = _config(data, kind)
    jval, val = _sets(data, 1, 'forward')
    jsample, sample = jval.first_batch(), val.first_batch()
    if kind == 'fast_pitch':
        jmodel = JFP.from_config(cfg)
        model = FastPitch.from_config(cfg)
    else:
        jmodel = JFT(num_chars=len(phonemes), n_mels=N_MELS, **TINY_MODEL)
        model = ForwardTacotron.from_config(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in jsample.items()
              if isinstance(v, np.ndarray)}
    variables = jax.tree.map(np.asarray, jax.jit(lambda k: jmodel.init(
        {'params': k}, jbatch, train=False))(jax.random.PRNGKey(0)))
    model.load_state_dict(tts_state_dict(variables, cfg))
    jtrainer = JTrainer(_jax_paths(tmp_path / 'jax', data), JDSP.from_config(
        cfg), cfg, writer=Recorder())
    return jtrainer, jmodel, variables, model, jsample, sample, cfg


def _jax_state(variables):
    return types.SimpleNamespace(eval_variables=variables,
                                 variables=variables,
                                 step=jnp.asarray(STEP))


def _port_plots(trainer, model, sample, r=1):
    trainer.generate_plots(model, types.SimpleNamespace(val_sample=sample,
                                                        r=r), STEP)


@pytest.mark.parametrize('kind', ('forward_tacotron', 'fast_pitch'))
def test_student_plots_match_jax(kind, tmp_path, same_phase):
    jtrainer, jmodel, variables, model, jsample, sample, cfg = \
        _student(kind, tmp_path)
    jtrainer.generate_plots(jmodel, _jax_state(variables),
                            types.SimpleNamespace(val_sample=jsample))
    port = _port_trainer(kind, cfg, tmp_path / 'port', Recorder())
    _port_plots(port, model, sample)
    want = jtrainer.writer
    assert want.tags() == [
        'Ground_Truth_Aligned/target', 'Ground_Truth_Aligned/linear',
        'Ground_Truth_Aligned/postnet', 'Pitch/target',
        'Pitch/ground_truth_aligned', 'Energy/target',
        'Energy/ground_truth_aligned', 'Ground_Truth_Aligned/target_wav',
        'Ground_Truth_Aligned/postnet_wav', 'Generated/postnet',
        'Pitch/generated', 'Energy/generated', 'Generated/postnet_wav']
    _compare(port.writer, want, port.dsp, jtrainer.dsp)


def test_ema_weights_make_the_plots(tmp_path, same_phase):
    """With `ema_decay`, the plots use the EMA weights (JAX's
    `eval_variables`) and leave the live weights as they were."""
    from forwardtacotron_tpu_torch.train import common as tc
    jtrainer, jmodel, variables, model, jsample, sample, cfg = \
        _student('forward_tacotron', tmp_path)
    live = {k: v.clone() for k, v in model.state_dict().items()}
    port = _port_trainer('forward_tacotron', cfg, tmp_path / 'port',
                         Recorder())
    port.ema = tc.EMA(model, 0.9)
    for p in model.parameters():
        p.data.mul_(0.5)
    jtrainer.generate_plots(jmodel, _jax_state(variables),
                            types.SimpleNamespace(val_sample=jsample))
    _port_plots(port, model, sample)
    _compare(port.writer, jtrainer.writer, port.dsp, jtrainer.dsp)
    for k, v in model.state_dict().items():
        if v.is_floating_point() and 'running' not in k:
            assert torch.equal(v, live[k] * 0.5), k


def test_teacher_plots_match_jax(tmp_path, same_phase):
    from forwardtacotron_tpu.dsp.audio import DSP as JDSP
    from forwardtacotron_tpu.models.tacotron import Tacotron as JTaco
    from forwardtacotron_tpu.train.taco_trainer import (
        TacoTrainer as JTrainer)
    from forwardtacotron_tpu_torch.models.tacotron import Tacotron
    from forwardtacotron_tpu_torch.text.symbols import phonemes
    from forwardtacotron_tpu_torch.weights import tacotron_state_dict
    data = tmp_path / 'data'
    _make_dataset(data)
    cfg = _config(data)
    r = 2
    jval, val = _sets(data, r, 'tacotron')
    jsample, sample = jval.first_batch(), val.first_batch()
    jmodel = JTaco(num_chars=len(phonemes), n_mels=N_MELS, **TACO)
    variables = jax.tree.map(np.asarray, jax.jit(lambda k: jmodel.init(
        {'params': k}, jnp.asarray(jsample['x']), jnp.asarray(jsample['mel']),
        r, train=False))(jax.random.PRNGKey(0)))
    model = Tacotron.from_config(cfg)
    model.load_state_dict(tacotron_state_dict(variables, TACO, r=r))
    jtrainer = JTrainer(_jax_paths(tmp_path / 'jax', data),
                        JDSP.from_config(cfg), cfg, writer=Recorder())
    jtrainer.generate_plots(jmodel, _jax_state(variables),
                            types.SimpleNamespace(val_sample=jsample, r=r))
    port = _port_trainer('tacotron', cfg, tmp_path / 'port', Recorder())
    _port_plots(port, model, sample, r)
    assert jtrainer.writer.tags() == [
        'Ground_Truth_Aligned/attention', 'Ground_Truth_Aligned/target',
        'Ground_Truth_Aligned/linear', 'Ground_Truth_Aligned/postnet',
        'Ground_Truth_Aligned/target_wav',
        'Ground_Truth_Aligned/postnet_wav', 'Generated/attention',
        'Generated/linear', 'Generated/postnet', 'Generated/postnet_wav']
    _compare(port.writer, jtrainer.writer, port.dsp, jtrainer.dsp,
             ('Generated/attention', 'Generated/linear', 'Generated/postnet'))


@pytest.mark.parametrize('model_type,r', (('forward', 1), ('tacotron', 2)))
def test_first_batch_matches_jax(tmp_path, model_type, r):
    data = tmp_path / 'data'
    _make_dataset(data, n_items=14, n_val=6)
    jval, val = _sets(data, r, model_type)
    want, got = jval.first_batch(), val.first_batch()
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


def _port_student(tmp_path):
    """(the port's tiny student with seeded weights, its validation
    sample, the config)."""
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    data = tmp_path / 'data'
    _make_dataset(data)
    cfg = _config(data)
    torch.manual_seed(0)
    return ForwardTacotron.from_config(cfg), \
        _sets(data, 1, 'forward')[1].first_batch(), cfg


def test_without_matplotlib_audio_is_still_written(tmp_path, monkeypatch,
                                                   capsys):
    """matplotlib unimportable: no figure, one note for every call, and
    every wav through the writer (`log_audio`)."""
    model, sample, cfg = _port_student(tmp_path)
    port = _port_trainer('forward_tacotron', cfg, tmp_path / 'port',
                         Recorder())
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    monkeypatch.setitem(sys.modules, 'matplotlib.pyplot', None)
    _port_plots(port, model, sample)
    _port_plots(port, model, sample)
    assert port.writer.tags() == 2 * [
        'Ground_Truth_Aligned/target_wav', 'Ground_Truth_Aligned/postnet_wav',
        'Generated/postnet_wav']
    assert capsys.readouterr().out.count('matplotlib is not installed') == 1


def test_a_failing_writer_makes_generate_plots_raise(tmp_path):
    model, sample, cfg = _port_student(tmp_path)

    class Broken(Recorder):
        def add_figure(self, tag, fig, step):
            raise ValueError('no figures here')
    port = _port_trainer('forward_tacotron', cfg, tmp_path / 'port',
                         Broken())
    with pytest.raises(ValueError, match='no figures here'):
        _port_plots(port, model, sample)


def test_default_writer_is_tensorboardx_under_jax_log_paths(tmp_path):
    """Where no writer is given, the main rank's writer is a tensorboardX
    `SummaryWriter` under the log path of JAX's `Paths` (made at first
    use); a writer given is kept, and `None` is kept lazily."""
    from tensorboardX import SummaryWriter
    from forwardtacotron_tpu_torch.dsp.audio import DSP
    from forwardtacotron_tpu_torch.train.aligner_trainer import (
        AlignerTrainer)
    from forwardtacotron_tpu_torch.train.hifigan_trainer import (
        HiFiGANTrainer)
    from forwardtacotron_tpu_torch.train.voc_trainer import VocTrainer
    from forwardtacotron_tpu_torch.utils.paths import Paths
    data = tmp_path / 'data'
    cfg = _config(data)
    jpaths = _jax_paths(tmp_path, data)
    paths = Paths(str(data), 'tts', base=tmp_path, voc_id='voc')
    dsp = DSP.from_config(cfg, device='cpu')
    trainers = {
        'forward_log': _port_trainer('forward_tacotron', cfg, tmp_path,
                                     None),
        'taco_log': _port_trainer('tacotron', cfg, tmp_path, None),
        'voc_log': VocTrainer(paths, dsp, cfg, device='cpu'),
        'hifigan_log': HiFiGANTrainer(paths, dsp, cfg, device='cpu'),
        'aligner_log': AlignerTrainer(paths, cfg, device='cpu')}
    for attr, trainer in trainers.items():
        assert trainer._writer is None
        writer = trainer.writer
        assert isinstance(writer, SummaryWriter)
        assert writer.logdir == str(getattr(jpaths, attr)), attr
        assert trainer.writer is writer
        writer.close()
    given = Recorder()
    assert _port_trainer('tacotron', cfg, tmp_path, given).writer is given


def test_clis_write_event_files_under_jax_log_paths(tmp_path, monkeypatch):
    """`train_tacotron`, `train_aligner` and `train_forward`, given no
    writer, write TensorBoard event files under the log directories of
    JAX's `Paths`, and the teacher's and the student's plots write their
    audio samples beside them (`plot_every` 2)."""
    import yaml
    from forwardtacotron_tpu_torch import (preprocess, train_aligner,
                                           train_forward, train_tacotron)
    from test_torch_train_tacotron import _config as taco_config
    from test_torch_train_tacotron import _write_corpus
    monkeypatch.setenv('FTT_BASE', str(tmp_path))
    _write_corpus(tmp_path / 'corpus')
    cfg, path = taco_config(tmp_path)
    cfg['tacotron']['training']['plot_every'] = 2
    cfg['forward_tacotron']['training'].update(schedule=['1e-3, 2, 2'],
                                               plot_every=2)
    cfg['aligner'] = {
        'model': {'embed_dims': 16, 'conv_dims': 16, 'key_dims': 8,
                  'n_text_convs': 1, 'n_mel_convs': 1, 'dropout': 0.1,
                  'prior_width': 10.0},
        'training': {'schedule': ['1e-3, 2, 2'], 'max_mel_len': 1250,
                     'clip_grad_norm': 1.0, 'checkpoint_every': 2}}
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    cli = ['--config', path, '--device', 'cpu']
    preprocess.main(['--path', str(tmp_path / 'corpus')] + cli)
    train_tacotron.main(cli)
    assert train_aligner.main(cli) == 2
    assert train_forward.main(cli) == 2
    jpaths = _jax_paths(tmp_path, cfg['data_path'])
    jpaths = type(jpaths)(cfg['data_path'], cfg['voc_model_id'],
                          cfg['tts_model_id'], base=tmp_path)
    for log in ('taco_log', 'aligner_log', 'forward_log'):
        assert list(getattr(jpaths, log).glob('events.out.tfevents.*')), log
    for log in ('taco_log', 'forward_log'):
        wavs = sorted(p.name for p in (getattr(jpaths, log) / 'audio')
                      .glob('*_step2.wav'))
        assert wavs == ['Generated_postnet_wav_step2.wav',
                        'Ground_Truth_Aligned_postnet_wav_step2.wav',
                        'Ground_Truth_Aligned_target_wav_step2.wav'], log
