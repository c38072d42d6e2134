"""The port's ops, `vocode_program` and text -> mel / wav artifact on the
CPU, against the JAX package.

- The ops `ftt::birnn_recurrence` and `ftt::wavernn_sample` on CPU tensors
  equal the plain versions, the recurrence through them matches JAX's
  scan at atol 1e-5, and `torch.library.opcheck` passes.
- `vocode_program` greedy in float32 against JAX's `build_vocode_program`
  (the reference fold, no Pallas, greedy, int16): the same classes (the
  float waves within 1e-5), PCM within 1 LSB, equal lengths.
- An artifact of the port (`utils/export.py`, exported on the CPU) against
  JAX's `ExportedTTS` of the same `.fjax` weights, for ForwardTacotron,
  FastPitch and a 4-speaker ForwardTacotron: the mel's mean absolute
  difference below 1e-3 with an exact `mel_len`, `dur` at atol 1e-4; the
  knobs change `mel_len` within one artifact; bucket overflow and a
  speaker out of range raise JAX's messages.
- With a vocoder: HiFi-GAN's `synthesize` and `synthesize_long` within 2
  LSB of JAX's; WaveRNN's same seed same PCM, another seed other PCM, and
  JAX's `wav_len`; a JAX `.ftexp` and an artifact exported for CUDA on a
  machine without one are refused; the artifact loads and synthesizes in
  a process that imports neither JAX nor the port's model classes; the
  `export_forward` CLI writes what the loader reads.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

ROOT = Path(__file__).resolve().parent.parent
F32 = torch.float32
DSP = {'sample_rate': 22050, 'n_fft': 256, 'num_mels': 80,
       'hop_length': 64, 'win_length': 256, 'fmin': 0, 'fmax': 8000,
       'peak_norm': False, 'trim_start_end_silence': False,
       'trim_silence_top_db': 60, 'pitch_max_freq': 600,
       'trim_long_silences': False, 'vad_window_length': 30,
       'vad_moving_average_width': 8, 'vad_max_silence_length': 12,
       'vad_sample_rate': 16000, 'voc_mode': 'RAW', 'bits': 9,
       'mu_law': True}
FT_TINY = {
    'embed_dims': 16, 'series_embed_dims': 8,
    'durpred_conv_dims': 8, 'durpred_rnn_dims': 4, 'durpred_dropout': 0.5,
    'pitch_conv_dims': 8, 'pitch_rnn_dims': 6, 'pitch_dropout': 0.5,
    'pitch_strength': 1.0,
    'energy_conv_dims': 8, 'energy_rnn_dims': 3, 'energy_dropout': 0.5,
    'energy_strength': 1.0,
    'rnn_dims': 8, 'prenet_dims': 8, 'prenet_k': 2, 'prenet_dropout': 0.5,
    'prenet_num_highways': 1, 'postnet_dims': 8, 'postnet_k': 2,
    'postnet_num_highways': 1, 'postnet_dropout': 0.0,
}
FP_TINY = {
    'durpred_dropout': 0.5, 'durpred_d_model': 8, 'durpred_n_heads': 2,
    'durpred_layers': 1, 'durpred_d_fft': 8,
    'pitch_dropout': 0.5, 'pitch_d_model': 8, 'pitch_n_heads': 2,
    'pitch_layers': 1, 'pitch_d_fft': 8,
    'energy_dropout': 0.5, 'energy_d_model': 8, 'energy_n_heads': 2,
    'energy_layers': 1, 'energy_d_fft': 8,
    'pitch_strength': 1.0, 'energy_strength': 1.0,
    'd_model': 16, 'conv1_kernel': 9, 'conv2_kernel': 1,
    'prenet_layers': 1, 'prenet_heads': 2, 'prenet_fft': 16,
    'prenet_dropout': 0.1, 'postnet_layers': 1, 'postnet_heads': 2,
    'postnet_fft': 16, 'postnet_dropout': 0.1,
}
VOC_TINY = dict(rnn_dims=16, fc_dims=16, pad=2, upsample_factors=[4, 4, 4],
                compute_dims=8, res_out_dims=8, res_blocks=1, mode='RAW')
HIFI_CFG = {'resblock': '2', 'upsample_rates': [8, 4, 2],
            'upsample_kernel_sizes': [16, 8, 4],
            'upsample_initial_channel': 16, 'resblock_kernel_sizes': [3],
            'resblock_dilation_sizes': [[1, 3]]}
BUCKET = (16, 128)
IDS = [5, 9, 12, 3, 7, 22, 14, 30]


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """Small ops in loops: one intra-op thread runs them faster under the
    suite's workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(kind, **model):
    section = 'fast_pitch' if kind == 'fast_pitch' else 'forward_tacotron'
    base = FP_TINY if kind == 'fast_pitch' else FT_TINY
    return {'tts_model': section, section: {'model': dict(base, **model)},
            'vocoder': {'model': dict(VOC_TINY)}, 'dsp': dict(DSP),
            'preprocessing': {'language': 'en-us', 'cleaner_name':
                              'english_cleaners', 'use_phonemes': True}}


@functools.lru_cache(maxsize=None)
def _tts_fjax(kind, n_speakers=1):
    """A `.fjax` written by the JAX package: ForwardTacotron or FastPitch
    with the duration head's bias raised by 3 (so that the random
    durations stay clear of the all-durations-2 floor and alpha moves
    them)."""
    import tempfile
    from forwardtacotron_tpu.models.fast_pitch import FastPitch
    from forwardtacotron_tpu.models.forward_tacotron import ForwardTacotron
    from forwardtacotron_tpu.utils.checkpoints import save_checkpoint
    extra = {} if n_speakers == 1 else {'n_speakers': n_speakers,
                                        'speaker_embed_dims': 5}
    config = _config(kind, **extra)
    build = FastPitch if kind == 'fast_pitch' else ForwardTacotron
    model = build.from_config(config)
    variables = jax.jit(lambda k: model.init(
        {'params': k}, jnp.ones((1, 16), jnp.int32), 64, method='generate',
        x_len=jnp.asarray([12])))(jax.random.PRNGKey(0))
    variables = jax.tree.map(np.asarray, variables)
    lin = variables['params']['dur_pred']['lin']
    lin['bias'] = lin['bias'] + 3.0
    path = Path(tempfile.mkdtemp(prefix='ftt_export_')) / 'tts.fjax'
    save_checkpoint(variables, config, path, step=1000)
    return str(path)


@functools.lru_cache(maxsize=None)
def _artifacts(kind, n_speakers=1, vocoder=None):
    """(port artifact path, JAX artifact path) of the same weights, one
    bucket BUCKET; `vocoder` None, 'hifigan' or 'wavernn'."""
    from forwardtacotron_tpu.utils.checkpoints import load_tts_checkpoint
    from forwardtacotron_tpu.utils.export import (
        save_exported_tts as jax_save)
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.gen_forward import load_tts
    from forwardtacotron_tpu_torch.utils.export import save_exported_tts
    fjax = _tts_fjax(kind, n_speakers)
    jmodel, jvars, _, _ = load_tts_checkpoint(fjax)
    model, _, _ = load_tts(fjax, default_config(), 'cpu')
    voc = jvoc = None
    if vocoder == 'hifigan':
        from forwardtacotron_tpu.models.hifigan import (
            load_gan_vocoder as jax_gan)
        from forwardtacotron_tpu_torch.models.hifigan import (
            load_gan_vocoder)
        path = _hifigan_file()
        voc, jvoc = load_gan_vocoder(path, device='cpu'), jax_gan(path)
    elif vocoder == 'wavernn':
        from forwardtacotron_tpu.utils.checkpoints import (
            load_voc_checkpoint)
        from forwardtacotron_tpu_torch.gen_forward import load_voc
        path = _wavernn_fjax()
        voc = load_voc(path, default_config(), 'cpu')[0]
        jvoc = load_voc_checkpoint(path)[:2]
    out = Path(fjax).parent / f'{vocoder}'
    out.mkdir(exist_ok=True)
    ours, theirs = out / 'tts.ftpt', out / 'tts.ftexp'
    save_exported_tts(model, ours, buckets=[BUCKET], vocoder=voc)
    jax_save(jmodel, jvars, theirs, buckets=[BUCKET], vocoder=jvoc)
    return str(ours), str(theirs)


@functools.lru_cache(maxsize=None)
def _hifigan_file():
    """A tiny HiFi-GAN in the official file layout (hop 64)."""
    import tempfile
    from forwardtacotron_tpu_torch.models.hifigan import (
        HiFiGANGenerator, weight_norm_state_dict)
    d = Path(tempfile.mkdtemp(prefix='ftt_export_voc_'))
    torch.manual_seed(7)
    gen = HiFiGANGenerator.from_config(HIFI_CFG, n_mels=80)
    torch.save({'generator': weight_norm_state_dict(gen)}, d / 'g_00000001')
    (d / 'config.json').write_text(json.dumps(HIFI_CFG))
    return str(d / 'g_00000001')


@functools.lru_cache(maxsize=None)
def _wavernn_fjax():
    """A tiny RAW WaveRNN `.fjax` written by the JAX package (hop 64)."""
    import tempfile
    from forwardtacotron_tpu.models.wavernn import WaveRNN
    from forwardtacotron_tpu.utils.checkpoints import save_checkpoint
    config = _config('forward_tacotron')
    model = WaveRNN.from_config(config)
    variables = jax.jit(model.init)(jax.random.PRNGKey(3),
                                    jnp.zeros((1, 128)),
                                    jnp.zeros((1, 6, 80)))
    path = Path(tempfile.mkdtemp(prefix='ftt_export_wr_')) / 'voc.fjax'
    save_checkpoint(jax.tree.map(np.asarray, variables), config, path,
                    step=1)
    return str(path)


# ------------------------------------------------------------------ ops

def _birnn_case(seed, cell='gru', T=9, B=3, S=4, H=8):
    g = torch.Generator().manual_seed(seed)
    ng = 4 if cell == 'lstm' else 3
    gi = torch.randn((T, B, S, ng * H), generator=g) * 0.5
    w = (torch.rand((S, ng * H, H), generator=g) * 2 - 1) / H ** 0.5
    b = torch.rand((S, ng * H), generator=g) * 0.1
    lengths = torch.tensor([T, T - 3, 1][:B], dtype=torch.int32)
    return gi, w, b, lengths


@pytest.mark.parametrize('cell', ['gru', 'lstm'])
def test_ops_equal_plain_versions(cell):
    from forwardtacotron_tpu_torch.kernels import wavernn_sample as ws
    from forwardtacotron_tpu_torch.models.wavernn import WaveRNN
    from forwardtacotron_tpu_torch.ops.rnn import birnn_recurrence
    gi, w, b, lengths = _birnn_case(1, cell)
    for dtype in (F32, torch.bfloat16):
        args = (gi.to(dtype), w.to(dtype), b, lengths)
        got = torch.ops.ftt.birnn_recurrence(cell, *args, dtype)
        assert torch.equal(got, birnn_recurrence(cell, *args, dtype))
    torch.manual_seed(0)
    model = WaveRNN(rnn_dims=16, fc_dims=16, feat_dims=10, res_blocks=1,
                    compute_dims=8, res_out_dims=8, hop_length=4,
                    upsample_factors=(2, 2), mode='RAW' if cell == 'gru'
                    else 'MOL')
    nr_mix = 0 if cell == 'gru' else model.n_classes // 3
    w = ws.pack_weights(model, F32)
    cond = torch.randn((40, 3, 10 + 8)) * 0.5
    for greedy in (True, False):
        got = torch.ops.ftt.wavernn_sample(
            cond, [w[k] for k in ws.WEIGHT_KEYS], torch.tensor(5), nr_mix,
            greedy, F32)
        assert torch.equal(got, ws.sample_plain(cond, w, 5, nr_mix, greedy,
                                                F32))
    assert torch.equal(ws.sample(cond, w, torch.tensor(5), nr_mix, False,
                                 F32), ws.sample(cond, w, 5, nr_mix, False,
                                                 F32))


@pytest.mark.parametrize('cell', ['gru', 'lstm'])
def test_recurrence_op_matches_jax_scan(cell):
    """The port's bidirectional RNN, whose recurrence is the op on CPU
    tensors, against JAX's scan ops at atol 1e-5 (ragged lengths)."""
    from forwardtacotron_tpu.ops import rnn as jrnn
    from forwardtacotron_tpu_torch.ops import rnn as trnn
    rng = np.random.RandomState(len(cell))
    T, D, H, B = 13, 6, 8, 3
    ng = 4 if cell == 'lstm' else 3

    def params():
        return {k: (rng.randn(*s) * 0.3).astype(np.float32) for k, s in
                (('w_ih', (ng * H, D)), ('w_hh', (ng * H, H)),
                 ('b_ih', (ng * H,)), ('b_hh', (ng * H,)))}
    pf, pb = params(), params()
    x = (rng.randn(B, T, D) * 0.3).astype(np.float32)
    lens = (13, 7, 2)
    jfn = jrnn.bilstm if cell == 'lstm' else jrnn.bigru
    tfn = trnn.bilstm if cell == 'lstm' else trnn.bigru
    ref = jfn({k: jnp.asarray(v) for k, v in pf.items()},
              {k: jnp.asarray(v) for k, v in pb.items()}, jnp.asarray(x),
              lengths=jnp.asarray(lens))
    with torch.no_grad():
        out = tfn({k: torch.from_numpy(v) for k, v in pf.items()},
                  {k: torch.from_numpy(v) for k, v in pb.items()},
                  torch.from_numpy(x), lengths=torch.tensor(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_opcheck():
    from forwardtacotron_tpu_torch.kernels import wavernn_sample as ws
    from forwardtacotron_tpu_torch.models.wavernn import WaveRNN
    gi, w, b, lengths = _birnn_case(2)
    torch.library.opcheck(torch.ops.ftt.birnn_recurrence.default,
                          ('gru', gi, w, b, lengths, F32))
    torch.manual_seed(1)
    model = WaveRNN(rnn_dims=16, fc_dims=16, feat_dims=10, res_blocks=1,
                    compute_dims=8, res_out_dims=8, hop_length=4,
                    upsample_factors=(2, 2))
    wp = ws.pack_weights(model, F32)
    torch.library.opcheck(
        torch.ops.ftt.wavernn_sample.default,
        (torch.randn((12, 2, 18)) * 0.5, [wp[k] for k in ws.WEIGHT_KEYS],
         torch.tensor(3), 0, False, F32))


# ------------------------------------------------------- vocode program

def test_vocode_program_matches_jax(monkeypatch):
    """Two utterances of 90 and 57 frames (a 96-frame batch) through the
    port's `vocode_program` and JAX's `build_vocode_program`, greedy at
    the reference fold. JAX's scan sampler casts its loop weights to
    bfloat16 by default; it runs in float32 here (as
    tests/test_torch_vocode.py patches it), the port's program too."""
    from forwardtacotron_tpu.models import wavernn as jw
    from forwardtacotron_tpu.models.wavernn import (TARGET_REFERENCE,
                                                    build_vocode_program)
    scan = jw.WaveRNN.sample_scan
    monkeypatch.setattr(
        jw.WaveRNN, 'sample_scan',
        lambda self, m, a, key, greedy=False, weights_dtype=None: scan(
            self, m, a, key, greedy=greedy, weights_dtype=jnp.float32))
    from forwardtacotron_tpu.utils.checkpoints import load_voc_checkpoint
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.gen_forward import load_voc
    from forwardtacotron_tpu_torch.models.wavernn import vocode_program
    path = _wavernn_fjax()
    jmodel, jvars, _, _ = load_voc_checkpoint(path)
    model = load_voc(path, default_config(), 'cpu')[0]
    rng = np.random.RandomState(4)
    mel = (rng.randn(2, 96, 80) * 0.5 - 2.0).astype(np.float32)
    hop = DSP['hop_length']
    wave_lens = np.array([89 * hop, 56 * hop], np.int32)
    outs = {}
    for pcm16 in (False, True):
        jrun = jax.jit(build_vocode_program(
            jmodel, target=TARGET_REFERENCE, overlap=550, mu_law=True,
            greedy=True, use_pallas=False, pcm16=pcm16))
        ref = np.asarray(jrun(jvars, jnp.asarray(mel),
                              jnp.asarray(wave_lens),
                              jnp.asarray(0, jnp.int32)))
        program = vocode_program(model, TARGET_REFERENCE, 550, True,
                                 greedy=True, pcm16=pcm16,
                                 compute_dtype=F32)
        with torch.no_grad():
            ours = program(torch.from_numpy(mel),
                           torch.from_numpy(wave_lens).long(),
                           torch.tensor(0)).numpy()
        assert ours.shape == ref.shape
        outs[pcm16] = ours, ref
    ours, ref = outs[False]
    np.testing.assert_allclose(ours, ref, atol=1e-5)     # the same classes
    for i, n in enumerate(wave_lens):
        assert not ours[i, n:].any() and not ref[i, n:].any()
    ours, ref = outs[True]
    assert ours.dtype == np.int16
    assert int(np.abs(ours.astype(np.int32) - ref).max()) <= 1


# -------------------------------------------------------- export generate

@pytest.mark.parametrize('kind,n_speakers', [('forward_tacotron', 1),
                                             ('fast_pitch', 1),
                                             ('forward_tacotron', 4)])
def test_export_generate_matches_jax(kind, n_speakers):
    from forwardtacotron_tpu.utils.export import ExportedTTS as JaxExported
    from forwardtacotron_tpu_torch.utils.export import ExportedTTS
    ours_path, jax_path = _artifacts(kind, n_speakers)
    ours, theirs = ExportedTTS(ours_path), JaxExported(jax_path)
    assert ours.meta['device'] == 'cpu'
    speakers = (0,) if n_speakers == 1 else (0, 2)
    for spk in speakers:
        for knobs in ({}, {'alpha': 1.5}, {'pitch_scale': 2.0,
                                           'energy_scale': 0.5}):
            mel, dur = ours.generate(IDS, speaker=spk, **knobs)
            ref_mel, ref_dur = theirs.generate(IDS, speaker=spk, **knobs)
            assert mel.shape == ref_mel.shape, (spk, knobs)
            assert float(np.abs(mel - ref_mel).mean()) < 1e-3, (spk, knobs)
            np.testing.assert_allclose(dur, ref_dur, atol=1e-4)
    # the knobs are runtime inputs of one artifact
    assert ours.generate(IDS, alpha=1.5)[0].shape[1] \
        < ours.generate(IDS)[0].shape[1]
    with pytest.raises(ValueError, match='exceeds all exported buckets'):
        ours.generate(list(range(1, 18)))
    with pytest.raises(ValueError, match='exceeds all exported buckets'):
        theirs.generate(list(range(1, 18)))
    if n_speakers > 1:
        msg = 'speaker 4 out of range for a 4-speaker artifact'
        for art in (ours, theirs):
            with pytest.raises(ValueError, match=msg):
                art.generate(IDS, speaker=4)


# ---------------------------------------------------- export with vocoder

def test_export_with_hifigan_matches_jax():
    from forwardtacotron_tpu.utils.export import ExportedTTS as JaxExported
    from forwardtacotron_tpu_torch.utils.export import ExportedTTS
    ours_path, jax_path = _artifacts('forward_tacotron', 1, 'hifigan')
    ours, theirs = ExportedTTS(ours_path), JaxExported(jax_path)
    assert ours.meta['vocoder'] == 'gan'
    for knobs in ({}, {'alpha': 1.3, 'pitch_scale': 0.8}):
        pcm, ref = ours.synthesize(IDS, **knobs), theirs.synthesize(IDS,
                                                                    **knobs)
        assert pcm.dtype == np.int16 and pcm.shape == ref.shape
        assert int(np.abs(pcm.astype(np.int32) - ref).max()) <= 2

    def tokenize(sentence):
        return [1 + (ord(c) % 37) for c in sentence][:12]
    text = 'One two. Three four! Five.'
    pcm = ours.synthesize_long(text, tokenize, gap_ms=50.0)
    ref = theirs.synthesize_long(text, tokenize, gap_ms=50.0)
    assert pcm.shape == ref.shape
    assert int(np.abs(pcm.astype(np.int32) - ref).max()) <= 2
    parts = [ours.synthesize(tokenize(s))
             for s in ('One two.', 'Three four!', 'Five.')]
    assert len(pcm) == sum(len(p) for p in parts) + 2 * int(22050 * 0.05)
    mel_only = ExportedTTS(_artifacts('forward_tacotron')[0])
    with pytest.raises(ValueError, match='exported without a vocoder'):
        mel_only.synthesize(IDS)


def test_export_with_wavernn():
    """The sampler's seed is a runtime input: the same seed repeats the
    PCM, another changes it; `wav_len` is JAX's (the noise streams of the
    two packages differ, so the samples are not compared)."""
    from forwardtacotron_tpu.utils.export import ExportedTTS as JaxExported
    from forwardtacotron_tpu_torch.utils.export import ExportedTTS
    ours_path, jax_path = _artifacts('forward_tacotron', 1, 'wavernn')
    ours = ExportedTTS(ours_path)
    assert ours.meta['vocoder'] == 'wavernn'
    ids = IDS[:5]
    a = ours.synthesize(ids, seed=1)
    assert a.dtype == np.int16
    assert np.array_equal(a, ours.synthesize(ids, seed=1))
    assert not np.array_equal(a, ours.synthesize(ids, seed=2))
    ref = JaxExported(jax_path).synthesize(ids, seed=1)
    assert a.shape == ref.shape


def test_foreign_artifacts_refused(tmp_path, monkeypatch):
    from forwardtacotron_tpu_torch.utils.export import MAGIC, ExportedTTS
    _, jax_path = _artifacts('forward_tacotron')
    with pytest.raises(ValueError, match='JAX StableHLO artifact'):
        ExportedTTS(jax_path)
    junk = tmp_path / 'junk.bin'
    junk.write_bytes(b'not an artifact at all')
    with pytest.raises(ValueError, match='not a ForwardTacotron-TPU'):
        ExportedTTS(junk)
    meta = json.dumps({'device': 'cuda', 'vocoder': None}).encode()
    cuda_art = tmp_path / 'cuda.ftpt'
    cuda_art.write_bytes(MAGIC + np.int32(len(meta)).tobytes() + meta
                         + np.int32(0).tobytes())
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='exported for CUDA'):
        ExportedTTS(cuda_art)


def test_artifact_runs_without_jax_or_model_classes():
    """A fresh process loads the HiFi-GAN artifact and synthesizes the
    same PCM; it imports neither JAX nor forwardtacotron_tpu_torch.models
    (the ops come from forwardtacotron_tpu_torch.kernels)."""
    from forwardtacotron_tpu_torch.utils.export import ExportedTTS
    path, _ = _artifacts('forward_tacotron', 1, 'hifigan')
    script = (
        'import sys, numpy as np\n'
        'from forwardtacotron_tpu_torch.utils.export import ExportedTTS\n'
        f'pcm = ExportedTTS({path!r}).synthesize({IDS!r})\n'
        'bad = [m for m in sys.modules if m.split(".")[0] in '
        '("jax", "jaxlib", "flax", "forwardtacotron_tpu") '
        'or m.startswith("forwardtacotron_tpu_torch.models")]\n'
        'assert not bad, bad\n'
        'np.save(sys.stdout.buffer, pcm)\n')
    out = subprocess.run([sys.executable, '-c', script], cwd=ROOT,
                         capture_output=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(ROOT),
                                  CUDA_VISIBLE_DEVICES=''))
    assert out.returncode == 0, out.stderr.decode()[-2000:]
    import io
    pcm = np.load(io.BytesIO(out.stdout))
    assert np.array_equal(pcm, ExportedTTS(path).synthesize(IDS))


def test_export_forward_cli(tmp_path, capsys):
    """`python -m forwardtacotron_tpu_torch.export_forward` on a port
    `.pt` with a HiFi-GAN file, two buckets, for the CPU; and with a
    random WaveRNN (`--voc_type wavernn`)."""
    from forwardtacotron_tpu_torch import export_forward
    from forwardtacotron_tpu_torch.gen_forward import load_tts
    from forwardtacotron_tpu_torch.utils.checkpoints import save_checkpoint
    from forwardtacotron_tpu_torch.utils.export import ExportedTTS
    model, config, _ = load_tts(_tts_fjax('forward_tacotron'), {}, 'cpu')
    ckpt = tmp_path / 'latest_model.pt'
    save_checkpoint(model, None, config, ckpt, step=1000)
    out = tmp_path / 'tts.ftpt'
    export_forward.main(['--checkpoint', str(ckpt), '--output', str(out),
                         '--buckets', '8:64,16:128', '--device', 'cpu',
                         '--voc_checkpoint', _hifigan_file()])
    assert 'Exported step-1000 ForwardTacotron + fused vocoder' \
        in capsys.readouterr().out
    art = ExportedTTS(out)
    assert sorted(art.buckets) == [(8, 64), (16, 128)]
    assert art.synthesize(IDS[:6]).dtype == np.int16
    assert art.synthesize(IDS).dtype == np.int16
    out = tmp_path / 'tts_wr.ftpt'
    export_forward.main(['--checkpoint', str(ckpt), '--output', str(out),
                         '--buckets', '16:64', '--device', 'cpu',
                         '--voc_type', 'wavernn'])
    assert ExportedTTS(out).meta['vocoder'] == 'wavernn'
