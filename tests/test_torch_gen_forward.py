"""The port's `gen_forward` CLI on the CPU at a tiny width: every vocoder
subcommand and flag of the JAX package's CLI, with a `.pt` TTS
checkpoint written by the port (random seeded weights) and a tiny
WaveRNN built from the same config.

The CLI's outputs are held against the port's own functions on the same
models: the mel export is `synthesize`'s mel exactly, `--split_sentences`
joins the sentences' mels with 10 MEL_PAD frames, the HiFi-GAN wav is
`vocode_hifigan` of that mel, the streamed and batched WaveRNN wavs have
the utterances' lengths.
"""
import json

import numpy as np
import pytest
import torch

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
TINY_VOC = {'mode': 'RAW', 'upsample_factors': [4, 4], 'rnn_dims': 16,
            'fc_dims': 16, 'compute_dims': 8, 'res_out_dims': 8,
            'res_blocks': 1, 'pad': 2}
TINY_HIFI = {'resblock': '1', 'upsample_rates': [4, 4],
             'upsample_kernel_sizes': [8, 8], 'upsample_initial_channel': 16,
             'resblock_kernel_sizes': [3], 'resblock_dilation_sizes': [[1, 3]]}
HOP, N_MELS = 16, 12


def _config():
    from forwardtacotron_tpu_torch.config import default_config
    cfg = default_config()
    cfg['dsp'].update(n_fft=64, win_length=64, hop_length=HOP,
                      num_mels=N_MELS)
    cfg['forward_tacotron']['model'] = dict(TINY_FT)
    cfg['vocoder']['model'] = dict(TINY_VOC)
    return cfg


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.models.hifigan import (
        HiFiGANGenerator, weight_norm_state_dict)
    from forwardtacotron_tpu_torch.models.melgan import MelGANGenerator
    from forwardtacotron_tpu_torch.utils.checkpoints import save_checkpoint
    d = tmp_path_factory.mktemp('gen_forward')
    cfg = _config()
    torch.manual_seed(0)
    save_checkpoint(ForwardTacotron.from_config(cfg), None, cfg,
                    d / 'tts.pt', step=3000)
    hifi = HiFiGANGenerator.from_config(TINY_HIFI, n_mels=N_MELS)
    torch.save({'generator': weight_norm_state_dict(hifi)}, d / 'g.pt')
    (d / 'hifigan.json').write_text(json.dumps(TINY_HIFI))
    melgan = MelGANGenerator(n_mels=N_MELS, base_channels=16,
                             upsample_rates=(8, 8, 2, 2))
    torch.save({'model_g': weight_norm_state_dict(melgan)}, d / 'm.pt')
    (d / 'sentences.txt').write_text('The birch canoe slid.\n\n'
                                     'Glue the sheet.\n')
    return d


def _run(files, monkeypatch, *argv):
    from forwardtacotron_tpu_torch import gen_forward
    monkeypatch.chdir(files)
    return gen_forward.main(['--checkpoint', str(files / 'tts.pt'),
                             '--device', 'cpu', *argv])


def _mel(files, text, split=False):
    from forwardtacotron_tpu_torch import gen_forward
    model, cfg, _ = gen_forward.load_tts(str(files / 'tts.pt'), None, 'cpu')
    return gen_forward.synthesize_text(model, text, cfg, split=split)


def _wav(path):
    from scipy.io import wavfile
    sr, wav = wavfile.read(path)
    assert sr == 22050 and wav.dtype == np.int16
    return wav


def test_target_default_is_none():
    from forwardtacotron_tpu_torch import gen_forward
    args = gen_forward._parser().parse_args(['wavernn'])
    assert args.target is None and args.stream_group == 8
    assert args.overlap == 550


def test_griffinlim(files, monkeypatch):
    (path,) = _run(files, monkeypatch, '-i', 'Hello world.', 'griffinlim')
    assert path.name == '1_forward_3k_alpha1.0_amp1.0_griffinlim.wav'
    mel = _mel(files, 'Hello world.')
    wav = _wav(path)
    assert len(wav) == (mel.shape[1] - 1) * HOP and np.abs(wav).max() > 0


@pytest.mark.parametrize('vocoder,suffix', [('hifigan', '.npy'),
                                            ('melgan', '.mel')])
def test_mel_export_without_checkpoint(files, monkeypatch, vocoder, suffix):
    (path,) = _run(files, monkeypatch, '-i', 'Hello world.', vocoder)
    assert path.suffix == suffix
    got = np.load(path) if suffix == '.npy' else torch.load(path).numpy()
    np.testing.assert_array_equal(got, _mel(files, 'Hello world.')[None])


def test_hifigan_and_melgan_with_checkpoints(files, monkeypatch):
    from forwardtacotron_tpu_torch.models.hifigan import (load_hifigan,
                                                          vocode_hifigan)
    text = 'Hello world. How are you?'
    (path,) = _run(files, monkeypatch, '-i', text, 'hifigan',
                   '--voc_checkpoint', str(files / 'g.pt'), '--voc_config',
                   str(files / 'hifigan.json'))
    mel = _mel(files, text)
    want = vocode_hifigan(load_hifigan(files / 'g.pt', TINY_HIFI, 'cpu'),
                          mel, pcm16=True)
    np.testing.assert_array_equal(_wav(path), want)
    (path,) = _run(files, monkeypatch, '-i', text, 'melgan',
                   '--voc_checkpoint', str(files / 'm.pt'))
    assert len(_wav(path)) == mel.shape[1] * 256


def test_split_sentences_joins_with_silence(files, monkeypatch):
    from forwardtacotron_tpu_torch.data.dataset import MEL_PAD
    text = 'Hello world. How are you?'
    (path,) = _run(files, monkeypatch, '--split_sentences', '-i', text,
                   'hifigan')
    got = np.load(path)[0]
    a, b = _mel(files, 'Hello world.'), _mel(files, 'How are you?')
    assert got.shape == (N_MELS, a.shape[1] + 10 + b.shape[1])
    np.testing.assert_array_equal(got[:, :a.shape[1]], a)
    assert np.all(got[:, a.shape[1]:a.shape[1] + 10] == np.float32(MEL_PAD))
    np.testing.assert_array_equal(got[:, a.shape[1] + 10:], b)


def test_wavernn_plain_stream_and_batched(files, monkeypatch):
    lines = ['The birch canoe slid.', 'Glue the sheet.']
    lens = [(_mel(files, t).shape[1] - 1) * HOP for t in lines]
    fold = ['--target', '200', '--overlap', '50']
    for flags in (fold, ['--stream', '--stream_group', '2'] + fold,
                  ['--batched_utterances'] + fold):
        paths = _run(files, monkeypatch, 'wavernn', *flags)
        assert [p.name[:2] for p in paths] == ['1_', '2_']
        assert [len(_wav(p)) for p in paths] == lens, flags


def test_rejections(files, monkeypatch):
    from forwardtacotron_tpu_torch import gen_forward
    with pytest.raises(SystemExit):
        _run(files, monkeypatch, '--speaker', '1', '-i', 'Hi.', 'griffinlim')
    with pytest.raises(SystemExit):
        _run(files, monkeypatch, '-i', 'Hi.')            # no vocoder
    (path,) = _run(files, monkeypatch, '--speaker', '0', '-i', 'Hi.',
                   'griffinlim')
    assert path.exists()
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        gen_forward.main(['--checkpoint', str(files / 'tts.pt'), '-i', 'Hi.',
                          'griffinlim'])
