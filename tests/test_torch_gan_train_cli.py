"""The port's `train_hifigan` CLI on the CPU at a tiny width, with both
generator types: a few steps on a synthetic dataset, the checkpoints it
writes, a resumed run against an uninterrupted one (atol 1e-6: the runs
are deterministic on the CPU, and the weight-norm files give the weights
back exactly), and the generator served by `gen_forward`.
"""
import numpy as np
import pytest
import torch

from test_torch_gan_train import (DSP_CFG, SEG_LEN, TINY_HIFI,
                                  _make_gan_dataset)


@pytest.fixture(autouse=True)
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _config(data, generator_type):
    from forwardtacotron_tpu_torch.config import default_config
    cfg = default_config()
    cfg['data_path'] = str(data)
    cfg['dsp'].update(DSP_CFG)
    cfg['forward_tacotron']['model'].update(
        embed_dims=8, series_embed_dims=4, durpred_conv_dims=4,
        durpred_rnn_dims=4, pitch_conv_dims=4, pitch_rnn_dims=4,
        energy_conv_dims=4, energy_rnn_dims=4, rnn_dims=8, prenet_dims=8,
        prenet_k=2, prenet_num_highways=1, postnet_dims=8, postnet_k=2,
        postnet_num_highways=1)
    cfg['hifigan']['model'] = dict(TINY_HIFI, generator_type=generator_type)
    cfg['hifigan']['training'].update(
        schedule=['1e-3, 3, 2'], checkpoint_every=1, gen_samples_every=1,
        num_gen_samples=1, keep_top_k=1, seg_len=SEG_LEN)
    return cfg


class _Scalars:
    def __init__(self):
        self.values = []

    def add_scalar(self, tag, value, step):
        self.values.append((tag, float(value), int(step)))


@pytest.mark.parametrize('generator_type', ['hifigan', 'melgan'])
def test_train_hifigan_end_to_end(tmp_path, monkeypatch, generator_type):
    """`train_hifigan` for 3 steps, an epoch of 2 and one more (losses
    finite, every parameter moved, the evaluation, checkpoints, top-k by the
    samples' mel L1, audio samples), resumed to 4 steps equal to an
    uninterrupted run, and the latest generator served by `gen_forward
    hifigan|melgan --voc_checkpoint`."""
    import yaml
    from forwardtacotron_tpu_torch import gen_forward, train_hifigan
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.models.hifigan import (load_gan_vocoder,
                                                          make_generator)
    from forwardtacotron_tpu_torch.utils.checkpoints import (load_checkpoint,
                                                             save_checkpoint)
    from forwardtacotron_tpu_torch.utils.files import unpickle_binary
    from forwardtacotron_tpu_torch.utils.paths import Paths
    monkeypatch.setenv('FTT_BASE', str(tmp_path))
    monkeypatch.chdir(tmp_path)
    cfg = _config(_make_gan_dataset(tmp_path / 'data', n_items=7),
                  generator_type)
    config_file = tmp_path / 'config.yaml'
    config_file.write_text(yaml.safe_dump(cfg))
    paths = Paths(cfg['data_path'], cfg['tts_model_id'],
                  voc_id=cfg['voc_model_id'])
    writer = _Scalars()
    argv = ['--config', str(config_file), '--device', 'cpu']
    assert train_hifigan.main(argv, writer=writer) == 3
    ckpt = paths.hifigan_checkpoints
    latest = load_checkpoint(ckpt / 'latest_model.pt')
    assert latest['step'] == 3 and {'generator', 'discriminator', 'optim_g',
                                    'optim_d'} <= set(latest)
    assert (ckpt / 'hifigan_step0k.pt').is_file()
    for tag in ('disc_loss', 'gen_loss', 'gen_adv', 'gen_fm', 'gen_mel'):
        values = [v for t, v, _ in writer.values if t == f'Loss/{tag}']
        assert len(values) == 3 and np.isfinite(values).all(), tag
    val = [(v, s) for t, v, s in writer.values if t == 'Loss/val_mel']
    assert len(val) == 1 and val[0][1] == 2 and np.isfinite(val[0][0])
    gen_l1 = [s for t, v, s in writer.values
              if t == 'Loss/generated_mel_l1' and np.isfinite(v)]
    assert gen_l1 == [1, 2, 3]
    index = unpickle_binary(paths.hifigan_top_k / 'top_k.pkl')
    assert len(index) == 1 and [p.name for p in
                                paths.hifigan_top_k.glob('*.pt')] == \
        [index[0][2]]
    assert len(list((paths.hifigan_log / 'audio').glob('*.wav'))) == 3

    torch.manual_seed(train_hifigan.SEED)
    initial = make_generator(cfg).state_dict()
    trained = load_gan_vocoder(ckpt / 'latest_model.pt', generator_type,
                               device='cpu')
    assert type(trained).__name__ == ('MelGANGenerator' if generator_type
                                      == 'melgan' else 'HiFiGANGenerator')
    assert all(not torch.equal(v, initial[k])
               for k, v in trained.state_dict().items())

    cfg['hifigan']['training']['schedule'] = ['1e-3, 4, 2']
    cfg['hifigan']['training']['gen_samples_every'] = 10
    config_file.write_text(yaml.safe_dump(cfg))
    assert train_hifigan.main(argv) == 4
    resumed = load_checkpoint(ckpt / 'latest_model.pt')
    for p in ckpt.glob('*.pt'):
        p.unlink()
    assert train_hifigan.main(argv) == 4
    full = load_checkpoint(ckpt / 'latest_model.pt')
    for part in ('generator', 'discriminator'):
        for k, v in full[part].items():
            np.testing.assert_allclose(resumed[part][k].numpy(), v.numpy(),
                                       atol=1e-6, err_msg=k)

    torch.manual_seed(0)
    save_checkpoint(ForwardTacotron.from_config(cfg), None, cfg,
                    tmp_path / 'tts.pt', step=1)
    (tmp_path / 'sentences.txt').write_text('Hello.\n')
    gen_forward.main(['--checkpoint', str(tmp_path / 'tts.pt'), '--device',
                      'cpu', generator_type, '--voc_checkpoint',
                      str(ckpt / 'latest_model.pt')])
    assert list((tmp_path / 'model_outputs').glob(f'*{generator_type}*.wav'))
