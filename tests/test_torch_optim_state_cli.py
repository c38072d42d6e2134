"""The five training CLIs resuming a JAX `latest_model.fjax` with its
optimizer state, at tiny widths of the built-in config: `train_forward`,
`train_tacotron`, `train_wavernn`, `train_aligner` and `train_hifigan`
(both nets and both AdamW states). JAX builds each model from the same
config, takes two optimizer updates and writes the file with
`save_checkpoint`; each CLI runs up to its trainer, whose `train` is
replaced by a probe of what it was handed. Exact: the weights and the
moments through the weight maps, `step` equal to Adam's count.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_optim_state import _adam_state, _np


def _config(tmp_path):
    from forwardtacotron_tpu_torch.config import default_config
    cfg = default_config()
    cfg['data_path'] = str(tmp_path / 'data')
    cfg['forward_tacotron']['model'].update(
        embed_dims=8, series_embed_dims=4, durpred_conv_dims=4,
        durpred_rnn_dims=4, pitch_conv_dims=4, pitch_rnn_dims=4,
        energy_conv_dims=4, energy_rnn_dims=4, rnn_dims=8, prenet_dims=8,
        prenet_k=2, prenet_num_highways=1, postnet_dims=8, postnet_k=2,
        postnet_num_highways=1)
    # tests/test_torch_tacotron.py's widths (the encoder stays 128 wide)
    cfg['tacotron']['model'].update(embed_dims=16, encoder_dims=128,
                                    decoder_dims=256, postnet_dims=8,
                                    encoder_k=2, lstm_dims=32, postnet_k=3,
                                    num_highways=1)
    cfg['vocoder']['model'].update(rnn_dims=16, fc_dims=16, compute_dims=8,
                                   res_out_dims=8, res_blocks=1)
    cfg['aligner']['model'].update(embed_dims=8, conv_dims=8, key_dims=4,
                                   n_text_convs=1, n_mel_convs=1)
    cfg['hifigan']['model'].update(upsample_initial_channel=16,
                                   resblock_kernel_sizes=[3],
                                   resblock_dilation_sizes=[[1, 3, 5]])
    return cfg


def _updated(optimizer, params, seed=0):
    """`optimizer`'s state after two updates with random gradients."""
    state = jax.jit(optimizer.init)(params)
    update = jax.jit(lambda g, s: optimizer.update(g, s, params)[1])
    rng = np.random.RandomState(seed)
    for _ in range(2):
        state = update(jax.tree.map(
            lambda p: rng.randn(*np.shape(p)).astype(np.float32), params),
            state)
    return state


def _tokens(n=7):
    return jnp.asarray(np.arange(1, n + 1)[None], jnp.int32)


def _jax_variables(kind, cfg):
    """(flax variables of the model the CLI builds, as numpy)."""
    key = jax.random.PRNGKey(0)
    n_mels = cfg['dsp']['num_mels']
    x, mel = _tokens(), jnp.zeros((1, 12, n_mels))
    if kind == 'forward':
        from forwardtacotron_tpu.utils.checkpoints import init_tts_model
        batch = {'x': x, 'x_len': jnp.asarray([7]), 'mel': mel,
                 'mel_len': jnp.asarray([12]),
                 'dur': jnp.full((1, 7), 1.0), 'pitch': jnp.zeros((1, 7)),
                 'energy': jnp.zeros((1, 7))}
        v = jax.jit(lambda k: init_tts_model(cfg).init(
            {'params': k}, batch, train=False))(key)
    elif kind == 'tacotron':
        from forwardtacotron_tpu.models.tacotron import Tacotron
        v = jax.jit(lambda k: Tacotron.from_config(cfg).init(
            {'params': k}, x, mel, 2, train=False))(key)
    elif kind == 'wavernn':
        from forwardtacotron_tpu.models.wavernn import WaveRNN
        hop, pad = cfg['dsp']['hop_length'], cfg['vocoder']['model']['pad']
        v = jax.jit(WaveRNN.from_config(cfg).init)(
            key, jnp.zeros((1, (12 - 2 * pad) * hop)), mel)
    else:
        from forwardtacotron_tpu.align.aligner import aligner_from_config
        v = jax.jit(aligner_from_config(cfg).init)(
            key, x, mel, jnp.asarray([7]), jnp.asarray([12]))
    return _np(v)


def _check(optimizer, model, variables, opt_state, to_sd):
    want_w = to_sd(variables)
    adam = _adam_state(opt_state)
    moments = {k: to_sd(dict(variables, params=_np(getattr(adam, k))))
               for k in ('mu', 'nu')}
    named = dict(model.named_parameters())
    assert len(named) > 5 and len(optimizer.state) == len(named)
    for name, p in named.items():
        assert torch.equal(p.detach(), want_w[name]), name
        st = optimizer.state[p]
        assert float(st['step']) == int(adam.count) == 2, name
        assert torch.equal(st['exp_avg'], moments['mu'][name]), name
        assert torch.equal(st['exp_avg_sq'], moments['nu'][name]), name


@pytest.mark.parametrize('kind', ['forward', 'tacotron', 'wavernn',
                                  'aligner'])
def test_cli_resumes_adam_from_fjax(tmp_path, monkeypatch, kind):
    import yaml
    from forwardtacotron_tpu.train import common as jtc
    from forwardtacotron_tpu.utils.checkpoints import save_checkpoint
    from forwardtacotron_tpu_torch import (train_aligner, train_forward,
                                           train_tacotron, train_wavernn)
    from forwardtacotron_tpu_torch.train import (aligner_trainer,
                                                 forward_trainer,
                                                 taco_trainer, voc_trainer)
    from forwardtacotron_tpu_torch.utils.paths import Paths
    from forwardtacotron_tpu_torch.weights import (aligner_state_dict,
                                                   tacotron_state_dict,
                                                   tts_state_dict,
                                                   wavernn_state_dict)
    cfg = _config(tmp_path)
    paths = Paths(cfg['data_path'], cfg['tts_model_id'], base=tmp_path,
                  voc_id=cfg['voc_model_id'])
    cli, trainer, directory, to_sd = {
        'forward': (train_forward, forward_trainer.ForwardTrainer,
                    paths.forward_checkpoints,
                    lambda v: tts_state_dict(v, cfg, 2)),
        'tacotron': (train_tacotron, taco_trainer.TacoTrainer,
                     paths.taco_checkpoints,
                     lambda v: tacotron_state_dict(
                         v, cfg['tacotron']['model'], 2)),
        'wavernn': (train_wavernn, voc_trainer.VocTrainer,
                    paths.voc_checkpoints,
                    lambda v: wavernn_state_dict(
                        v, cfg['vocoder']['model'], 2)),
        'aligner': (train_aligner, aligner_trainer.AlignerTrainer,
                    paths.aligner_checkpoints,
                    lambda v: aligner_state_dict(v, 2))}[kind]
    variables = _jax_variables(kind, cfg)
    opt_state = _updated(jtc.make_optimizer(1.0), variables['params'])
    directory.mkdir(parents=True, exist_ok=True)
    save_checkpoint(variables, cfg, directory / 'latest_model.fjax',
                    opt_state=opt_state, step=2)
    (tmp_path / 'data' / 'alg').mkdir(parents=True, exist_ok=True)
    (tmp_path / 'data' / 'alg' / 'a.npy').write_bytes(b'')
    seen = {}

    def train(self, model, optimizer, step, *a, **kw):
        seen.update(model=model, optimizer=optimizer, step=step)
        return step
    monkeypatch.setattr(trainer, 'train', train)
    monkeypatch.setattr(train_tacotron, '_align', lambda *a: None)
    monkeypatch.setattr(train_aligner, 'get_tts_datasets',
                        lambda *a, **k: (None, None))
    monkeypatch.setattr(train_aligner, 'create_align_features_from_aligner',
                        lambda *a, **k: None)
    monkeypatch.setenv('FTT_BASE', str(tmp_path))
    path = tmp_path / 'config.yaml'
    path.write_text(yaml.safe_dump(cfg))
    assert cli.main(['--config', str(path), '--device', 'cpu']) == 2
    assert seen['step'] == 2
    _check(seen['optimizer'], seen['model'], variables, opt_state, to_sd)


def test_train_hifigan_resumes_both_nets_and_adamw_from_fjax(tmp_path,
                                                              monkeypatch):
    """The generator and the discriminators (two periods and two scales
    here, in both frameworks) with both AdamW states, flattened together as
    the JAX GAN trainer writes them."""
    import yaml
    from forwardtacotron_tpu.models.gan_discriminators import (
        HiFiGANDiscriminators as JaxDiscs)
    from forwardtacotron_tpu.train import hifigan_trainer as jht
    from forwardtacotron_tpu.utils.checkpoints import save_checkpoint
    from forwardtacotron_tpu_torch import train_hifigan
    from forwardtacotron_tpu_torch.models.gan_discriminators import (
        HiFiGANDiscriminators)
    from forwardtacotron_tpu_torch.train.hifigan_trainer import (
        HiFiGANTrainer)
    from forwardtacotron_tpu_torch.utils.paths import Paths
    from forwardtacotron_tpu_torch.weights import (discriminator_state_dict,
                                                   hifigan_state_dict)
    periods, n_scales = (2, 3), 2
    cfg = _config(tmp_path)
    paths = Paths(cfg['data_path'], cfg['tts_model_id'], base=tmp_path,
                  voc_id=cfg['voc_model_id'])
    gvars = _np(jax.jit(jht.make_generator(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, cfg['dsp']['num_mels']))))
    y = jnp.zeros((1, 1024))
    dvars = _np(jax.jit(JaxDiscs(periods=periods, n_scales=n_scales).init)(
        jax.random.PRNGKey(1), y, y))
    gopt = _updated(jht.make_gan_optimizer(), gvars['params'])
    dopt = _updated(jht.make_gan_optimizer(), dvars['params'], seed=5)
    paths.hifigan_checkpoints.mkdir(parents=True, exist_ok=True)
    save_checkpoint({'params': {'generator': gvars['params'],
                                'discriminator': dvars['params']}}, cfg,
                    paths.hifigan_checkpoints / 'latest_model.fjax',
                    opt_state=(gopt, dopt), step=2)

    def disc_sd(v):
        return discriminator_state_dict(v, periods, n_scales)
    monkeypatch.setattr(train_hifigan, 'HiFiGANDiscriminators',
                        lambda: HiFiGANDiscriminators(periods, n_scales))
    monkeypatch.setattr(train_hifigan, 'discriminator_state_dict', disc_sd)
    seen = {}

    def train(self, gen, disc, gen_opt, disc_opt, step, **kw):
        seen.update(nets=(gen, disc), opts=(gen_opt, disc_opt), step=step)
        return step
    monkeypatch.setattr(HiFiGANTrainer, 'train', train)
    monkeypatch.setenv('FTT_BASE', str(tmp_path))
    path = tmp_path / 'config.yaml'
    path.write_text(yaml.safe_dump(cfg))
    assert train_hifigan.main(['--config', str(path), '--device',
                               'cpu']) == 2
    for opt, net, variables, state, to_sd in zip(
            seen['opts'], seen['nets'], (gvars, dvars), (gopt, dopt),
            (lambda v: hifigan_state_dict(v, cfg), disc_sd)):
        _check(opt, net, variables, state, to_sd)
        assert opt.param_groups[0]['betas'] == (0.8, 0.99)
