"""The port's HiFi-GAN and MelGAN generators (CPU) against the JAX
package's, from the same checkpoint files.

Files are written in the layouts users bring: the official HiFi-GAN
{'generator': state_dict} with weight_g / weight_v (by the port's
`weight_norm_state_dict`, and once by torch's own `weight_norm`), the
MelGAN hub layout (positional `generator.N` keys, under `model_g` or
bare), and `.fjax` files written by the JAX package's `save_checkpoint`.
Both packages load each file through their own loaders; waveforms agree
at atol 1e-4 (float32 convolutions summed in other orders).
"""
import json
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

N_MELS = 12
TINY_HIFI = {
    'resblock': '1',
    'upsample_rates': [4, 4],
    'upsample_kernel_sizes': [8, 8],
    'upsample_initial_channel': 32,
    'resblock_kernel_sizes': [3, 5],
    'resblock_dilation_sizes': [[1, 3, 5], [1, 3, 5]],
}
TINY_HIFI_2 = dict(TINY_HIFI, resblock='2',
                   resblock_dilation_sizes=[[1, 3], [1, 3]])
MELGAN_RATES = (4, 2, 2)
ATOL = 1e-4


def _mel(T=23, seed=1):
    return np.random.RandomState(seed).randn(N_MELS, T).astype(np.float32)


def _port_hifigan(cfg, seed=0):
    from forwardtacotron_tpu_torch.models.hifigan import HiFiGANGenerator
    torch.manual_seed(seed)
    return HiFiGANGenerator.from_config(cfg, n_mels=N_MELS)


def _port_melgan(seed=0):
    from forwardtacotron_tpu_torch.models.melgan import MelGANGenerator
    torch.manual_seed(seed)
    return MelGANGenerator(n_mels=N_MELS, base_channels=32,
                           upsample_rates=MELGAN_RATES)


def _official_file(tmp_path, cfg, seed=0, torch_weight_norm=False):
    from forwardtacotron_tpu_torch.models.hifigan import (
        weight_norm_state_dict)
    model = _port_hifigan(cfg, seed)
    if torch_weight_norm:
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
                torch.nn.utils.weight_norm(m)
        sd = model.state_dict()
        assert any(k.endswith('weight_g') for k in sd)
    else:
        sd = weight_norm_state_dict(model)
    path = tmp_path / f'g_{seed:08d}'
    torch.save({'generator': sd}, path)
    (tmp_path / 'config.json').write_text(json.dumps(dict(
        cfg, num_mels=N_MELS)))
    return path


@pytest.mark.parametrize('cfg,torch_wn', [(TINY_HIFI, False),
                                          (TINY_HIFI_2, False),
                                          (TINY_HIFI, True)],
                         ids=['resblock1', 'resblock2', 'torch_weight_norm'])
def test_hifigan_official_file_matches_jax(tmp_path, cfg, torch_wn):
    from forwardtacotron_tpu.models.hifigan import load_hifigan as jload
    from forwardtacotron_tpu.models.hifigan import vocode_hifigan as jvoc
    from forwardtacotron_tpu_torch.models.hifigan import (HiFiGANGenerator,
                                                          load_hifigan,
                                                          vocode_hifigan)
    with warnings.catch_warnings():
        # torch.nn.utils.weight_norm is deprecated, and still what the
        # official files were written with
        warnings.simplefilter('ignore', FutureWarning)
        path = _official_file(tmp_path, cfg, seed=3,
                              torch_weight_norm=torch_wn)
    model = load_hifigan(path, device='cpu')
    assert isinstance(model, HiFiGANGenerator) and model.n_mels == N_MELS
    jmodel, jvars = jload(path)
    mel = _mel()
    ours = vocode_hifigan(model, mel, frame_bucket=8)
    ref = jvoc(jmodel, jvars, mel, frame_bucket=8)
    assert ours.shape == ref.shape == (mel.shape[1] * model.hop_length,)
    np.testing.assert_allclose(ours, ref, atol=ATOL)
    np.testing.assert_array_equal(vocode_hifigan(model, mel.T,
                                                 frame_bucket=8), ours)
    pcm = vocode_hifigan(model, mel, frame_bucket=8, pcm16=True)
    assert pcm.dtype == np.int16 and pcm.shape == ours.shape
    np.testing.assert_array_equal(
        pcm, (np.clip(ours, -1, 1) * 32767.0).astype(np.int16))


@pytest.mark.parametrize('wrapper', ['model_g', None])
def test_melgan_hub_file_matches_jax(tmp_path, wrapper):
    from forwardtacotron_tpu.models.melgan import load_melgan as jload
    from forwardtacotron_tpu.models.melgan import vocode_melgan as jvoc
    from forwardtacotron_tpu_torch.models.hifigan import (
        weight_norm_state_dict)
    from forwardtacotron_tpu_torch.models.melgan import (load_melgan,
                                                         vocode_melgan)
    sd = weight_norm_state_dict(_port_melgan(seed=4))
    assert 'generator.1.weight_v' in sd and \
        'generator.4.blocks.0.2.weight_g' in sd
    path = tmp_path / 'melgan.pt'
    torch.save({wrapper: sd} if wrapper else sd, path)
    model = load_melgan(path, upsample_rates=MELGAN_RATES, device='cpu')
    jmodel, jvars = jload(path, upsample_rates=MELGAN_RATES)
    mel = _mel(T=21, seed=5)
    ours = vocode_melgan(model, mel, frame_bucket=8)
    ref = jvoc(jmodel, jvars, mel, frame_bucket=8)
    assert ours.shape == ref.shape == (21 * model.hop_length,)
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def test_melgan_converter_checks_architecture():
    from forwardtacotron_tpu_torch.models.hifigan import (
        weight_norm_state_dict)
    from forwardtacotron_tpu_torch.models.melgan import (
        MelGANGenerator, convert_melgan_generator)
    sd = weight_norm_state_dict(_port_melgan())
    other = MelGANGenerator(n_mels=N_MELS, base_channels=32,
                            upsample_rates=(4, 2))
    with pytest.raises(ValueError, match='architecture mismatch'):
        convert_melgan_generator(sd, other)
    wider = MelGANGenerator(n_mels=N_MELS, base_channels=64,
                            upsample_rates=MELGAN_RATES)
    with pytest.raises(ValueError, match='does not fit'):
        convert_melgan_generator(sd, wider)


def test_load_gan_vocoder_sniffs_the_file(tmp_path):
    from forwardtacotron_tpu_torch.models.hifigan import (
        HiFiGANGenerator, load_gan_vocoder, weight_norm_state_dict)
    from forwardtacotron_tpu_torch.models.melgan import MelGANGenerator
    hifi = _official_file(tmp_path, TINY_HIFI)
    assert isinstance(load_gan_vocoder(hifi, device='cpu'),
                      HiFiGANGenerator)
    # a hub file at the hub's rates (8, 8, 2, 2), wrapped and bare
    sd = weight_norm_state_dict(MelGANGenerator(n_mels=N_MELS,
                                                base_channels=32))
    for name, payload in (('wrapped.pt', {'model_g': sd}),
                          ('bare.pt', sd)):
        torch.save(payload, tmp_path / name)
        assert isinstance(load_gan_vocoder(tmp_path / name, device='cpu'),
                          MelGANGenerator)
    with pytest.raises(ValueError, match='voc_type'):
        load_gan_vocoder(hifi, voc_type='wavernn', device='cpu')


def _fjax_config(model_cfg):
    from forwardtacotron_tpu_torch.config import default_config
    cfg = default_config()
    cfg['dsp']['num_mels'] = N_MELS
    cfg['hifigan'] = {'model': model_cfg}
    return cfg


def test_hifigan_state_dict_equals_torch_export():
    from forwardtacotron_tpu.models.hifigan import HiFiGANGenerator as JHG
    from forwardtacotron_tpu.models.torch_export import (
        export_hifigan_generator)
    from forwardtacotron_tpu_torch.models.hifigan import fold_weight_norm
    from forwardtacotron_tpu_torch.weights import hifigan_state_dict
    for cfg in (TINY_HIFI, TINY_HIFI_2):
        jmodel = JHG.from_config(cfg)
        variables = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 8, N_MELS))))
        sd = hifigan_state_dict(variables, _fjax_config(
            dict(cfg, generator_type='hifigan')))
        ref = fold_weight_norm(export_hifigan_generator(variables, jmodel))
        assert set(sd) == set(ref)
        for k in ref:
            assert sd[k].dtype == torch.float32, k
            torch.testing.assert_close(sd[k], ref[k], atol=1e-6, rtol=1e-5)
        # a full GAN train state's generator subtree is taken the same way
        gan = {'params': {'generator': variables['params'],
                          'discriminator': {}}}
        assert set(hifigan_state_dict(gan, _fjax_config(cfg))) == set(ref)


@pytest.mark.parametrize('kind', ['hifigan', 'melgan'])
def test_fjax_generator_matches_jax(tmp_path, kind):
    from forwardtacotron_tpu.models.hifigan import load_hifigan as jload
    from forwardtacotron_tpu.train.hifigan_trainer import (
        make_generator as jmake)
    from forwardtacotron_tpu.train.hifigan_trainer import (
        vocode_generator as jvoc)
    from forwardtacotron_tpu.utils.checkpoints import save_checkpoint
    from forwardtacotron_tpu_torch.models.hifigan import (load_gan_vocoder,
                                                          make_generator,
                                                          vocode_generator)
    model_cfg = dict(TINY_HIFI, generator_type=kind)
    if kind == 'melgan':
        model_cfg['upsample_rates'] = list(MELGAN_RATES)
    cfg = _fjax_config(model_cfg)
    jmodel = jmake(cfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(2),
                                     jnp.zeros((1, 8, N_MELS)))
    path = tmp_path / 'gen.fjax'
    save_checkpoint({'params': {'generator': variables['params']}}, cfg,
                    path, step=10)
    model = load_gan_vocoder(path, device='cpu')
    assert type(model) is type(make_generator(cfg))
    jm, jv = jload(path)
    mel = _mel(T=19, seed=6)
    ours = vocode_generator(model, mel, pcm16=False)
    ref = jvoc(jm, jv, mel)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def test_gan_loaders_default_to_cuda(tmp_path, monkeypatch):
    from forwardtacotron_tpu_torch.models.hifigan import load_gan_vocoder
    path = _official_file(tmp_path, TINY_HIFI)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        load_gan_vocoder(path)
