"""The port's GAN vocoder training path on the CPU at a tiny width against
the JAX package, same weights and inputs: the discriminators' logits and
every feature map, each loss, the `GANVocCollator` batches, the
discriminator weight bridge key for key, and a port-written generator
loaded by the JAX package's official-file loader
(tests/test_torch_gan_train_step.py holds one training step).

Tolerances: logits and feature maps atol 1e-4 (the teacher-forced bar of
docs/benchmarks.md); losses rtol 1e-5; waveforms atol 1e-4.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

HOP, N_MELS, SEG_LEN = 256, 20, 1024
TINY_HIFI = {'generator_type': 'hifigan', 'resblock': '1',
             'upsample_rates': [8, 8, 2, 2],
             'upsample_kernel_sizes': [16, 16, 4, 4],
             'upsample_initial_channel': 32, 'resblock_kernel_sizes': [3],
             'resblock_dilation_sizes': [[1, 3]]}
DSP_CFG = dict(n_fft=1024, win_length=1024, hop_length=HOP,
               num_mels=N_MELS, sample_rate=22050, fmin=0, fmax=8000)


def _audio(seed, batch=2, length=SEG_LEN):
    rng = np.random.RandomState(seed)
    t = np.arange(length) / 22050.0
    y = 0.5 * np.sin(2 * np.pi * rng.uniform(100, 400, (batch, 1)) * t)
    return (y + 0.05 * rng.randn(batch, length)).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _jax_disc():
    """The JAX discriminators, their variables and one jitted apply (one
    compile for every test of a worker)."""
    from forwardtacotron_tpu.models.gan_discriminators import (
        HiFiGANDiscriminators as JD)
    jdisc = JD()
    y = jnp.asarray(_audio(0))
    variables = jax.tree.map(np.asarray, jax.jit(jdisc.init)(
        jax.random.PRNGKey(0), y, y))
    return jdisc, variables, jax.jit(jdisc.apply)


def _disc_variables():
    return _jax_disc()[1]


def _discs():
    from forwardtacotron_tpu_torch.models.gan_discriminators import (
        HiFiGANDiscriminators)
    from forwardtacotron_tpu_torch.weights import discriminator_state_dict
    jdisc, variables, _ = _jax_disc()
    disc = HiFiGANDiscriminators()
    disc.load_state_dict(discriminator_state_dict(variables), strict=True)
    return jdisc, variables, disc


def _channels_last(f):
    return np.moveaxis(f.detach().numpy(), 1, -1)


def test_discriminator_weight_bridge_key_for_key():
    """Every parameter of the port's discriminators comes from exactly one
    JAX leaf of the same number of values, and every JAX leaf is used."""
    from forwardtacotron_tpu_torch.models.gan_discriminators import (
        HiFiGANDiscriminators)
    from forwardtacotron_tpu_torch.weights import discriminator_state_dict
    variables = _disc_variables()
    sd = discriminator_state_dict(variables)
    own = HiFiGANDiscriminators().state_dict()
    assert list(sd) == list(own)
    for k in own:
        assert sd[k].shape == own[k].shape and sd[k].dtype == torch.float32
    leaves = jax.tree.leaves(variables['params'])
    assert len(leaves) == len(sd) == 5 * 12 + 3 * 16
    assert sorted(v.size for v in leaves) == sorted(v.numel()
                                                    for v in sd.values())
    wrapped = discriminator_state_dict(
        {'params': {'discriminator': variables['params'], 'generator': {}}})
    assert all(torch.equal(wrapped[k], sd[k]) for k in sd)


def test_discriminator_logits_and_feature_maps_match_jax():
    jdisc, variables, disc = _discs()
    y, y_hat = _audio(1), _audio(2)
    ref = _jax_disc()[2](variables, jnp.asarray(y), jnp.asarray(y_hat))
    with torch.no_grad():
        out = disc(torch.from_numpy(y), torch.from_numpy(y_hat))
    assert len(out[0]) == len(ref[0]) == 8
    for got, want in zip(out[0] + out[1], ref[0] + ref[1]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    n_maps = 0
    for got_list, want_list in zip(out[2] + out[3], ref[2] + ref[3]):
        assert len(got_list) == len(want_list)
        for got, want in zip(got_list, want_list):
            got = _channels_last(got)
            assert got.shape == np.asarray(want).shape
            np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
            n_maps += 1
    assert n_maps == 2 * (5 * 6 + 3 * 8)


def _wav_to_mel_pair():
    """The JAX package's jitted log-mel and the port's differentiable one,
    on the same filterbank."""
    from forwardtacotron_tpu.dsp.stft import wav_to_mel_fn
    from forwardtacotron_tpu_torch.dsp import stft
    basis = stft.mel_filterbank(22050, 1024, N_MELS, 0, 8000)
    jfn = wav_to_mel_fn(basis, 1024, HOP, 1024)
    tbasis = torch.from_numpy(basis)
    return jfn, lambda y: stft.wav_to_mel(y, tbasis, 1024, HOP, 1024)


def test_gan_losses_match_jax():
    from forwardtacotron_tpu.train import gan_losses as jl
    from forwardtacotron_tpu_torch.train import gan_losses as tl
    jdisc, variables, disc = _discs()
    y, y_hat = _audio(3), _audio(4)
    lr_, lg_, fr, fg = _jax_disc()[2](variables, jnp.asarray(y),
                                      jnp.asarray(y_hat))
    with torch.no_grad():
        tlr, tlg, tfr, tfg = disc(torch.from_numpy(y),
                                  torch.from_numpy(y_hat))
    jfn, tfn = _wav_to_mel_pair()
    pairs = [
        (tl.discriminator_loss(tlr, tlg), jl.discriminator_loss(lr_, lg_)),
        (tl.generator_adversarial_loss(tlg),
         jl.generator_adversarial_loss(lg_)),
        (tl.feature_matching_loss(tfr, tfg),
         jl.feature_matching_loss(fr, fg)),
        (tl.mel_l1_loss(tfn, torch.from_numpy(y), torch.from_numpy(y_hat)),
         jl.mel_l1_loss(jfn, jnp.asarray(y), jnp.asarray(y_hat)))]
    for i, (got, want) in enumerate(pairs):
        assert float(want) > 0
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   err_msg=str(i))


# ---------------------------------------------------------- data and files

def _make_gan_dataset(data, n_items=10, n_val=3, seed=0):
    """Items of 4-30 mel frames with 9-bit mu-law labels of frames * HOP
    samples; item 1 has no whole frame of audio (a clip the collator
    drops) and several are shorter than one window (repeat-padded)."""
    from forwardtacotron_tpu_torch.utils.files import pickle_binary
    rng = np.random.RandomState(seed)
    for d in ('mel', 'quant'):
        (data / d).mkdir(parents=True, exist_ok=True)
    index = []
    for i in range(n_items):
        frames = int(rng.randint(4, 31))
        n_samples = HOP - 1 if i == 1 else frames * HOP
        np.save(data / 'mel' / f'{i}.npy',
                (rng.randn(N_MELS, frames) - 3).astype(np.float32))
        np.save(data / 'quant' / f'{i}.npy',
                rng.randint(0, 512, n_samples).astype(np.int64))
        index.append((str(i), frames))
    pickle_binary(index[:-n_val], data / 'train_dataset.pkl')
    pickle_binary(index[-n_val:], data / 'val_dataset.pkl')
    return data


@pytest.mark.parametrize('voc_mode,mu_law', [('RAW', True), ('RAW', False),
                                             ('MOL', False)])
def test_gan_batches_equal_jax(tmp_path, voc_mode, mu_law):
    """`GANVocCollator` through `get_gan_vocoder_datasets`: the JAX
    package's crops and decoded audio, batch for batch, with the repeat-pad
    of short clips and the refill of dropped ones; the port's batches also
    report each row's item and crop offset
    (tests/test_torch_gan_bench.py reads the files at them)."""
    from forwardtacotron_tpu.data import dataset as jds
    from forwardtacotron_tpu_torch.data import dataset as tds
    data = _make_gan_dataset(tmp_path / 'data')
    kw = dict(path=data, batch_size=3, train_gta=False, max_mel_len=30,
              hop_length=HOP, seg_len=SEG_LEN, voc_mode=voc_mode, bits=9,
              mu_law=mu_law, num_gen_samples=2)
    train, val, samples = tds.get_gan_vocoder_datasets(**kw)
    jtrain, jval, jsamples = jds.get_gan_vocoder_datasets(**kw)
    assert len(train) == len(jtrain) == 2
    for epoch, start in ((0, 0), (1, 1), (3, 0)):
        got = list(train.batches(epoch, start))
        want = list(jtrain.batches(epoch, start))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert set(b) == {'mel', 'audio'}
            assert set(a) == {'mel', 'audio', 'index', 'offset'}
            assert a['mel'].shape == (3, SEG_LEN // HOP, N_MELS)
            assert a['index'].shape == a['offset'].shape == (3,)
            for k in b:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len(val) == len(jval) == 1
    for k in jval[0]:
        np.testing.assert_array_equal(val[0][k], jval[0][k])
    assert [s['item_id'] for s in samples] == \
        [s['item_id'] for s in jsamples]
    with pytest.raises(ValueError, match='empty'):
        tds.GANVocCollator(HOP, SEG_LEN, voc_mode, 9, mu_law)(
            [{'mel': np.zeros((N_MELS, 3)), 'x': np.zeros(HOP - 1)}])


def test_port_generator_loads_in_jax(tmp_path):
    """A generator file written by the port's trainer, read by the JAX
    package's official-file loader, vocodes as the port does."""
    from forwardtacotron_tpu.models.hifigan import load_hifigan as jload
    from forwardtacotron_tpu.models.hifigan import vocode_hifigan as jvoc
    from forwardtacotron_tpu_torch.models.hifigan import (load_hifigan,
                                                          make_generator,
                                                          vocode_hifigan)
    from forwardtacotron_tpu_torch.train.hifigan_trainer import (
        HiFiGANTrainer, generator_file)
    from forwardtacotron_tpu_torch.utils.checkpoints import save_payload
    from forwardtacotron_tpu_torch.utils.paths import Paths
    from forwardtacotron_tpu_torch.config import default_config
    cfg = default_config()
    cfg['dsp'].update(DSP_CFG)
    cfg['hifigan']['model'] = dict(TINY_HIFI)
    paths = Paths(str(tmp_path / 'data'), 't', base=tmp_path, voc_id='v')
    HiFiGANTrainer(paths, None, cfg, 'cpu')       # writes config.json
    torch.manual_seed(2)
    gen = make_generator(cfg)
    path = paths.hifigan_checkpoints / 'g.pt'
    save_payload(generator_file(gen), path)
    mel = np.random.RandomState(7).randn(N_MELS, 13).astype(np.float32) - 3
    ours = vocode_hifigan(load_hifigan(path, device='cpu'), mel,
                          frame_bucket=8)
    np.testing.assert_array_equal(ours, vocode_hifigan(gen, mel,
                                                       frame_bucket=8))
    jmodel, jvars = jload(path)
    ref = jvoc(jmodel, jvars, mel, frame_bucket=8)
    assert ours.shape == ref.shape == (13 * HOP,)
    np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-4)
