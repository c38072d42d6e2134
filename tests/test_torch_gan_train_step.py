"""One step of the port's GAN vocoder training on the CPU at a tiny width
against the JAX package's `build_gan_train_step`, same weights and
inputs: the discriminators on a detached generation, then the generator
against the updated discriminators, each with AdamW.

Tolerances: losses rtol 1e-5; gradients as
`test_gan_train_step_matches_jax` says; parameters after one AdamW step
as tests/test_torch_forward_train.py holds Adam's, within 1e-6 where the
gradient's sign is decided and within 2 lr elsewhere (`_check_adamw`).
"""
import functools

import numpy as np

import jax
import jax.numpy as jnp
import torch

from test_torch_gan_train import (HOP, N_MELS, SEG_LEN, TINY_HIFI, _audio,
                                  _wav_to_mel_pair)

# two periods and two scales: the step's order and gradients do not depend
# on how many sub-discriminators there are (tests/test_torch_gan_train.py
# holds the full set's logits and feature maps), and a smaller graph
# halves the JAX step's trace and compile
PERIODS, N_SCALES = (2, 3), 2


@functools.lru_cache(maxsize=1)
def _jax_discs():
    """The JAX discriminators at PERIODS and N_SCALES and their variables
    (one init for the tests of a worker)."""
    from forwardtacotron_tpu.models.gan_discriminators import (
        HiFiGANDiscriminators as JD)
    jdisc = JD(periods=PERIODS, n_scales=N_SCALES)
    y = jnp.asarray(_audio(0))
    return jdisc, jax.tree.map(np.asarray, jax.jit(jdisc.init)(
        jax.random.PRNGKey(0), y, y))


def _discs():
    """`_jax_discs()` and the port's discriminators with the same
    weights."""
    from forwardtacotron_tpu_torch.models.gan_discriminators import (
        HiFiGANDiscriminators)
    jdisc, variables = _jax_discs()
    disc = HiFiGANDiscriminators(PERIODS, N_SCALES)
    disc.load_state_dict(_disc_state(variables), strict=True)
    return jdisc, variables, disc


def _disc_state(variables):
    from forwardtacotron_tpu_torch.weights import discriminator_state_dict
    return discriminator_state_dict(variables, PERIODS, N_SCALES)


def _inputs():
    rng = np.random.RandomState(5)
    mel = (rng.randn(2, SEG_LEN // HOP, N_MELS) - 3).astype(np.float32)
    return mel, _audio(6)


@functools.lru_cache(maxsize=1)
def _gen_variables():
    """The JAX generator and its variables (one init for the tests of a
    worker)."""
    from forwardtacotron_tpu.models.hifigan import HiFiGANGenerator as JG
    jgen = JG.from_config(TINY_HIFI)
    return jgen, jax.tree.map(np.asarray, jax.jit(jgen.init)(
        jax.random.PRNGKey(1), jnp.asarray(_inputs()[0])))


def _adamw_mu(state):
    """The first moment of optax's injected adamw state."""
    if hasattr(state, 'mu'):
        return state.mu
    for s in (state.inner_state if hasattr(state, 'inner_state')
              else state if isinstance(state, tuple) else ()):
        mu = _adamw_mu(s)
        if mu is not None:
            return mu
    return None


def _check_adamw(got_params, want_params, want_grads, lr, what):
    """After one AdamW step every parameter moved by lr * g / (|g| + eps)
    plus the same decay, so the two agree within 1e-6 wherever the
    gradient's sign is decided, and within 2 lr elsewhere. Decided: |g|
    above 1e-4 and above 1e-3 of its tensor's largest |g| (the generator's
    gradients reach ~500 under the x45 mel loss, and float32 sums of terms
    that large carry absolute errors near 1e-4)."""
    assert len(got_params) > 10
    n_decided = n_values = 0
    for k, p in got_params.items():
        g = want_grads[k].numpy()
        delta = np.abs(p.detach().numpy() - want_params[k].numpy())
        assert delta.max() <= 2 * lr + 1e-6, f'{what} {k}'
        decided = np.abs(g) > max(1e-4, 1e-3 * np.abs(g).max())
        assert np.all(delta[decided] <= 1e-6), f'{what} {k}'
        n_decided, n_values = n_decided + decided.sum(), n_values + g.size
    assert n_decided > 0.25 * n_values, what


def _linear_mel_pair():
    """A fixed linear map of each hop of samples to N_MELS values, the same
    in both frameworks: the mel term without the float32 STFT."""
    w = (np.random.RandomState(7).randn(HOP, N_MELS) / np.sqrt(HOP)).astype(
        np.float32)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    return (lambda y: y.reshape(y.shape[0], -1, HOP) @ jw,
            lambda y: y.reshape(y.shape[0], -1, HOP) @ tw)


CONFIG = {'dsp': {'num_mels': N_MELS}, 'hifigan': {'model': TINY_HIFI}}


def _port_generator(gvars):
    from forwardtacotron_tpu_torch.models.hifigan import make_generator
    from forwardtacotron_tpu_torch.weights import hifigan_state_dict
    gen = make_generator(CONFIG)
    gen.load_state_dict(hifigan_state_dict(gvars, CONFIG), strict=True)
    return gen


def test_gan_train_step_matches_jax():
    """One step: the discriminators on a detached generation, then the
    generator against the updated discriminators, each with AdamW, against
    the JAX package's `build_gan_train_step`: the losses, both nets'
    gradients (JAX's rebuilt from AdamW's first moment, 0.2 g) and the
    parameters after the step.

    The discriminators' gradients agree element for element (rtol 5e-4,
    atol 5e-5, as the WaveRNN step's). The generator's mel term, through
    the log-mel of the STFT, is ~1e4 times the other terms' gradient and
    passes 1 / |X| of the quietest bins, where the two float32 STFTs
    differ by ~3e-4 in the log: each generator tensor is held to a
    relative L2 error of 2e-3 (measured up to 4.8e-4), and
    `test_gan_generator_gradient_matches_jax` holds every term element for
    element. The generator's gradient is taken against the discriminators
    as JAX updated them: the port's own differ by up to 2 lr where the
    sign of a first AdamW step is not decided."""
    from forwardtacotron_tpu.train import hifigan_trainer as jht
    from forwardtacotron_tpu_torch.train.hifigan_trainer import (
        gan_train_step, gen_step, make_gan_optimizer)
    from forwardtacotron_tpu_torch.weights import hifigan_state_dict
    mel, y = _inputs()
    jgen, gvars = _gen_variables()
    jdisc, dvars, disc = _discs()
    lr = 1e-3
    gopt, dopt = jht.make_gan_optimizer(lr), jht.make_gan_optimizer(lr)
    state = jht.GANTrainState(
        gen_params=gvars['params'], disc_params=dvars['params'],
        gen_opt=jax.jit(gopt.init)(gvars['params']),
        disc_opt=jax.jit(dopt.init)(dvars['params']), step=jnp.asarray(0))
    jfn, tfn = _wav_to_mel_pair()
    step = jht.build_gan_train_step(jgen, jdisc, gopt, dopt, jfn)
    new_state, ref = step(state, {'mel': jnp.asarray(mel),
                                  'audio': jnp.asarray(y)})

    gen = _port_generator(gvars)
    tgopt = make_gan_optimizer(gen, lr)
    tdopt = make_gan_optimizer(disc, lr)
    metrics = gan_train_step(gen, disc, tgopt, tdopt, {
        'mel': torch.from_numpy(mel), 'audio': torch.from_numpy(y)}, tfn)
    for k in ('disc_loss', 'gen_loss', 'gen_adv', 'gen_fm', 'gen_mel'):
        np.testing.assert_allclose(float(metrics[k]), float(ref[k]),
                                   rtol=1e-5, err_msg=k)

    def grads(opt_state):
        return jax.tree.map(lambda m: np.asarray(m) / 0.2,
                            _adamw_mu(opt_state))
    gen_grads = hifigan_state_dict({'params': grads(new_state.gen_opt)},
                                   CONFIG)
    disc_grads = _disc_state({'params': grads(new_state.disc_opt)})
    for k, p in disc.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), disc_grads[k].numpy(),
                                   rtol=5e-4, atol=5e-5, err_msg=k)
    _check_adamw(dict(gen.named_parameters()),
                 hifigan_state_dict({'params': new_state.gen_params}, CONFIG),
                 gen_grads, lr, 'generator')
    _check_adamw(dict(disc.named_parameters()),
                 _disc_state({'params': new_state.disc_params}),
                 disc_grads, lr, 'discriminators')

    gen = _port_generator(gvars)
    disc.load_state_dict(_disc_state({'params': new_state.disc_params}),
                         strict=True)
    gen_step(gen, disc, make_gan_optimizer(gen, lr),
             torch.from_numpy(mel).transpose(1, 2), torch.from_numpy(y), tfn)
    for k, p in gen.named_parameters():
        want = gen_grads[k].numpy()
        assert (np.linalg.norm(p.grad.numpy() - want)
                <= 2e-3 * np.linalg.norm(want)), k


def test_gan_generator_gradient_matches_jax():
    """The generator's gradient from the port's `gen_step` against
    `jax.grad` of the generator's half of `build_gan_train_step` (its
    `g_loss_fn`: adversarial + feature matching + mel L1 against fixed
    discriminators), element for element (rtol 5e-4, atol 5e-5), with the
    mel term over a linear map in place of the log-mel, so that no term's
    gradient hides under another's."""
    from forwardtacotron_tpu.train import gan_losses as jl
    from forwardtacotron_tpu_torch.train.hifigan_trainer import (
        gen_step, make_gan_optimizer)
    from forwardtacotron_tpu_torch.weights import hifigan_state_dict
    mel, y = _inputs()
    jgen, gvars = _gen_variables()
    jdisc, dvars, disc = _discs()
    jfn, tfn = _linear_mel_pair()
    y_j = jnp.asarray(y)

    @jax.jit
    def g_grad(gp):
        def g_loss(gp):
            y_hat = jgen.apply({'params': gp}, jnp.asarray(mel))
            _, lg, fr, fg = jdisc.apply(dvars, y_j, y_hat)
            return (jl.generator_adversarial_loss(lg)
                    + jl.feature_matching_loss(fr, fg)
                    + jl.mel_l1_loss(jfn, y_j, y_hat))
        return jax.grad(g_loss)(gp)

    want = hifigan_state_dict(
        {'params': jax.tree.map(np.asarray, g_grad(gvars['params']))},
        CONFIG)
    gen = _port_generator(gvars)
    gen_step(gen, disc, make_gan_optimizer(gen, 1e-3),
             torch.from_numpy(mel).transpose(1, 2), torch.from_numpy(y), tfn)
    assert all(p.grad is None for p in disc.parameters())
    for k, p in gen.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   rtol=5e-4, atol=5e-5, err_msg=k)
