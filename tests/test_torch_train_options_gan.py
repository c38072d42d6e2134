"""The GAN vocoders' bf16 step on the CPU against the JAX package's
`build_gan_train_step` at a tiny width, in the c-relative form of
tests/test_torch_train_options.py (its module docstring).
"""
import numpy as np

import jax
import jax.numpy as jnp
import torch

from test_torch_gan_train_step import (CONFIG, _adamw_mu, _disc_state,
                                       _discs, _gen_variables, _inputs,
                                       _linear_mel_pair, _port_generator)
from test_torch_train_options import LR, _check_c_relative, _one_thread

__all__ = ['_one_thread']       # the autouse fixture


def _gan_jax(train_cfg):
    from forwardtacotron_tpu.train import hifigan_trainer as jht
    from forwardtacotron_tpu_torch.weights import hifigan_state_dict
    mel, y = _inputs()
    jgen, gvars = _gen_variables()
    jdisc, dvars, _ = _discs()
    gopt, dopt = jht.make_gan_optimizer(LR), jht.make_gan_optimizer(LR)
    state = jht.GANTrainState(
        gen_params=gvars['params'], disc_params=dvars['params'],
        gen_opt=jax.jit(gopt.init)(gvars['params']),
        disc_opt=jax.jit(dopt.init)(dvars['params']), step=jnp.asarray(0))
    step = jht.build_gan_train_step(jgen, jdisc, gopt, dopt,
                                    _linear_mel_pair()[0], train_cfg)
    new_state, metrics = step(state, {'mel': jnp.asarray(mel),
                                      'audio': jnp.asarray(y)})

    def grads(opt_state):
        return jax.tree.map(lambda m: np.asarray(m) / 0.2,
                            _adamw_mu(opt_state))
    gen_grads = hifigan_state_dict({'params': grads(new_state.gen_opt)},
                                   CONFIG)
    disc_grads = _disc_state({'params': grads(new_state.disc_opt)})
    return ({k: v.numpy() for k, v in gen_grads.items()},
            {k: v.numpy() for k, v in disc_grads.items()},
            {k: float(v) for k, v in metrics.items()}, new_state)


def test_gan_bf16_step_matches_jax_bf16():
    """A bf16 D-then-G step against JAX's bf16 `build_gan_train_step`: the
    discriminators' gradients from the whole step, the generator's from
    `gen_step` against the discriminators as JAX's bf16 step updated them,
    each in the c-relative form; the losses are float32 and finite."""
    from forwardtacotron_tpu_torch.train.hifigan_trainer import (
        gan_train_step, gen_step, make_gan_optimizer)
    mel, y = _inputs()
    _, gvars = _gen_variables()
    bf16 = {'precision': 'bf16'}
    ref16, ref32 = _gan_jax(bf16), _gan_jax({})
    tfn = _linear_mel_pair()[1]
    gen = _port_generator(gvars)
    disc = _discs()[2]
    metrics = gan_train_step(
        gen, disc, make_gan_optimizer(gen, LR), make_gan_optimizer(disc, LR),
        {'mel': torch.from_numpy(mel), 'audio': torch.from_numpy(y)}, tfn,
        torch.bfloat16)
    disc_grads = {k: p.grad.numpy() for k, p in disc.named_parameters()}
    _check_c_relative(disc_grads, ref16[1], ref32[1], 'discriminators')
    for k, v in metrics.items():
        assert v.dtype == torch.float32 and torch.isfinite(v), k
        np.testing.assert_allclose(float(v), ref16[2][k], rtol=5e-2,
                                   err_msg=k)

    disc.load_state_dict(_disc_state({'params': ref16[3].disc_params}),
                         strict=True)
    gen_grads = {}
    for half in (torch.bfloat16, None):
        gen = _port_generator(gvars)
        gen_step(gen, disc, make_gan_optimizer(gen, LR),
                 torch.from_numpy(mel).transpose(1, 2), torch.from_numpy(y),
                 tfn, half)
        gen_grads[half] = {k: p.grad.numpy()
                           for k, p in gen.named_parameters()}
    # JAX's float32 generator gradient is taken against discriminators
    # its float32 step updated, so the port's own float32 gradient against
    # the same discriminators is the float32 result to stand apart from
    _check_c_relative(gen_grads[torch.bfloat16], ref16[0], ref32[0],
                      'generator', port32=gen_grads[None])
