"""The GAN pair's optimizer states carried over from a JAX `.fjax`, as
tests/test_torch_optim_state.py carries the other trainers' (its module
docstring gives the flow and the tolerances): the generator's and the
discriminators' AdamW states, flattened together as the JAX GAN trainer
saves them, restored in the CLI's order; the parameters after a third
D-then-G step held as tests/test_torch_gan_train_step.py's
`_check_adamw` holds AdamW's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_optim_state import (BAR, LR, _adam_state, _check_bar,
                                    _check_moments, _deltas, _loaded, _np,
                                    _one_thread, _worst)

__all__ = ['_one_thread']       # the autouse fixture


def test_gan_pair_resumes_both_adamw_states(tmp_path):
    """The generator's and the discriminators' AdamW states, flattened
    together as the JAX GAN trainer saves them, in the CLI's order; the
    mel term through a fixed linear map, as
    tests/test_torch_train_options_gan.py steps the pair."""
    import test_torch_gan_train as gt
    import test_torch_gan_train_step as gs
    from forwardtacotron_tpu.train import hifigan_trainer as jht
    from forwardtacotron_tpu.utils.checkpoints import save_checkpoint
    from forwardtacotron_tpu_torch.train.hifigan_trainer import (
        gan_train_step, make_gan_optimizer)
    from forwardtacotron_tpu_torch.weights import (ADAMW_HYPERPARAMS,
                                                   hifigan_state_dict,
                                                   load_fjax,
                                                   load_optimizer_state)
    jgen, gvars = gs._gen_variables()
    jdisc, dvars, _ = gs._discs()
    rng = np.random.RandomState(11)
    batches = [((rng.randn(2, gt.SEG_LEN // gt.HOP, gt.N_MELS) - 3)
                .astype(np.float32), gt._audio(20 + i)) for i in range(3)]
    gopt, dopt = jht.make_gan_optimizer(LR), jht.make_gan_optimizer(LR)
    state = jht.GANTrainState(
        gen_params=gvars['params'], disc_params=dvars['params'],
        gen_opt=jax.jit(gopt.init)(gvars['params']),
        disc_opt=jax.jit(dopt.init)(dvars['params']), step=jnp.asarray(0))
    jfn, tfn = gs._linear_mel_pair()
    step = jht.build_gan_train_step(jgen, jdisc, gopt, dopt, jfn)

    def jax_step(s, i):
        mel, y = batches[i]
        return step(s, {'mel': jnp.asarray(mel), 'audio': jnp.asarray(y)})[0]
    for i in (0, 1):
        state = jax_step(state, i)
    path = tmp_path / 'latest_model.fjax'
    save_checkpoint({'params': {'generator': _np(state.gen_params),
                                'discriminator': _np(state.disc_params)}},
                    gs.CONFIG, path, opt_state=(state.gen_opt,
                                                state.disc_opt), step=2)
    saved = _np((state.gen_opt, state.disc_opt))   # the step donates state
    ref = jax_step(state, 2)

    def gen_sd(v):
        return hifigan_state_dict(v, gs.CONFIG)

    def pair(payload, carry):
        params = payload['model']['params']
        gen = _loaded(gs._port_generator(gvars), gen_sd(
            {'params': params['generator']}))
        disc = _loaded(gs._discs()[2], gs._disc_state(
            {'params': params['discriminator']}))
        tg, td = make_gan_optimizer(gen, LR), make_gan_optimizer(disc, LR)
        entries = [(tg, gen, {'params': params['generator']}, gen_sd),
                   (td, disc, {'params': params['discriminator']},
                    gs._disc_state)]
        if carry:
            assert load_optimizer_state(payload, entries, ADAMW_HYPERPARAMS)
        mel, y = batches[2]
        return entries, lambda: gan_train_step(
            gen, disc, tg, td, {'mel': torch.from_numpy(mel),
                                'audio': torch.from_numpy(y)}, tfn)

    payload = load_fjax(path, use_ema=False)
    entries, run = pair(payload, carry=True)
    for (opt, model, variables, to_sd), jopt in zip(
            entries, saved):
        _check_moments(opt, model, _adam_state(jopt), variables, to_sd)
    run()
    want = [gen_sd({'params': _np(ref.gen_params)}),
            gs._disc_state({'params': _np(ref.disc_params)})]
    for (_, model, _, _), w in zip(entries, want):
        _check_bar(_deltas(model, w), relative=True)

    entries, run = pair(payload, carry=False)
    run()
    assert max(_worst(_deltas(e[1], w), relative=True)
               for e, w in zip(entries, want)) > 100 * BAR
