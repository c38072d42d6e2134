"""The optimizer state a JAX `.fjax` carries, taken over by the port
(`weights.py:load_optimizer_state`), for every trainer: the student
(ForwardTacotron and FastPitch), the Tacotron teacher, WaveRNN and the
aligner (the GAN pair: tests/test_torch_optim_state_gan.py). JAX trains 2 steps on two batches and writes the file
with `save_checkpoint`, as its trainers do; the port loads the weights
and the state, and one more step on a third batch runs in both.

Tolerances: the carried moments equal optax's mu / nu through each
parameter's weight map exactly, and `step` equals Adam's count; the
parameters after the third step as tests/test_torch_forward_train.py holds
those after one step, within 1e-6 where |g| > 1e-4 and within 2 lr
elsewhere (the GAN pair as tests/test_torch_gan_train_step.py's
`_check_adamw` holds AdamW's, which also asks |g| > 1e-3 of its tensor's
largest). A fresh Adam's third step, lr * sign(g) where the carried one is
lr * m_hat / sqrt(v_hat), misses that bar by far on the same inputs.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_train_options_teacher import keep_all

__all__ = ['keep_all']          # the fixture

LR, CLIP = 1e-3, 0.05
BAR = 1e-6


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """The recurrences' plain versions and the teacher's decoder are loops
    of small ops: one intra-op thread leaves the other workers their
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _adam_state(state):
    """optax's ScaleByAdamState inside a JAX trainer's optimizer state."""
    if hasattr(state, 'mu'):
        return state
    for s in (state.inner_state if hasattr(state, 'inner_state')
              else state if isinstance(state, tuple) else ()):
        found = _adam_state(s)
        if found is not None:
            return found
    return None


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _check_moments(opt, model, adam, variables, to_sd):
    """The carried state against optax's own, through the weight map."""
    want = {k: to_sd(dict(variables, params=_np(getattr(adam, k))))
            for k in ('mu', 'nu')}
    named = dict(model.named_parameters())
    assert len(named) > 5
    for name, p in named.items():
        st = opt.state[p]
        assert float(st['step']) == int(adam.count) == 2, name
        assert torch.equal(st['exp_avg'], want['mu'][name].reshape(p.shape))
        assert torch.equal(st['exp_avg_sq'],
                           want['nu'][name].reshape(p.shape)), name


def _deltas(model, want):
    """|port - JAX| of every parameter after the step, with the port's
    clipped gradient of that step."""
    return {k: (np.abs(p.detach().numpy() - want[k].numpy()),
                p.grad.numpy()) for k, p in model.named_parameters()}


def _decided(g, relative):
    floor = max(1e-4, 1e-3 * np.abs(g).max()) if relative else 1e-4
    return np.abs(g) > floor


def _check_bar(deltas, relative=False):
    for k, (delta, g) in deltas.items():
        assert delta.max() <= 2 * LR + 1e-6, k
        assert np.all(delta[_decided(g, relative)] <= BAR), \
            (k, float(delta[_decided(g, relative)].max()))


def _worst(deltas, relative=False):
    return max(float(d[_decided(g, relative)].max(initial=0.0))
               for d, g in deltas.values())


def _carry_over(case, tmp_path):
    """JAX: two steps, the `.fjax`, a third step. The port: the file's
    weights and optimizer state, the third step; and a fresh Adam's."""
    from forwardtacotron_tpu.utils.checkpoints import save_checkpoint
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.weights import (load_fjax,
                                                   load_optimizer_state)
    state = case['state']
    for i in (0, 1):
        state = case['jax_step'](state, i)
    path = tmp_path / 'latest_model.fjax'
    save_checkpoint(_np(state.variables), {'tiny': True}, path,
                    opt_state=state.opt_state, step=2)
    ref = case['jax_step'](state, 2)
    want = case['to_sd'](_np(ref.variables))

    payload = load_fjax(path, use_ema=False)
    to_sd, variables = case['to_sd'], payload['model']
    model = case['model'](to_sd(variables))
    opt = tc.make_optimizer(model, lr=LR)
    assert load_optimizer_state(payload, [(opt, model, variables, to_sd)])
    _check_moments(opt, model, _adam_state(state.opt_state), variables,
                   to_sd)
    case['port_step'](model, opt)
    _check_bar(_deltas(model, want))

    fresh = case['model'](to_sd(variables))
    case['port_step'](fresh, tc.make_optimizer(fresh, lr=LR))
    assert _worst(_deltas(fresh, want)) > 100 * BAR


def _train_state(variables, optimizer):
    from forwardtacotron_tpu.train import common as jtc
    return jtc.TrainState(params=variables['params'],
                          batch_stats=variables.get('batch_stats', {}),
                          opt_state=optimizer.init(variables['params']),
                          step=jnp.asarray(0, jnp.int32))


def _student_case(kind):
    from forwardtacotron_tpu.train import common as jtc
    from forwardtacotron_tpu_torch.train import common as tc
    if kind == 'forward_tacotron':
        import test_torch_forward_train as ft
        jmodel, variables, _ = ft._models(ft.NO_DROPOUT)
        batches = [ft._batch(10 + i) for i in range(3)]
        train_cfg = ft.TRAIN_CFG

        def to_sd(v):
            return ft._state_dict_of(v, ft.NO_DROPOUT)

        def model(sd):
            m = ft._models(ft.NO_DROPOUT)[2]
            m.load_state_dict(sd, strict=True)
            return m
    else:
        import test_torch_fast_pitch as fp
        from forwardtacotron_tpu_torch.weights import fast_pitch_state_dict
        jmodel, variables = fp._jax_model(fp.NO_DROPOUT), fp._variables('nd')
        batches = [fp._batch(10 + i) for i in range(3)]
        train_cfg = dict(fp.TRAIN_CFG, clip_grad_norm=CLIP)

        def to_sd(v):
            return fast_pitch_state_dict(v, fp.NO_DROPOUT)

        def model(sd):
            return _loaded(fp._port_model(fp.NO_DROPOUT), sd)
    optimizer = jtc.make_optimizer(train_cfg['clip_grad_norm'], lr=LR)
    step = jax.jit(jtc.build_forward_train_step(jmodel, optimizer,
                                                train_cfg))

    def jax_step(state, i):
        b = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64
                            else v) for k, v in batches[i].items()}
        return step(state, b, jax.random.PRNGKey(i))[0]

    def port_step(m, opt):
        tc.train_step(m, opt, {k: torch.from_numpy(v)
                               for k, v in batches[2].items()},
                      torch.Generator().manual_seed(0), train_cfg)
    return {'state': _train_state(variables, optimizer),
            'jax_step': jax_step, 'to_sd': to_sd, 'model': model,
            'port_step': port_step}


def _loaded(model, sd):
    model.load_state_dict(sd, strict=True)
    return model


@pytest.mark.parametrize('kind', ['forward_tacotron', 'fast_pitch'])
def test_student_resumes_jax_optimizer_state(kind, tmp_path):
    _carry_over(_student_case(kind), tmp_path)


def test_teacher_resumes_jax_optimizer_state(keep_all, tmp_path):
    """At r=2 with every dropout keeping (`keep_all`), as
    tests/test_torch_train_options_teacher.py steps the teacher."""
    import test_torch_tacotron as taco
    from forwardtacotron_tpu.train import common as jtc
    from forwardtacotron_tpu.train.taco_trainer import build_taco_train_step
    from forwardtacotron_tpu_torch.train.taco_trainer import taco_train_step
    from forwardtacotron_tpu_torch.weights import tacotron_state_dict
    r = 2
    batches = [taco._batch(10 + i) for i in range(3)]
    optimizer = jtc.make_optimizer(CLIP, lr=LR)
    step = jax.jit(build_taco_train_step(taco._jax_model(), optimizer, r,
                                         {}))

    def jax_step(state, i):
        x, mel = batches[i]
        return step(state, {'x': jnp.asarray(x), 'mel': jnp.asarray(mel)},
                    jax.random.PRNGKey(i))[0]

    def port_step(m, opt):
        x, mel = batches[2]
        taco_train_step(m, opt, {'x': torch.from_numpy(x),
                                 'mel': torch.from_numpy(mel)}, r,
                        torch.Generator().manual_seed(0),
                        {'clip_grad_norm': CLIP})
    _carry_over({'state': _train_state(taco._variables(), optimizer),
                 'jax_step': jax_step,
                 'to_sd': lambda v: tacotron_state_dict(v, taco.CFG),
                 'model': lambda sd: _loaded(taco._port_model(), sd),
                 'port_step': port_step}, tmp_path)


def test_wavernn_resumes_jax_optimizer_state(tmp_path):
    import test_torch_voc_train as voc
    from forwardtacotron_tpu.train import common as jtc
    from forwardtacotron_tpu.train.voc_trainer import build_voc_train_step
    from forwardtacotron_tpu_torch.train.voc_trainer import voc_train_step
    mode = 'RAW'
    jmodel, variables, _ = voc._models(mode)
    batches = [voc._inputs(mode, 10 + i) for i in range(3)]
    optimizer = jtc.make_optimizer(CLIP, lr=LR)
    step = jax.jit(build_voc_train_step(jmodel, optimizer, mode))

    def jax_step(state, i):
        x, mel, y = batches[i]
        return step(state, {'x': jnp.asarray(x), 'mel': jnp.asarray(mel),
                            'y': jnp.asarray(y)})[0]

    def port_step(m, opt):
        x, mel, y = batches[2]
        voc_train_step(m, opt, {'x': torch.from_numpy(x),
                                'mel': torch.from_numpy(mel),
                                'y': torch.from_numpy(y)}, mode, CLIP)
    _carry_over({'state': _train_state(variables, optimizer),
                 'jax_step': jax_step,
                 'to_sd': lambda v: voc._state_dict(v, mode),
                 'model': lambda sd: _loaded(voc._models(mode)[2], sd),
                 'port_step': port_step}, tmp_path)


@functools.lru_cache(maxsize=1)
def _aligner():
    """The aligner of tests/test_torch_aligner.py without dropout: (JAX
    model, numpy variables, config)."""
    import test_torch_aligner as al
    from forwardtacotron_tpu.align.aligner import Aligner as JaxAligner
    cfg = dict(al.CFG, dropout=0.0)
    jmodel = JaxAligner(**cfg)
    x, mel = al._inputs()
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(mel), jnp.asarray(al.X_LEN),
                            jnp.asarray(al.MEL_LEN))
    return jmodel, {'params': _np(variables['params'])}, cfg


def test_aligner_resumes_jax_optimizer_state(tmp_path):
    import test_torch_aligner as al
    from forwardtacotron_tpu.train import common as jtc
    from forwardtacotron_tpu.train.aligner_trainer import (
        build_aligner_train_step)
    from forwardtacotron_tpu_torch.align.aligner import Aligner
    from forwardtacotron_tpu_torch.train.aligner_trainer import (
        aligner_train_step)
    from forwardtacotron_tpu_torch.weights import aligner_state_dict
    jmodel, variables, cfg = _aligner()
    batches = [al._inputs(10 + i) for i in range(3)]
    lens = {'x_len': al.X_LEN, 'mel_len': al.MEL_LEN}
    optimizer = jtc.make_optimizer(CLIP, lr=LR)
    step = jax.jit(build_aligner_train_step(jmodel, optimizer))

    def jax_step(state, i):
        x, mel = batches[i]
        return step(state, {'x': jnp.asarray(x), 'mel': jnp.asarray(mel),
                            **{k: jnp.asarray(v) for k, v in lens.items()}},
                    jax.random.PRNGKey(i))[0]

    def port_step(m, opt):
        x, mel = batches[2]
        aligner_train_step(m, opt, {
            'x': torch.from_numpy(x), 'mel': torch.from_numpy(mel),
            **{k: torch.from_numpy(v) for k, v in lens.items()}},
            torch.Generator().manual_seed(0), CLIP)
    _carry_over({'state': _train_state(variables, optimizer),
                 'jax_step': jax_step, 'to_sd': aligner_state_dict,
                 'model': lambda sd: _loaded(Aligner(**cfg), sd),
                 'port_step': port_step}, tmp_path)


def test_mismatched_layout_raises(tmp_path):
    """A leaf count that is not the params tree's, AdamW leaves read as
    Adam's, a moment of another shape: each raises, naming what it
    found; a file without an optimizer state leaves Adam fresh."""
    from forwardtacotron_tpu.train import common as jtc
    from forwardtacotron_tpu.utils.checkpoints import save_checkpoint
    from forwardtacotron_tpu_torch.align.aligner import Aligner
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.weights import (ADAMW_HYPERPARAMS,
                                                   aligner_state_dict,
                                                   load_fjax,
                                                   load_optimizer_state,
                                                   split_optim_leaves)
    _, variables, cfg = _aligner()
    opt_state = jtc.make_optimizer(CLIP, lr=LR).init(variables['params'])
    path = tmp_path / 'a.fjax'
    save_checkpoint(variables, {}, path, opt_state=opt_state, step=0)
    payload = load_fjax(path)
    model = _loaded(Aligner(**cfg), aligner_state_dict(variables))
    opt = tc.make_optimizer(model, lr=LR)
    entry = [(opt, model, variables, aligner_state_dict)]
    n = len(payload['optim'])
    with pytest.raises(ValueError, match=f'{n - 1} vs {n} leaves'):
        load_optimizer_state(dict(payload, optim=payload['optim'][:-1]),
                             entry)
    with pytest.raises(ValueError, match=f'{n} vs {n + 1} leaves'):
        load_optimizer_state(payload, entry, ADAMW_HYPERPARAMS)
    leaves = list(payload['optim'])
    leaves[-1] = np.zeros(np.shape(leaves[-1])[:-1] + (1,), np.float32)
    with pytest.raises(ValueError, match='does not match at'):
        split_optim_leaves(leaves, [variables['params']])
    assert opt.state_dict()['state'] == {}
    save_checkpoint(variables, {}, path, step=3)
    assert not load_optimizer_state(load_fjax(path), entry)
    assert opt.state_dict()['state'] == {}


def _unique_tree(tree, start=0):
    """`tree` with every leaf element replaced by a distinct float64
    number, and the next unused one."""
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out[k], start = _unique_tree(tree[k], start)
        else:
            size = int(np.prod(np.shape(tree[k])))
            out[k] = np.arange(start, start + size, dtype=np.float64
                               ).reshape(np.shape(tree[k]))
            start += size
    return out, start


def test_every_parameter_map_is_a_permutation():
    """Every parameter of the port, through its converter, holds exactly
    the elements of one flax leaf, each once: the maps are transposes,
    flips and reshapes, so the moments carry over exactly. Checked with a
    distinct number in every element, for each converter the trainers
    use."""
    import test_torch_fast_pitch as fp
    import test_torch_forward_train as ft
    import test_torch_gan_train_step as gs
    import test_torch_tacotron as taco
    import test_torch_voc_train as voc
    from forwardtacotron_tpu_torch.weights import (aligner_state_dict,
                                                   fast_pitch_state_dict,
                                                   hifigan_state_dict,
                                                   tacotron_state_dict)
    cases = [
        ('forward_tacotron', ft._variables(),
         lambda v: ft._state_dict_of(v, ft.NO_DROPOUT),
         ft._models(ft.NO_DROPOUT)[2]),
        ('fast_pitch', fp._variables('nd'),
         lambda v: fast_pitch_state_dict(v, fp.NO_DROPOUT),
         fp._port_model(fp.NO_DROPOUT)),
        ('tacotron', taco._variables(),
         lambda v: tacotron_state_dict(v, taco.CFG), taco._port_model()),
        ('wavernn', voc._variables('RAW'),
         lambda v: voc._state_dict(v, 'RAW'), voc._models('RAW')[2]),
        ('aligner', _aligner()[1], aligner_state_dict,
         _aligner_port()),
        ('hifigan', gs._gen_variables()[1],
         lambda v: hifigan_state_dict(v, gs.CONFIG),
         gs._port_generator(gs._gen_variables()[1])),
        ('discriminators', gs._discs()[1], gs._disc_state, gs._discs()[2])]
    for what, variables, to_sd, model in cases:
        unique, total = _unique_tree(variables['params'])
        sizes = [int(np.prod(np.shape(leaf))) for leaf in
                 jax.tree.leaves(variables['params'])]
        starts = np.cumsum([0] + sizes)
        sd = to_sd(dict(variables, params=unique))
        covered = 0
        for name, p in model.named_parameters():
            v = np.sort(sd[name].numpy().ravel())
            leaf = np.searchsorted(starts, v[0], side='right') - 1
            want = np.arange(starts[leaf], starts[leaf + 1])
            assert v.size == p.numel() and np.array_equal(v, want), \
                (what, name)
            covered += v.size
        assert covered == total, what


def _aligner_port():
    from forwardtacotron_tpu_torch.align.aligner import Aligner
    from forwardtacotron_tpu_torch.weights import aligner_state_dict
    _, variables, cfg = _aligner()
    return _loaded(Aligner(**cfg), aligner_state_dict(variables))
