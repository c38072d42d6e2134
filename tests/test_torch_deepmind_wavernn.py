"""The port's DeepMind coarse/fine WaveRNN on the CPU against the JAX
package's, same weights (through `deepmind_wavernn_state_dict`, under the
reference's key names).

The teacher-forced step at atol 1e-5; `generate` for shapes, ranges and
its seed (the same generator state gives the same samples); with a large
bias on one class of `O2` and of `O4` every draw is that class, and the
port's trajectory equals JAX's; the split/combine round trip.
"""
import numpy as np

import jax
import jax.numpy as jnp
import torch

CFG = dict(hidden_size=32, quantisation=16)


def _models(bias_class=None):
    from forwardtacotron_tpu.models.deepmind_wavernn import (
        DeepMindWaveRNN as JaxDM)
    from forwardtacotron_tpu_torch.models.deepmind_wavernn import (
        DeepMindWaveRNN)
    from forwardtacotron_tpu_torch.weights import deepmind_wavernn_state_dict
    jmodel = JaxDM(**CFG)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 2)),
                            jnp.zeros((1, CFG['hidden_size'])),
                            jnp.zeros((1, 1)))
    rng = np.random.RandomState(1)
    params = jax.tree.map(np.asarray, variables['params'])
    for name in ('bias_u', 'bias_r', 'bias_e'):
        params[name] = (rng.randn(CFG['hidden_size']) * 0.3
                        ).astype(np.float32)
    if bias_class is not None:
        for out, cls in zip(('O2', 'O4'), bias_class):
            bias = np.zeros(CFG['quantisation'], np.float32)
            bias[cls] = 100.0
            params[out] = dict(params[out], bias=bias)
    variables = {'params': params}
    model = DeepMindWaveRNN(**CFG)
    sd = deepmind_wavernn_state_dict(variables)
    assert set(sd) == {'R.weight', 'O1.weight', 'O1.bias', 'O2.weight',
                       'O2.bias', 'O3.weight', 'O3.bias', 'O4.weight',
                       'O4.bias', 'I_coarse.weight', 'I_fine.weight',
                       'bias_u', 'bias_r', 'bias_e'}
    model.load_state_dict(sd, strict=True)
    return jmodel, variables, model


def test_step_matches_jax():
    jmodel, variables, model = _models()
    rng = np.random.RandomState(0)
    B = 3
    prev_y = rng.uniform(-1, 1, (B, 2)).astype(np.float32)
    hidden = rng.randn(B, CFG['hidden_size']).astype(np.float32)
    cur_c = rng.uniform(-1, 1, (B, 1)).astype(np.float32)
    ref = jmodel.apply(variables, jnp.asarray(prev_y), jnp.asarray(hidden),
                       jnp.asarray(cur_c))
    with torch.no_grad():
        out = model(torch.from_numpy(prev_y), torch.from_numpy(hidden),
                    torch.from_numpy(cur_c))
    for name, a, b in zip(('coarse', 'fine', 'hidden'), out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   err_msg=name)


def test_generate_seeded_dominant_trajectory_and_signal_round_trip():
    from forwardtacotron_tpu_torch.models.deepmind_wavernn import (
        combine_signal, split_signal)
    _, _, model = _models()
    gen = torch.Generator().manual_seed(3)
    coarse, fine = model.generate(25, gen, batch_size=2)
    assert coarse.shape == fine.shape == (2, 25)
    assert coarse.dtype == fine.dtype == torch.long
    for s in (coarse, fine):
        assert 0 <= int(s.min()) and int(s.max()) < CFG['quantisation']
    again = model.generate(25, torch.Generator().manual_seed(3), 2)
    assert torch.equal(again[0], coarse) and torch.equal(again[1], fine)
    other = model.generate(25, torch.Generator().manual_seed(4), 2)
    assert not (torch.equal(other[0], coarse) and torch.equal(other[1], fine))

    jmodel, variables, model = _models(bias_class=(11, 6))
    jc, jf = jmodel.apply(variables, 12, jax.random.PRNGKey(1),
                          method='generate', batch_size=2)
    c, f = model.generate(12, torch.Generator().manual_seed(0), 2)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    assert (c == 11).all() and (f == 6).all()

    sig = np.linspace(-1, 1, 17)
    hi, lo = split_signal(sig)
    assert hi.max() < 256 and lo.max() < 256
    np.testing.assert_allclose(combine_signal(hi, lo), sig, atol=1e-4)
