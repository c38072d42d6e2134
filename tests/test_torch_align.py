"""The port's alignment path on the CPU against the JAX package: the
duration DP, the argmax counter, the attention scores, the per-phoneme
pitch and energy, and `create_align_features` with the same teacher
weights.

Tolerances: durations exact (where a float32 near-tie breaks the other
way than the JAX package's, the two paths must cost the same within
1e-5 of the path's cost, the DP's own float32 rounding); the DP's path
cost against scipy's Dijkstra within 1e-4 (float32 cumulative sums
against float64 edge sums over up to 70 nodes); attention scores at
1e-6; per-phoneme pitch and energy exact (the same numpy code on the same
arrays); `create_align_features`' attention scores at 1e-5 (its
attention agrees with the JAX package's within 1e-6, from float32 sums
in another order).
"""
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_duration_extraction import _dijkstra_reference


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """The teacher's decoder is a loop of many small ops: with one
    intra-op thread a test worker runs it faster and leaves the other
    workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _path_cost(att, durations, mel_len):
    """(1 - att) summed over the cheapest monotone path whose rightmost
    text index in mel row i is the i-th of the durations' expansion: a
    row that moves on enters diagonally after the previous row's column."""
    cols = np.repeat(np.arange(len(durations)), durations)
    assert len(cols) == mel_len
    cost = 1.0 - np.asarray(att, np.float64)[:mel_len]
    total, prev = 0.0, -1
    for i, c in enumerate(cols):
        start = 0 if i == 0 else (prev + 1 if c > prev else c)
        total += cost[i, start:c + 1].sum()
        prev = c
    return total


def _same_or_equal_cost(ours, ref, att, mel_len):
    if not np.array_equal(ours, ref):
        a, b = _path_cost(att, ours, mel_len), _path_cost(att, ref, mel_len)
        assert abs(a - b) <= 1e-5 * max(abs(b), 1.0), (ours, ref, a, b)


def _diagonal(seed, T=30, N=8):
    """Diagonal-ish attention with noise (tests/test_duration_extraction)."""
    rng = np.random.RandomState(seed)
    att = rng.rand(T, N).astype(np.float32) * 0.3
    for i in range(T):
        att[i, int(i / T * N)] += 0.7
    return att / att.sum(axis=1, keepdims=True)


def _sharp(T=12, true_durs=(2, 4, 3, 3)):
    att = np.full((T, len(true_durs)), 1e-3, dtype=np.float32)
    i = 0
    for j, d in enumerate(true_durs):
        att[i:i + d, j] = 1.0
        i += d
    return att


@pytest.mark.parametrize('case', ['sharp', 'single', 'diag0', 'diag1',
                                  'diag2', 'diag3'])
def test_durations_equal_jax(case):
    from forwardtacotron_tpu.align import duration as jdur
    from forwardtacotron_tpu_torch.align import duration as tdur
    if case == 'sharp':
        att = _sharp()
    elif case == 'single':
        att = np.ones((5, 1), np.float32)
    else:
        att = _diagonal(int(case[-1]))
    T, N = att.shape
    ours = tdur.extract_durations_with_dp(N, att, T)
    np.testing.assert_array_equal(ours, jdur.extract_durations_with_dp(
        N, att, T))
    np.testing.assert_array_equal(ours, tdur.extract_durations_with_dijkstra(
        np.zeros(N), att, T))
    if case == 'sharp':
        assert ours.tolist() == [2, 4, 3, 3]
    elif case == 'single':
        assert ours.tolist() == [5]
    else:
        np.testing.assert_array_equal(ours, _dijkstra_reference(att, T)[0])


@pytest.mark.parametrize('seed', range(6))
def test_random_attention_cost_equals_dijkstra(seed):
    """Random (not monotone) attention over a padded mel: the DP's path
    costs what scipy's Dijkstra finds, its durations sum to mel_len, and
    they equal the JAX package's or cost the same."""
    from forwardtacotron_tpu.align import duration as jdur
    from forwardtacotron_tpu_torch.align import duration as tdur
    rng = np.random.RandomState(seed)
    T_pad, N, mel_len = 48, 11, 40 - seed
    att = rng.dirichlet(np.ones(N) * 0.3, size=T_pad).astype(np.float32)
    ours = tdur.extract_durations_with_dp(N, att, mel_len)
    assert ours.sum() == mel_len and ours.dtype == np.int32
    _, dist = _dijkstra_reference(att, mel_len)
    dp_cost = float(tdur._dp_forward(1.0 - att[:mel_len])[0][-1, -1])
    want = dist + 1.0 - float(att[0, 0])     # Dijkstra omits the start node
    assert abs(dp_cost - want) <= 1e-4
    assert abs(_path_cost(att, ours, mel_len) - want) <= 1e-4
    _same_or_equal_cost(ours, jdur.extract_durations_with_dp(
        N, att, mel_len), att, mel_len)


def test_durations_per_count_equal_jax():
    from forwardtacotron_tpu.align import duration as jdur
    from forwardtacotron_tpu_torch.align import duration as tdur
    rng = np.random.RandomState(0)
    cases = [(_sharp(), 12), (_diagonal(4), 25),
             (rng.rand(40, 30).astype(np.float32), 33)]    # jumps > 10
    for att, mel_len in cases:
        seq = np.zeros(att.shape[1])
        np.testing.assert_array_equal(
            tdur.extract_durations_per_count(seq, att.copy(), mel_len),
            jdur.extract_durations_per_count(seq, att.copy(), mel_len))


@pytest.mark.parametrize('r', [1, 2])
def test_attention_score_equals_jax(r):
    from forwardtacotron_tpu.align.metrics import attention_score as jscore
    from forwardtacotron_tpu_torch.align.metrics import attention_score
    rng = np.random.RandomState(r)
    att = rng.dirichlet(np.ones(9), size=(4, 30)).astype(np.float32)
    att[0] = 1e-6
    for i in range(30):                   # a monotone item
        att[0, i, min(i // 4, 8)] = 0.9
    mel_lens = np.array([30, 21, 2, 1])
    got = attention_score(torch.from_numpy(att), torch.from_numpy(mel_lens),
                          r=r)
    want = jscore(jnp.asarray(att), jnp.asarray(mel_lens), r=r)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    assert float(got[0][0]) == 1.0


N_MELS = 6


def _write_dataset(data, n_items=7, n_val=2, seed=0):
    """Items of 4-10 phonemes, 10-40 frames, with mel and frame F0 (some
    frames unvoiced, some above pitch_max_freq)."""
    from forwardtacotron_tpu_torch.text.symbols import phonemes
    from forwardtacotron_tpu_torch.utils.files import pickle_binary
    rng = np.random.RandomState(seed)
    for d in ('mel', 'raw_pitch'):
        (data / d).mkdir(parents=True, exist_ok=True)
    index, text_dict = [], {}
    for i in range(n_items):
        n, frames = rng.randint(4, 11), rng.randint(10, 41)
        np.save(data / 'mel' / f'u{i}.npy',
                (rng.randn(N_MELS, frames) - 3).astype(np.float32))
        f0 = rng.uniform(80, 700, frames).astype(np.float32)
        f0[rng.rand(frames) < 0.3] = 0.0
        np.save(data / 'raw_pitch' / f'u{i}.npy', f0)
        text_dict[f'u{i}'] = ''.join(rng.choice(phonemes[1:], n))
        index.append((f'u{i}', frames))
    pickle_binary(text_dict, data / 'text_dict.pkl')
    pickle_binary(index[:-n_val], data / 'train_dataset.pkl')
    pickle_binary(index[-n_val:], data / 'val_dataset.pkl')
    return index


def _copy_dataset(src, dst):
    import shutil
    shutil.copytree(src, dst)
    return dst


def test_phoneme_pitch_energy_equal_jax(tmp_path):
    from forwardtacotron_tpu.align import features as jfeat
    from forwardtacotron_tpu.utils.paths import Paths as JPaths
    from forwardtacotron_tpu_torch.align import features as tfeat
    from forwardtacotron_tpu_torch.utils.paths import Paths
    index = _write_dataset(tmp_path / 'src')
    rng = np.random.RandomState(1)
    (tmp_path / 'src' / 'alg').mkdir()
    for item, frames in index:          # durations with zeros, sum = frames
        n = 7
        durs = rng.multinomial(frames, np.ones(n) / n).astype(np.int32)
        np.save(tmp_path / 'src' / 'alg' / f'{item}.npy', durs)
    mel = np.load(tmp_path / 'src' / 'mel' / 'u0.npy')
    f0 = np.load(tmp_path / 'src' / 'raw_pitch' / 'u0.npy')
    dur = np.load(tmp_path / 'src' / 'alg' / 'u0.npy')
    for got, want in zip(tfeat.phoneme_pitch_energy(dur, mel, f0, 600),
                         jfeat.phoneme_pitch_energy(dur, mel, f0, 600)):
        np.testing.assert_array_equal(got, want)

    ours = Paths(str(_copy_dataset(tmp_path / 'src', tmp_path / 'a')), 't',
                 base=tmp_path / 'a_base')
    theirs = JPaths(str(_copy_dataset(tmp_path / 'src', tmp_path / 'b')),
                    'v', 't', base=tmp_path / 'b_base')
    got = tfeat.extract_pitch_energy(ours, ours.phon_pitch, ours.phon_energy,
                                     600)
    want = jfeat.extract_pitch_energy(theirs, theirs.phon_pitch,
                                      theirs.phon_energy, 600)
    assert got == want
    for item, _ in index:
        for d in ('phon_pitch', 'phon_energy'):
            a = np.load(ours.data / d / f'{item}.npy')
            b = np.load(theirs.data / d / f'{item}.npy')
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f'{d} {item}')


TACO_CFG = {'embed_dims': 16, 'encoder_dims': 128, 'decoder_dims': 256,
            'postnet_dims': 8, 'encoder_k': 2, 'lstm_dims': 32,
            'postnet_k': 2, 'num_highways': 1, 'dropout': 0.5,
            'stop_threshold': -11}


def test_create_align_features_equal_jax(tmp_path):
    """The same teacher weights in both packages: the same durations,
    attention scores at 1e-5, and the same pitch and energy per phoneme
    from them."""
    from forwardtacotron_tpu.align import features as jfeat
    from forwardtacotron_tpu.data import dataset as jds
    from forwardtacotron_tpu.models.tacotron import Tacotron as JaxTaco
    from forwardtacotron_tpu.text.symbols import phonemes as jphonemes
    from forwardtacotron_tpu.utils.paths import Paths as JPaths
    from forwardtacotron_tpu_torch.align import features as tfeat
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.data import dataset as tds
    from forwardtacotron_tpu_torch.models.tacotron import Tacotron
    from forwardtacotron_tpu_torch.utils.files import unpickle_binary
    from forwardtacotron_tpu_torch.utils.paths import Paths
    from forwardtacotron_tpu_torch.weights import tacotron_state_dict
    index = _write_dataset(tmp_path / 'src')
    config = default_config()
    ours = Paths(str(_copy_dataset(tmp_path / 'src', tmp_path / 'a')), 't',
                 base=tmp_path / 'a_base')
    theirs = JPaths(str(_copy_dataset(tmp_path / 'src', tmp_path / 'b')),
                    'v', 't', base=tmp_path / 'b_base')

    jmodel = JaxTaco(num_chars=len(jphonemes), n_mels=N_MELS, **TACO_CFG)
    variables = jax.jit(lambda k: jmodel.init(
        {'params': k}, jnp.ones((1, 4), jnp.int32),
        jnp.zeros((1, 8, N_MELS)), 1, train=False))(jax.random.PRNGKey(3))
    variables = jax.tree.map(np.asarray, variables)
    # a sharper attention than random weights give: near-uniform scores
    # would make the path a matter of near-ties
    variables['params']['lsa_v']['kernel'] = \
        variables['params']['lsa_v']['kernel'] * 8.0
    model = Tacotron(n_mels=N_MELS, **TACO_CFG)
    model.load_state_dict(tacotron_state_dict(variables, TACO_CFG))

    kw = dict(batch_size=3, r=1, max_mel_len=None, filter_attention=False)
    tfeat.create_align_features(
        model, *tds.get_tts_datasets(ours.data, model_type='tacotron', **kw),
        ours, config, pitch_max_freq=600)
    jfeat.create_align_features(
        jmodel, types.SimpleNamespace(variables=variables),
        *jds.get_tts_datasets(theirs.data, model_type='tacotron', **kw),
        theirs, config, pitch_max_freq=600)

    got = unpickle_binary(ours.data / 'att_score_dict.pkl')
    want = unpickle_binary(theirs.data / 'att_score_dict.pkl')
    assert set(got) == set(want) == {i for i, _ in index}
    for item, mel_len in index:
        np.testing.assert_allclose(got[item], want[item], atol=1e-5)
        a = np.load(ours.alg / f'{item}.npy')
        b = np.load(theirs.alg / f'{item}.npy')
        assert a.dtype == b.dtype and a.sum() == mel_len
        np.testing.assert_array_equal(a, b, err_msg=item)
        for d in ('phon_pitch', 'phon_energy'):
            np.testing.assert_array_equal(
                np.load(ours.data / d / f'{item}.npy'),
                np.load(theirs.data / d / f'{item}.npy'), err_msg=item)
