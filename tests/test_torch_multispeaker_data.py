"""The multi-speaker data path and trainers of the port on the CPU: the
`multispeaker` recipe and `preprocess --metadata_format multispeaker`
against the JAX package's on the same corpus (`speaker_dict.pkl`, dense
ids in sorted name order, filtered to the items written); `collate_tts`
and `get_tts_datasets` carrying a (B,) int32 `speaker`; the teacher's and
the student's trainers and the teacher's alignment handing the batch's
speakers to the model.
"""
import wave

import numpy as np
import pytest
import torch

from test_torch_multispeaker import FT_TINY, TACO_TINY

SR = 22050


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """Small ops in loops: one intra-op thread runs them faster under the
    suite's workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_corpus(root, speakers):
    """`id|speaker|text` metadata and a short harmonic wav per line, with
    blank lines, one line without a wav and one with too short a text."""
    (root / 'wavs').mkdir(parents=True)
    texts = ['The cat sat on the mat.', 'One two three four.',
             'She sells sea shells.', 'A quick brown fox.',
             'Hello there, general.', 'Printing, in the only sense.']
    lines = []
    for i, spk in enumerate(speakers):
        n = 5000 + 700 * i
        phase = 2 * np.pi * np.cumsum(np.full(n, 110.0 + 20 * i)) / SR
        y = sum(0.3 / k * np.sin(k * phase) for k in range(1, 5))
        pcm = np.round(y * 32767).astype('<i2')
        with wave.open(str(root / 'wavs' / f'u{i}.wav'), 'wb') as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SR)
            w.writeframes(pcm.tobytes())
        lines.append(f'u{i}|{spk}|{texts[i % len(texts)]}')
    lines += ['', '   ', 'u90|zed|no wav for this line', 'u5|zed|a']
    (root / 'metadata.csv').write_text('\n'.join(lines) + '\n\n',
                                       encoding='utf-8')


def test_recipe_and_speaker_dict_equal_jax(tmp_path, monkeypatch):
    """The port's `multispeaker` recipe and `preprocess --metadata_format
    multispeaker` against the JAX package's on the same corpus: ids dense
    in sorted name order, the dict filtered to the items written (u5's
    text is too short, u90 has no wav, so `zed` is gone)."""
    import yaml
    import preprocess as jax_preprocess
    from forwardtacotron_tpu.text.recipes import multispeaker as jax_recipe
    from forwardtacotron_tpu.utils import jax_setup
    from forwardtacotron_tpu_torch import preprocess
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.text.recipes import multispeaker
    from forwardtacotron_tpu_torch.utils.files import unpickle_binary
    corpus = tmp_path / 'corpus'
    _write_corpus(corpus, ['p2', 'p10', 'p2', 'p1', 'p10', 'p1'])
    assert multispeaker(corpus) == jax_recipe(corpus)
    texts, speakers = multispeaker(corpus)
    assert speakers == {'u0': 2, 'u1': 1, 'u2': 2, 'u3': 0, 'u4': 1,
                        'u5': 3, 'u90': 3}
    assert set(texts) == set(speakers)
    runs = {}
    for name in ('port', 'jax'):
        cfg = default_config()
        cfg['data_path'] = str(tmp_path / name / 'data')
        cfg['preprocessing']['n_val'] = 1
        path = tmp_path / f'{name}.yaml'
        path.write_text(yaml.safe_dump(cfg))
        runs[name] = tmp_path / name / 'data'
        monkeypatch.setenv('FTT_BASE', str(tmp_path / name))
        argv = ['--path', str(corpus), '--config', str(path),
                '--metadata_format', 'multispeaker']
        if name == 'port':
            preprocess.main(argv + ['--device', 'cpu'])
        else:
            monkeypatch.setattr(jax_setup, 'enable_compilation_cache',
                                lambda *a: None)
            monkeypatch.setattr('sys.argv', ['preprocess.py'] + argv)
            jax_preprocess.main()
    ours = unpickle_binary(runs['port'] / 'speaker_dict.pkl')
    assert ours == unpickle_binary(runs['jax'] / 'speaker_dict.pkl')
    assert ours == {'u0': 2, 'u1': 1, 'u2': 2, 'u3': 0, 'u4': 1}
    items = unpickle_binary(runs['port'] / 'train_dataset.pkl') \
        + unpickle_binary(runs['port'] / 'val_dataset.pkl')
    assert {i for i, _ in items} == set(ours)


def test_collate_and_datasets_carry_speaker(tmp_path):
    from forwardtacotron_tpu.data.dataset import collate_tts as jax_collate
    from forwardtacotron_tpu_torch.data.dataset import (collate_tts,
                                                        get_tts_datasets)
    from forwardtacotron_tpu_torch.utils.files import pickle_binary
    items = [{'item_id': str(i), 'mel': np.full((2, 5 + i), 1.),
              'x': np.full(2 + i, 2), 'mel_len': 5 + i, 'x_len': 2 + i,
              'dur': np.full(2 + i, 3.), 'pitch': np.full(2 + i, 4.),
              'energy': np.full(2 + i, 5.), 'speaker': spk}
             for i, spk in enumerate([2, 0])]
    batch = collate_tts(items, r=1)
    assert batch['speaker'].dtype == np.int32
    assert batch['speaker'].tolist() == [2, 0]
    np.testing.assert_array_equal(batch['speaker'],
                                  jax_collate(items, r=1)['speaker'])

    data = tmp_path / 'data'
    (data / 'mel').mkdir(parents=True)
    rng = np.random.RandomState(0)
    index = []
    for i in range(7):
        np.save(data / 'mel' / f'{i}.npy',
                rng.randn(8, 10 + 3 * i).astype(np.float32))
        index.append((str(i), 10 + 3 * i))
    pickle_binary({str(i): 'hello there' for i in range(7)},
                  data / 'text_dict.pkl')
    pickle_binary(index[:5], data / 'train_dataset.pkl')
    pickle_binary(index[5:], data / 'val_dataset.pkl')
    speakers = {str(i): i % 3 for i in range(6)}       # item 6 missing
    pickle_binary(speakers, data / 'speaker_dict.pkl')
    train, val = get_tts_datasets(data, batch_size=2, r=1,
                                  max_mel_len=None, model_type='tacotron',
                                  mel_multiple=16)
    seen = 0
    for batch in list(train.batches(0)) + list(val.batches(0)):
        assert batch['speaker'].dtype == np.int32
        for row, item in enumerate(batch['item_id']):
            assert batch['speaker'][row] == speakers.get(item, 0)
            seen += 1
    assert seen >= 7


def test_trainers_carry_speaker(tmp_path):
    """The teacher (one step at r=2, then its alignment) and the student
    (one step) on a multi-speaker corpus: each step's forward reads the
    batch's speakers, which the teacher's alignment reads too."""
    from forwardtacotron_tpu_torch.align.features import (
        create_align_features)
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.data.dataset import get_tts_datasets
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.models.tacotron import Tacotron
    from forwardtacotron_tpu_torch.train.forward_trainer import (
        ForwardTrainer)
    from forwardtacotron_tpu_torch.train.taco_trainer import TacoTrainer
    from forwardtacotron_tpu_torch.utils.files import pickle_binary
    from forwardtacotron_tpu_torch.utils.paths import Paths
    data = tmp_path / 'data'
    (data / 'mel').mkdir(parents=True)
    rng = np.random.RandomState(1)
    index = []
    for i in range(6):
        frames = 12 + 2 * i
        np.save(data / 'mel' / f'{i}.npy',
                rng.randn(80, frames).astype(np.float32) - 4)
        (data / 'raw_pitch').mkdir(exist_ok=True)
        np.save(data / 'raw_pitch' / f'{i}.npy',
                rng.uniform(80, 200, frames).astype(np.float32))
        index.append((str(i), frames))
    pickle_binary({str(i): 'hello there' for i in range(6)},
                  data / 'text_dict.pkl')
    pickle_binary(index[:4], data / 'train_dataset.pkl')
    pickle_binary(index[4:], data / 'val_dataset.pkl')
    pickle_binary({str(i): i % 3 for i in range(6)},
                  data / 'speaker_dict.pkl')
    cfg = default_config()
    cfg['data_path'] = str(data)
    cfg['tacotron']['model'] = dict(TACO_TINY, stop_threshold=-11)
    cfg['tacotron']['training']['schedule'] = ['2, 1e-3, 1, 2']
    cfg['forward_tacotron']['model'] = dict(FT_TINY, n_speakers=3)
    cfg['forward_tacotron']['training'].update(
        schedule=['1e-3, 1, 2'], filter_attention=False)
    paths = Paths(cfg['data_path'], 'ms_tts', base=tmp_path)

    seen = []
    torch.manual_seed(0)
    teacher = Tacotron.from_config(cfg)
    forward = teacher.forward

    def spy(x, mel, r, generator=None, speaker=None):
        seen.append(None if speaker is None else speaker.tolist())
        return forward(x, mel, r, generator, speaker)
    teacher.forward = spy
    assert TacoTrainer(paths, cfg, device='cpu').train(teacher) == 1
    assert seen and all(s is not None for s in seen)
    train_set, val_set = get_tts_datasets(data, 8, 1, max_mel_len=None,
                                          filter_attention=False,
                                          model_type='tacotron')
    seen.clear()
    create_align_features(teacher, train_set, val_set, paths, cfg,
                          pitch_max_freq=600)
    # batches of 8 repeat their items: every speaker, and only those
    assert {s for batch in seen for s in batch} == {0, 1, 2}
    for item, frames in index:
        assert np.load(paths.alg / f'{item}.npy').sum() == frames

    student = ForwardTacotron.from_config(cfg)
    forward_s = student.forward
    seen.clear()

    def spy_s(batch, generator=None):
        seen.append(batch['speaker'].tolist())
        return forward_s(batch, generator)
    student.forward = spy_s
    assert ForwardTrainer(paths, cfg, device='cpu').train(student) == 1
    assert seen and all(len(s) == 2 for s in seen)
