"""The GAN vocoder's benchmark cell on the CPU: the `GANVocCollator`
batches report each row's item and crop offset, so that the files read
at them give the batch exactly, and stay on the host; a profiled
`gan_train_step` records its spans nested, one `ftt.train.step` a step;
the card time of a span's work is attributed through each kernel's
launch call (`perfbench/harness/span_kernels.py`) on a synthetic event
list; the three readers; the cell's whole run
(`perfbench/run.py:run_cell`) at a tiny size reads correct, and its
traced run gives the readers of the port's host spans their steps."""
import argparse
import collections
import json
import pickle
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from forwardtacotron_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
CELL = 'hifigan_v1_ljspeech.gan_b16'
HOP, SEG_LEN = 256, 1024


@pytest.fixture(autouse=True)
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def store(monkeypatch):
    """An empty span store and step count."""
    monkeypatch.setattr(profiling, '_store', collections.deque(
        maxlen=profiling.STORE_SPANS))
    monkeypatch.setattr(profiling, '_steps', 0)


def small_config():
    """The cell's configuration with the generator at 32 channels (the
    discriminators stay whole)."""
    cfg = json.loads((ROOT / 'perfbench/configs/hifigan_v1_ljspeech.json'
                      ).read_text())
    cfg['hifigan']['model']['upsample_initial_channel'] = 32
    return cfg


# ---------------------------------------------------------------- batches

def _write_items(data, frames, n_val=2, seed=0):
    """16-bit linear labels of frames * HOP samples and 80-band mels; an
    item of 0 frames has HOP - 1 samples, no whole frame (the collator
    drops it and refills its row)."""
    rng = np.random.RandomState(seed)
    for d in ('mel', 'quant'):
        (data / d).mkdir(parents=True, exist_ok=True)
    index = []
    for i, t in enumerate(frames):
        np.save(data / 'mel' / f'v{i}.npy',
                rng.randn(80, max(t, 1)).astype(np.float32))
        n = t * HOP if t else HOP - 1
        np.save(data / 'quant' / f'v{i}.npy',
                rng.randint(0, 2 ** 16, n).astype(np.int64))
        index.append((f'v{i}', max(t, 1)))
    for name, part in (('train_dataset', index[:-n_val]),
                       ('val_dataset', index[-n_val:])):
        with open(data / f'{name}.pkl', 'wb') as f:
            pickle.dump(part, f)


def test_gan_batches_report_rows_and_offsets(tmp_path):
    """Read at the reported rows and offsets, the raw files give each
    batch's mel and audio exactly, refilled rows included."""
    from forwardtacotron_tpu_torch.data.dataset import \
        get_gan_vocoder_datasets
    from perfbench.reference.hifigan_gan import read_batch
    data = tmp_path / 'data'
    _write_items(data, [9, 0, 12, 7, 15, 8, 11, 6, 10])
    train, _, _ = get_gan_vocoder_datasets(
        path=data, batch_size=3, train_gta=False, max_mel_len=20000,
        hop_length=HOP, seg_len=SEG_LEN, voc_mode='MOL', bits=9,
        mu_law=True, num_gen_samples=1)
    refilled = 0
    for epoch in range(4):
        for batch in train.batches(epoch):
            assert batch['index'].dtype == batch['offset'].dtype == np.int64
            got = read_batch(data, batch['index'], batch['offset'], SEG_LEN,
                             HOP, 20000, 'cpu')
            np.testing.assert_array_equal(
                got['mel'].numpy(), batch['mel'].transpose(0, 2, 1))
            np.testing.assert_array_equal(got['audio'].numpy(),
                                          batch['audio'])
            refilled += len(batch['index']) - len(set(batch['index']))
    assert refilled > 0


def test_row_indices_and_offsets_stay_on_the_host():
    """`voc_trainer.batch_to_device` copies the batch's audio and mels and
    leaves the rows' indices and crop offsets, which no step reads."""
    from forwardtacotron_tpu_torch.train.voc_trainer import batch_to_device
    batch = {'mel': np.zeros((2, 4, 80), np.float32),
             'audio': np.zeros((2, SEG_LEN), np.float32),
             'index': np.array([3, 5]), 'offset': np.array([0, 7])}
    got = batch_to_device(batch, 'cpu')
    assert set(got) == {'mel', 'audio'}
    assert all(isinstance(v, torch.Tensor) for v in got.values())


# ------------------------------------------------------------------ spans

def _gan_parts(cfg, B=2):
    from forwardtacotron_tpu_torch.dsp.audio import DSP
    from forwardtacotron_tpu_torch.models.gan_discriminators import \
        HiFiGANDiscriminators
    from forwardtacotron_tpu_torch.models.hifigan import make_generator
    from forwardtacotron_tpu_torch.train.hifigan_trainer import \
        make_gan_optimizer
    torch.manual_seed(0)
    gen, disc = make_generator(cfg).train(), HiFiGANDiscriminators().train()
    batch = {'mel': torch.randn(B, SEG_LEN // HOP, 80),
             'audio': 0.1 * torch.randn(B, SEG_LEN)}
    return (gen, disc, make_gan_optimizer(gen), make_gan_optimizer(disc),
            batch, DSP.from_config(cfg, device='cpu').wav_to_mel_batch)


def test_profiled_gan_step_records_nested_spans(store):
    from forwardtacotron_tpu_torch.train.hifigan_trainer import \
        gan_train_step
    gen, disc, gen_opt, disc_opt, batch, to_mel = _gan_parts(small_config())
    gan_train_step(gen, disc, gen_opt, disc_opt, batch, to_mel)
    assert profiling.spans() == []          # nothing without a profiler
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            gan_train_step(gen, disc, gen_opt, disc_opt, batch, to_mel)
    spans = profiling.spans()
    steps = [s for s in spans if s.name == profiling.STEP_SPAN]
    assert [s.step for s in steps] == [0, 1]
    assert all(s.attrs == {'path': 'eager', 'B': 2, 'seg_len': SEG_LEN}
               for s in steps)
    by_id = {s.id: s for s in spans}
    want = {'ftt.gan.disc_update': ['ftt.gan.generator',
                                    'ftt.gan.discriminators',
                                    'ftt.train.backward',
                                    'ftt.train.update'],
            'ftt.gan.gen_update': ['ftt.gan.generator',
                                   'ftt.gan.discriminators', 'ftt.gan.mel',
                                   'ftt.train.backward',
                                   'ftt.train.update']}
    for step in steps:
        mine = sorted((s for s in spans if s.step == step.step
                       and s is not step), key=lambda s: s.start_ns)
        halves = [s for s in mine if s.parent == step.id]
        assert [h.name for h in halves] == list(want)
        for half in halves:
            assert step.start_ns <= half.start_ns <= half.end_ns \
                <= step.end_ns
            kids = [s for s in mine if s.parent == half.id]
            assert [k.name for k in kids] == want[half.name]
        assert all(by_id[s.parent].step == step.step for s in mine)
        assert len(mine) == 2 + sum(len(v) for v in want.values())
    names = [e.name for e in prof.events()]
    for name in ('ftt.gan.disc_update', 'ftt.gan.gen_update'):
        assert names.count(name) == 2


# ------------------------------------------------------ span attribution

def _event(name, start, end, id_, device='CPU', annotation=False):
    return SimpleNamespace(
        name=name, device_type=f'DeviceType.{device}', id=id_,
        time_range=SimpleNamespace(start=start, end=end),
        is_user_annotation=annotation)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_card_time_follows_each_kernel_to_its_launch():
    """Work belongs to the span in which its launch call began, whatever
    host thread launched it and whenever it ran; overlapping work counts
    once; mirrored annotations are no work; work without a launch call is
    counted apart (times in us, as the profiler's events give them)."""
    from perfbench.harness.span_kernels import events_of, span_card_seconds
    D, G = 'ftt.gan.disc_update', 'ftt.gan.gen_update'
    events = [
        _event(D, 0, 100, 900), _event(G, 100, 300, 901),
        _event(D, 300, 400, 902), _event(G, 400, 600, 903),
        _event(D, 0, 100, 904, 'CUDA', annotation=True),
        _event('ftt.gan.gen_update', 100, 300, 905, 'CUDA'),
        # launches: two in the first D, one on autograd's thread in the
        # first G, one in the second D, one in the second G
        _event('cudaLaunchKernel', 10, 12, 1),
        _event('cudaLaunchKernel', 20, 22, 2),
        _event('cudaLaunchKernel', 150, 152, 3),
        _event('cuLaunchKernel', 350, 351, 4),
        _event('cudaMemcpyAsync', 450, 460, 5),
        _event('aten::add', 50, 60, 6),
        # the card: kernels 1 and 2 overlap, 3 runs after its span closed
        _event('k1', 30, 70, 1, 'CUDA'), _event('k2', 60, 90, 2, 'CUDA'),
        _event('k3', 310, 330, 3, 'CUDA'), _event('k4', 380, 390, 4, 'CUDA'),
        _event('Memcpy HtoD', 470, 475, 5, 'CUDA'),
        _event('orphan', 500, 900, 77, 'CUDA')]
    got = span_card_seconds(events_of(_Prof(events)), (D, G))
    assert got['seconds'][D] == pytest.approx((60 + 10) * 1e-6)
    assert got['seconds'][G] == pytest.approx((20 + 5) * 1e-6)
    assert (got['linked'], got['unlinked']) == (5, 1)
    assert span_card_seconds(events_of(_Prof(events)),
                             (D, 'ftt.gan.missing')) is None
    no_links = [e for e in events if not e.name.startswith('cu')]
    assert span_card_seconds(events_of(_Prof(no_links)), (D, G)) is None


def _reader(name):
    from perfbench.run import reader
    return reader(name)


def test_the_gan_readers():
    halves = {'seconds': {'ftt.gan.disc_update': 0.08,
                          'ftt.gan.gen_update': None},
              'linked': 10, 'unlinked': 0}
    ctx = {'kind': 'gan', 'gan_halves': halves, 'gan_traced_steps': 8,
           'window_s': 2.0, 'window_steps': 10, 'step_flops': 4.95e12,
           'peak': 'tf32'}
    assert _reader('gan_disc_update_ms.train')(ctx) == pytest.approx(10.0)
    assert _reader('gan_gen_update_ms.train')(ctx) is None
    assert _reader('gan_train_mfu')(ctx) == pytest.approx(5.0)
    # a program without the spans: nothing to read, never 0
    for name in ('gan_disc_update_ms.train', 'gan_gen_update_ms.train'):
        assert _reader(name)(dict(ctx, gan_halves=None)) is None
        assert _reader(name)({'trace': None}) is None
    assert _reader('gan_train_mfu')({'kind': 'train', 'window_steps': 3}) \
        is None


# --------------------------------------------------------- the whole run

def _tiny_inputs(trace_steps=None):
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    cell = next(w for w in bench['workloads'] if w['name'] == CELL)
    traffic = json.loads((ROOT / 'perfbench/traffic/gan_b16.json'
                          ).read_text())
    traffic.update(batch_size=2, seg_len=SEG_LEN, frames=[[40, 60, 6]],
                   val_items=2)
    workload = json.loads((ROOT / f'perfbench/workloads/{CELL}.json'
                           ).read_text())
    if trace_steps is not None:
        workload['trace_steps'] = trace_steps
    return bench, cell, small_config(), traffic, workload


def test_a_whole_gan_run_reads_correct():
    from perfbench.run import run_cell
    inputs = _tiny_inputs()
    workload = inputs[-1]
    args = argparse.Namespace(workload=CELL, seed=2 ** 31 + 4242,
                              seconds=0.5, trace=0)
    result, check, notes = run_cell(args, device='cpu', inputs=inputs)
    assert result['correct'], (check, notes)
    assert result['attempted'] > 0 and result['failed'] == 0
    assert set(result['metrics']) == {'train_step_ms', 'setup_s'}
    assert set(check) == set(workload['limits'])
    for row in check.values():
        assert row['value'] <= row['limit'] / 10, check


class _HostSlice:
    """`harness/trace.py:Slice` on the CPU: the host's operations alone,
    the card never busy."""

    def __init__(self, host_ops=False):
        self.prof = None

    def start(self):
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def summary(self):
        return {'window_s': self.t1 - self.t0, 'busy_s': 0.0,
                'device_ops': [], 'idle_gaps': []}


def test_a_traced_gan_run_reads_the_host_spans(store, monkeypatch):
    """The GAN cell's traced run gives the readers of the port's host
    spans its card-only traced steps and the window's data waits: the
    backward, the update, the loader's wait and the data wait read
    numbers; the halves' card time reads nothing without a card."""
    from perfbench.harness import trace
    from perfbench.run import run_cell
    monkeypatch.setattr(trace, 'Slice', _HostSlice)
    args = argparse.Namespace(workload=CELL, seed=2 ** 31 + 77,
                              seconds=0.3, trace=1)
    result, _, notes = run_cell(args, device='cpu',
                                inputs=_tiny_inputs(trace_steps=2))
    got = result['metrics']
    host = ('backward_host_ms.train', 'update_host_ms.train',
            'loader_wait_ms.train', 'data_wait_ms.train')
    assert set(host) <= set(got), (got, notes)
    for name in host:
        assert got[name]['value'] > 0, name
    assert got['device_idle_share.train']['value'] == 100.0
    assert 'gan_train_mfu' in got
    assert not {'gan_disc_update_ms.train',
                'gan_gen_update_ms.train'} & set(got)
    steps = [s for s in profiling.spans() if s.name == profiling.STEP_SPAN]
    assert [s.step for s in steps] == [0, 1, 2, 3]
