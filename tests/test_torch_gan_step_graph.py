"""The GAN step's CUDA graphs (`train/hifigan_trainer.py:GANStepGraphs`).

On the CPU: which steps run eagerly (each case of `gan_train_step`'s
list, on stand-ins for the card's tensors), the STFT's window made once a
device (a capture may copy nothing from the host), and a checkpoint's
plain AdamW state.

On the card (marker `cuda`; no JAX here): graphed against eager from one
seed, the generator at 32 channels, 1024-sample segments, batch 2, the
whole MPD and MSD, over 5 steps in two segment lengths, both nets'
parameters and AdamW moments and the five losses, in float32 and with
`precision: bf16`; a learning rate set between replays; the spans of a
profiled replay and each half's card time read through the kernels'
launch calls (`perfbench/harness/span_kernels.py`). The graphed run is
held, tensor by tensor and loss by loss, to twice what two eager runs of
the same steps with the same (capturable) AdamW differ by, under
deterministic algorithms: bit for bit where those agree.
"""
import collections
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from forwardtacotron_tpu_torch.parallel import data_parallel
from forwardtacotron_tpu_torch.train import common as tc
from forwardtacotron_tpu_torch.train import hifigan_trainer as ht
from forwardtacotron_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
HOP, B = 256, 2
SEG_LENS = (1024, 2048)
ORDER = [0, 0, 1, 0, 1]           # 5 steps, two keys
LOSSES = ('disc_loss', 'gen_loss', 'gen_adv', 'gen_fm', 'gen_mel')
HALVES = ('ftt.gan.disc_update', 'ftt.gan.gen_update')


@pytest.fixture(autouse=True)
def _store(monkeypatch):
    monkeypatch.setattr(profiling, '_store', collections.deque(
        maxlen=profiling.STORE_SPANS))
    monkeypatch.setattr(profiling, '_steps', 0)


def small_config():
    cfg = json.loads((ROOT / 'perfbench/configs/hifigan_v1_ljspeech.json'
                      ).read_text())
    cfg['hifigan']['model']['upsample_initial_channel'] = 32
    return cfg


# ----------------------------------------------------------- on the CPU
class _Fake:
    def __init__(self, device='cuda:0'):
        self.device = torch.device(device)


class _FakeNet:
    def __init__(self, devices=('cuda:0',)):
        self.params = [_Fake(d) for d in devices]

    def parameters(self):
        return iter(self.params)


class _CardTensor(torch.Tensor):
    """A host tensor that says it lies on cuda:0."""

    @property
    def device(self):
        return torch.device('cuda:0')


def _card_tensor():
    return torch.zeros(2).as_subclass(_CardTensor)


def _eager_case(monkeypatch, case):
    """`_graph_device`'s answer where everything is as the graph path
    wants it (a card, both nets on cuda:0, torch's AdamW, no mesh) but
    `case`."""
    nets = [_FakeNet(), _FakeNet()]
    opts = [ht.make_gan_optimizer(torch.nn.Linear(2, 2)) for _ in range(2)]
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    batch = {'mel': _card_tensor(), 'audio': _card_tensor(),
             'index': np.zeros(2, np.int64)}
    if case == 'no card':
        monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    elif case == 'process group of two ranks':
        monkeypatch.setattr(torch.distributed, 'is_initialized',
                            lambda: True)
        monkeypatch.setattr(torch.distributed, 'get_world_size', lambda: 2)
    elif case == 'model axis':
        monkeypatch.setattr(tc, 'shards_of', lambda m: object())
    elif case == 'not AdamW':
        opts[1] = torch.optim.SGD(torch.nn.Linear(2, 2).parameters(),
                                  lr=0.1)
    elif case == 'fused AdamW':
        opts[0].param_groups[0]['fused'] = True
    elif case == 'nets on two cards':
        nets[1] = _FakeNet(('cuda:1',))
    elif case == 'nets on the host':
        nets = [_FakeNet(('cpu',)), _FakeNet(('cpu',))]
    elif case == 'audio on the host':
        batch['audio'] = torch.zeros(2)
    elif case == 'no mel':
        del batch['mel']
    if case == 'one-rank mesh':
        with data_parallel(types.SimpleNamespace(group=None, size=1)):
            return ht._graph_device(nets, opts, batch, None)
    return ht._graph_device(nets, opts, batch, None)


EAGER_CASES = ['no card', 'one-rank mesh', 'process group of two ranks',
               'model axis', 'not AdamW', 'fused AdamW', 'nets on two cards',
               'nets on the host', 'audio on the host', 'no mel']


def test_the_gan_graph_path_engages_where_nothing_forbids_it(monkeypatch):
    assert _eager_case(monkeypatch, None) == torch.device('cuda:0')


@pytest.mark.parametrize('case', EAGER_CASES)
def test_each_eager_gan_case_runs_eagerly(monkeypatch, case):
    assert _eager_case(monkeypatch, case) is None


def test_the_stft_window_is_made_once_a_device():
    from forwardtacotron_tpu_torch.dsp import stft
    a = stft._window(1024, 1024, torch.device('cpu'))
    assert stft._window(1024, 1024, 'cpu') is a
    assert torch.equal(a, torch.as_tensor(stft.hann_window(1024)))
    b = stft._window(800, 1024, 'cpu')
    assert b.shape == (1024,) and torch.equal(
        b[112:912], torch.as_tensor(stft.hann_window(800)))
    assert float(b[:112].abs().sum() + b[912:].abs().sum()) == 0.0


def test_a_gan_checkpoint_holds_a_plain_adamw_state(tmp_path):
    """`save_latest` writes both AdamW states as an eager run keeps
    them, whatever the graphs made of the optimizers."""
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.models.hifigan import make_generator
    from forwardtacotron_tpu_torch.utils.paths import Paths
    cfg = default_config()
    trainer = ht.HiFiGANTrainer(
        Paths(str(tmp_path / 'data'), 't', base=tmp_path, voc_id='v'),
        None, cfg, device='cpu')
    nets = [make_generator(small_config()), torch.nn.Linear(2, 2)]
    opts = [ht.make_gan_optimizer(n) for n in nets]
    for net, opt in zip(nets, opts):
        for p in net.parameters():
            p.grad = torch.ones_like(p)
        opt.step()
        tc._make_capturable(opt, list(net.parameters()), 'cpu')
    saved = {}
    trainer.ckpt = types.SimpleNamespace(
        save=lambda payload, path, on_complete=None: saved.update(payload))
    trainer.save_latest(*nets, *opts, step=1)
    for key in ('optim_g', 'optim_d'):
        state = saved[key]
        assert all(not g['capturable'] and isinstance(g['lr'], float)
                   for g in state['param_groups'])
        assert all(s['step'].device.type == 'cpu'
                   for s in state['state'].values())


# ----------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda:0')


@pytest.fixture
def deterministic():
    """cuDNN's and torch's deterministic algorithms, restored after: two
    eager runs of the same steps then agree bit for bit."""
    saved = (torch.backends.cudnn.deterministic,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.backends.cudnn.deterministic = saved[0]
    torch.use_deterministic_algorithms(saved[1], warn_only=saved[2])


def _parts(device, capturable=False, lr=2e-4):
    from forwardtacotron_tpu_torch.dsp.audio import DSP
    from forwardtacotron_tpu_torch.models.gan_discriminators import \
        HiFiGANDiscriminators
    from forwardtacotron_tpu_torch.models.hifigan import make_generator
    cfg = small_config()
    torch.manual_seed(0)
    gen = make_generator(cfg).to(device).train()
    disc = HiFiGANDiscriminators().to(device).train()
    if capturable:
        opts = [torch.optim.AdamW(n.parameters(), betas=(0.8, 0.99),
                                  weight_decay=0.01, capturable=True,
                                  lr=torch.tensor(lr, device=device))
                for n in (gen, disc)]
    else:
        opts = [ht.make_gan_optimizer(n, lr) for n in (gen, disc)]
    return (gen, disc, *opts,
            DSP.from_config(cfg, device=device).wav_to_mel_batch)


def _batch(i, seg_len, device):
    g = torch.Generator().manual_seed(100 + i)
    return {'mel': (torch.randn(B, seg_len // HOP, 80, generator=g) * 2 - 5
                    ).to(device),
            'audio': (0.1 * torch.randn(B, seg_len, generator=g)
                      ).clamp(-1, 1).to(device)}


def _run(device, step, capturable, half=None):
    gen, disc, gen_opt, disc_opt, to_mel = _parts(device, capturable)
    metrics = []
    for i, k in enumerate(ORDER):
        m = step(gen, disc, gen_opt, disc_opt, _batch(i, SEG_LENS[k], device),
                 to_mel, half)
        metrics.append({n: float(m[n]) for n in LOSSES})
    torch.cuda.synchronize()
    state = {}
    for name, net, opt in (('g', gen, gen_opt), ('d', disc, disc_opt)):
        for n, p in net.named_parameters():
            state[f'p.{name}.{n}'] = p.detach().clone()
            for key in ('exp_avg', 'exp_avg_sq'):
                state[f'{key}.{name}.{n}'] = opt.state[p][key].clone()
    return state, metrics, (gen, disc, gen_opt, disc_opt)


def _gaps(a, b):
    (sa, ma), (sb, mb) = a[:2], b[:2]
    out = {}
    for k in sb:
        norm = float(sb[k].norm())
        out[k] = float((sa[k] - sb[k]).norm()) / norm if norm > 0 \
            else float(sa[k].norm())
    out.update({f'metric{i}.{k}': abs(x[k] - y[k]) / max(abs(y[k]), 1e-30)
                for i, (x, y) in enumerate(zip(ma, mb)) for k in y})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize('precision', ['f32', 'bf16'])
def test_graphed_gan_steps_match_eager(cuda, deterministic, precision):
    """Five steps in two segment lengths: two captures, three replays;
    both nets' parameters, AdamW's moments and the losses as two eager
    runs with the same capturable AdamW give them."""
    half = torch.bfloat16 if precision == 'bf16' else None
    eager, again = (_run(cuda, ht._eager_gan_step, True, half)
                    for _ in range(2))
    graphed = _run(cuda, ht.gan_train_step, False, half)
    got, tol = _gaps(graphed, eager), _gaps(again, eager)
    print(f'{precision}: graphed against eager max {max(got.values()):.3g},'
          f' eager against eager max {max(tol.values()):.3g}')
    assert not {k: (got[k], tol[k]) for k in tol if got[k] > 2 * tol[k]}
    gen, disc, gen_opt, disc_opt = graphed[2]
    assert len(ht._GRAPHS[gen_opt].graphs) == 2
    for opt in (gen_opt, disc_opt):
        assert opt.param_groups[0]['capturable']
    for p in list(gen.parameters()) + list(disc.parameters()):
        assert p.grad is not None


@pytest.mark.cuda
def test_a_learning_rate_holds_at_the_next_gan_replay(cuda):
    gen, disc, gen_opt, disc_opt, to_mel = _parts(cuda)
    nets = list(gen.parameters()) + list(disc.parameters())

    def step(i):
        ht.gan_train_step(gen, disc, gen_opt, disc_opt,
                          _batch(i, SEG_LENS[0], cuda), to_mel)
        torch.cuda.synchronize()
        return [p.detach().clone() for p in nets]
    step(0)
    for opt in (gen_opt, disc_opt):
        tc.set_learning_rate(opt, 0.0)
    before = [p.detach().clone() for p in nets]
    held = step(1)
    assert all(torch.equal(a, b) for a, b in zip(before, held))
    for opt in (gen_opt, disc_opt):
        tc.set_learning_rate(opt, 2e-4)
    moved = step(2)
    assert any(not torch.equal(a, b) for a, b in zip(held, moved))
    assert len(ht._GRAPHS[gen_opt].graphs) == 1


@pytest.mark.cuda
def test_a_profiled_gan_replay_records_its_halves_and_their_card_time(cuda):
    """Under the profiler a replay records `ftt.train.step` with path
    'replay' around the two halves and nothing inside them; each half's
    card time, read through the kernels' launch calls, is some of the
    step's and both together are all of the work linked."""
    from torch.profiler import ProfilerActivity, profile

    from perfbench.harness.span_kernels import events_of, span_card_seconds
    gen, disc, gen_opt, disc_opt, to_mel = _parts(cuda)
    for i in (0, 1):                       # capture, then replay
        ht.gan_train_step(gen, disc, gen_opt, disc_opt,
                          _batch(i, SEG_LENS[0], cuda), to_mel)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in (2, 3):
            ht.gan_train_step(gen, disc, gen_opt, disc_opt,
                              _batch(i, SEG_LENS[0], cuda), to_mel)
        torch.cuda.synchronize()
    spans = profiling.spans()
    steps = [s for s in spans if s.name == profiling.STEP_SPAN]
    assert [s.attrs for s in steps] == [
        {'path': 'replay', 'B': B, 'seg_len': SEG_LENS[0]}] * 2
    for step in steps:
        mine = [s for s in spans if s.step == step.step and s is not step]
        assert [s.name for s in sorted(mine, key=lambda s: s.start_ns)] == [
            'ftt.gan.disc_update', 'ftt.gan.gen_update']
        assert all(s.parent == step.id for s in mine)
    halves = span_card_seconds(events_of(prof), HALVES)
    assert halves is not None, 'no kernel linked to its launch call'
    d, g = (halves['seconds'][n] for n in HALVES)
    assert d and g and d > 0 and g > 0
    assert halves['unlinked'] == 0
