"""Traffic kind `gan_steps`: the GAN vocoder's adversarial training step
as `HiFiGANTrainer.train_session` runs it: `get_gan_vocoder_datasets` ->
the train `VocBatcher`'s `batches(epoch)` -> `Prefetcher` ->
`voc_trainer.batch_to_device` -> `gan_train_step`, with the generator
(`make_generator`), the discriminators (`HiFiGANDiscriminators`) and
both AdamW (`make_gan_optimizer`) as `train_hifigan` builds them, at the
learning rate of the schedule's first session. On the card each half of
the step replays a CUDA graph (`GANStepGraphs`), captured at the first
step.

Set-up writes the vocoder dataset, builds both nets from the seed and
drives them through their first steps: the three that the check follows
and two more. The window counts the steps completed (one update of the
discriminators and one of the generator each) until `seconds` have
passed and ends on a synchronise. A traced run profiles `trace_steps`
more steps with the card's activity alone (busy time, kernels), then as
many with the host's operations too (idle gaps, and each half's card
time: the work launched while `ftt.gan.disc_update` or
`ftt.gan.gen_update` was open, `harness/span_kernels.py`); the readers
of the port's host spans (`harness/spans.py`) read the card-only steps,
as in the student's cells, and `data_wait_ms.train` the window's waits
for the next batch and its copy. The check
(after the window, the program freed) runs the plain reference
(`perfbench/reference/hifigan_gan.py`) for the three steps from the same
weights, on the segments it reads from the raw files at the rows and
offsets the batches reported, and compares each step's five losses and,
for either net, each leaf's first gradient as AdamW received it (its
first moment over 1 - beta1) and each leaf's change after the three.

    python3 -m perfbench.harness.gan_steps --seeds 1,2,3 [--control]
        [--no-tf32]

prints, for each seed, the program's readings of the compared numbers
and, with --control, those of the reference in bfloat16 (as the
trainer's `precision: bf16` computes) and of the reference on half of
each batch, from which the cell's limits were set. With --no-tf32 the
program's convolutions and matmuls run in float32 without TF32, as the
reference's do, which shows how much of its gaps TF32 makes.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from perfbench.harness.gan_flops import gan_step_flops
from perfbench.harness.train_steps import load_weights, strict_float32
from perfbench.harness.voc_dataset import write_voc_dataset
from perfbench.harness.weights import draw, sub_seed
from perfbench.reference import hifigan_gan as ref
from perfbench.reference.train import leaf_gap

CHECK_STEPS = 3
WARM_STEPS = 2
HALVES = ('ftt.gan.disc_update', 'ftt.gan.gen_update')
DISC_PREFIXES = ('mpd.', 'msd.')


def draw_weights(cfg: Dict[str, Any], seed: int, device
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{'gen', 'disc'}: every tensor of both nets from the run's seed, the
    uniform ones in one draw (`harness/weights.py`), the normal ones in
    another of their own stream."""
    entries = (ref.generator_spec(cfg['hifigan']['model'],
                                  cfg['dsp']['num_mels'])
               + ref.discriminator_spec())
    out = draw([e for e in entries if e[2][0] != 'normal'], seed, device)
    normal = [e for e in entries if e[2][0] == 'normal']
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 4))
    flat = torch.randn(sum(math.prod(s) for _, s, _ in normal),
                       generator=gen, device=device)
    at = 0
    for name, shape, (_, std) in normal:
        n = math.prod(shape)
        out[name] = (flat[at:at + n] * std).reshape(shape)
        at += n
    return {'gen': {n: w for n, w in out.items()
                    if not n.startswith(DISC_PREFIXES)},
            'disc': {n: w for n, w in out.items()
                     if n.startswith(DISC_PREFIXES)}}


class GANCell:

    def __init__(self, cfg: Dict[str, Any], traffic: Dict[str, Any],
                 seed: int, device: str = 'cuda') -> None:
        self.cfg = cfg
        self.traffic = traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.train_cfg = cfg['hifigan']['training']
        self.lr = float(str(self.train_cfg['schedule'][0]).split(',')[0])
        self.batch_size = int(traffic['batch_size'])
        self.seg_len = int(traffic['seg_len'])
        self.tmp: Optional[Path] = None
        self.check_batches: List[Dict[str, List[int]]] = []
        self.program: Dict[str, Any] = {}
        self.halves: Optional[Dict[str, Any]] = None
        self.traced_steps = 0
        self.data_wait_s: List[float] = []

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from forwardtacotron_tpu_torch.data.dataset import \
            get_gan_vocoder_datasets
        from forwardtacotron_tpu_torch.dsp.audio import DSP
        from forwardtacotron_tpu_torch.models.gan_discriminators import \
            HiFiGANDiscriminators
        from forwardtacotron_tpu_torch.models.hifigan import make_generator
        from forwardtacotron_tpu_torch.train import common as tc
        from forwardtacotron_tpu_torch.train.hifigan_trainer import \
            make_gan_optimizer
        clock = [time.perf_counter()]
        self.setup_parts: Dict[str, float] = {}

        def lap(part: str) -> None:
            now = time.perf_counter()
            self.setup_parts[part] = now - clock[0]
            clock[0] = now

        self.tmp = Path(tempfile.mkdtemp(prefix='perfbench_gan_',
                                         dir=tempfile.gettempdir()))
        dsp_cfg = self.cfg['dsp']
        write_voc_dataset(self.tmp / 'data', self.traffic, dsp_cfg,
                          self.seed)
        lap('dataset_s')
        self.train_set, _, _ = get_gan_vocoder_datasets(
            path=self.tmp / 'data', batch_size=self.batch_size,
            train_gta=False, max_mel_len=self.train_cfg['max_mel_len'],
            hop_length=dsp_cfg['hop_length'], seg_len=self.seg_len,
            voc_mode=dsp_cfg['voc_mode'], bits=dsp_cfg['bits'],
            mu_law=dsp_cfg['mu_law'],
            num_gen_samples=self.train_cfg['num_gen_samples'])
        lap('batcher_s')
        torch.zeros(1, device=self.device)
        self._sync()
        lap('device_start_s')
        self.dsp = DSP.from_config(self.cfg, device=self.device)
        W = draw_weights(self.cfg, self.seed, self.device)
        self.gen = make_generator(self.cfg).to(self.device).train()
        self.disc = HiFiGANDiscriminators().to(self.device).train()
        load_weights(self.gen, W['gen'])
        load_weights(self.disc, W['disc'])
        del W
        self.gen_opt = make_gan_optimizer(self.gen)
        self.disc_opt = make_gan_optimizer(self.disc)
        for opt in (self.gen_opt, self.disc_opt):
            tc.set_learning_rate(opt, self.lr)
        self.half = tc.half_dtype(self.train_cfg)
        self._sync()
        lap('model_s')
        self.feed = self._batches()
        nets = {'gen': self.gen, 'disc': self.disc}
        p0 = {k: {n: p.detach().clone() for n, p in net.named_parameters()}
              for k, net in nets.items()}
        losses = []
        for i in range(1, CHECK_STEPS + WARM_STEPS + 1):
            raw, metrics = self.step()
            if i > CHECK_STEPS:
                continue
            if 'offset' not in raw:
                raise SystemExit('perfbench: the program\'s GAN batches '
                                 'report no row indices and crop offsets; '
                                 'the check cannot read their segments')
            self.check_batches.append({'index': raw['index'].tolist(),
                                       'offset': raw['offset'].tolist()})
            losses.append([float(metrics[k]) for k in ref.LOSSES])
            if i == 1:
                self.program['grad'] = {
                    'gen': self._first_gradients(self.gen, self.gen_opt),
                    'disc': self._first_gradients(self.disc, self.disc_opt)}
            if i == CHECK_STEPS:
                self.program['change'] = {
                    k: {n: float((p.detach() - p0[k][n]).norm())
                        for n, p in net.named_parameters()}
                    for k, net in nets.items()}
                del p0
        self.program['losses'] = losses
        self._sync()
        lap('steps_s')

    @staticmethod
    def _first_gradients(net, opt) -> Dict[str, float]:
        beta1 = opt.param_groups[0]['betas'][0]
        out = {}
        for n, p in net.named_parameters():
            moment = opt.state.get(p, {}).get('exp_avg')
            out[n] = 0.0 if moment is None else \
                float(moment.norm()) / (1.0 - beta1)
        return out

    def _batches(self):
        from forwardtacotron_tpu_torch.data.dataset import Prefetcher
        epoch = 0
        while True:
            yield from Prefetcher(self.train_set.batches(epoch))
            epoch += 1

    def step(self, record: bool = False):
        """One step as `train_session` runs it; the host batch and the
        step's metrics (device tensors). With `record`, the wait for the
        batch and its copy is kept for `data_wait_ms.train`."""
        from forwardtacotron_tpu_torch.train.hifigan_trainer import \
            gan_train_step
        from forwardtacotron_tpu_torch.train.voc_trainer import \
            batch_to_device
        t0 = time.perf_counter()
        with torch.profiler.record_function('perfbench.data_wait'):
            raw = next(self.feed)
            batch = batch_to_device(raw, self.device)
        if record:
            self.data_wait_s.append(time.perf_counter() - t0)
        with torch.profiler.record_function('perfbench.train_step'):
            metrics = gan_train_step(self.gen, self.disc, self.gen_opt,
                                     self.disc_opt, batch,
                                     self.dsp.wav_to_mel_batch, self.half)
        return raw, metrics

    def _sync(self) -> None:
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> Dict[str, float]:
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            self.step(record=True)
            n += 1
        self._sync()
        self.window_s, self.window_steps = time.perf_counter() - t0, n
        return {'train_step_ms': 1e3 * self.window_s / max(n, 1)}

    def trace_slice(self, steps: int) -> Dict[str, Any]:
        """`steps` steps with the card's activity profiled (busy time,
        kernels), then `steps` with the host's operations too (idle gaps,
        the halves' card time)."""
        from perfbench.harness.span_kernels import (events_of,
                                                    span_card_seconds)
        from perfbench.harness.trace import Slice
        summaries = []
        for host_ops in (False, True):
            s = Slice(host_ops=host_ops)
            s.start()
            for _ in range(steps):
                self.step()
            s.stop()
            summaries.append(s.summary())
        self.halves = span_card_seconds(events_of(s.prof), HALVES)
        self.traced_steps = steps
        self.host_slice = summaries[1]
        out = summaries[0]
        out['idle_gaps'] = summaries[1]['idle_gaps']
        return out

    def context(self) -> Dict[str, Any]:
        """What the per-layer readers read."""
        peak = 'tf32' if torch.backends.cudnn.allow_tf32 else 'fp32'
        return {'kind': 'gan', 'cfg': self.cfg,
                'batch_size': self.batch_size, 'seg_len': self.seg_len,
                'window_s': self.window_s, 'window_steps': self.window_steps,
                'peak': peak, 'gan_halves': self.halves,
                'gan_traced_steps': self.traced_steps,
                'traced_shapes':
                    [(self.batch_size, self.seg_len)] * self.traced_steps,
                'data_wait_s': self.data_wait_s,
                'step_flops': gan_step_flops(self.cfg, self.batch_size,
                                             self.seg_len)}

    def traced_notes(self) -> List[str]:
        if self.halves is None:
            return ['gan: the traced slice shows no halves to read']
        host = self.host_slice
        n = self.traced_steps
        halves = {k: None if v is None else 1e3 * v / n
                  for k, v in self.halves['seconds'].items()}
        idle = 1e3 * (host['window_s'] - host['busy_s']) / n
        step = 1e3 * host['window_s'] / n
        known = sum(v for v in halves.values() if v is not None) + idle
        return [f'gan: host-traced slice {step!r} ms a step: halves (card '
                f'ms) {halves}, idle {idle!r} ms, their sum over the step '
                f'{known / step!r}; work linked to its launch '
                f'{self.halves["linked"]}, unlinked '
                f'{self.halves["unlinked"]}']

    def release(self) -> None:
        self.feed.close()
        del self.gen, self.disc, self.gen_opt, self.disc_opt, self.feed
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def reference_run(self, dt=torch.float32, halve: bool = False
                      ) -> Dict[str, Any]:
        dsp = self.cfg['dsp']
        batches = [ref.read_batch(self.tmp / 'data', b['index'],
                                  b['offset'], self.seg_len,
                                  dsp['hop_length'],
                                  self.train_cfg['max_mel_len'], self.device)
                   for b in self.check_batches]
        if halve:
            batches = [ref.half(b) for b in batches]
        W = draw_weights(self.cfg, self.seed, self.device)
        with strict_float32():
            out = ref.run_steps(W['gen'], W['disc'], batches,
                                self.cfg['hifigan']['model'], dsp, self.lr,
                                dt)
        return {'losses': out['losses'],
                'grad': {k: {n: float(g.norm()) for n, g in grads.items()}
                         for k, grads in out['first_grad'].items()},
                'change': {k: {n: float((out['final'][k][n] - w).norm())
                               for n, w in W[k].items()} for k in W}}

    @staticmethod
    def compare(got: Dict[str, Any], want: Dict[str, Any]
                ) -> Dict[str, Any]:
        """The largest relative gap of the steps' losses; for either net
        the worst and the median leaf's gaps of first-gradient norms, and
        of change norms over the leaves whose reference gradient is at
        least a thousandth of the median leaf's."""
        out: Dict[str, Any] = {'loss_gap': max(
            abs(a - b) / abs(b) for g, w in zip(got['losses'],
                                                want['losses'])
            for a, b in zip(g, w))}
        for net in ('gen', 'disc'):
            names = list(want['grad'][net])
            grad = leaf_gap(got['grad'][net], want['grad'][net], names)
            moved = [n for n in names
                     if want['grad'][net][n] >= 1e-3 * grad['median']]
            change = leaf_gap(got['change'][net], want['change'][net], moved)
            out.update({f'{net}_grad_gap': grad['gap'],
                        f'{net}_grad_gap_median': grad['median_gap'],
                        f'{net}_change_gap': change['gap'],
                        f'{net}_change_gap_median': change['median_gap'],
                        f'_{net}_leaves': (grad['leaf'], change['leaf'],
                                           sorted(set(names) - set(moved)))})
        return out

    def cleanup(self) -> None:
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)


def run(cfg, traffic, workload, args, t_start, device='cuda'
        ) -> Dict[str, Any]:
    """One run of a `gan_steps` cell: set-up with the checked steps, the
    window, the traced slice, the card's readings, then the check."""
    from perfbench.harness.common import device_block
    cell = GANCell(cfg, traffic, args.seed, device)
    try:
        cell.setup()
        setup_s = time.perf_counter() - t_start
        e2e = cell.window(args.seconds)
        e2e['setup_s'] = setup_s
        summary = cell.trace_slice(int(workload['trace_steps'])) \
            if args.trace else None
        ctx = cell.context()
        ctx['trace'] = summary
        dev = device_block(1, summary) if device == 'cuda' else None
        cell.release()
        numbers = cell.compare(cell.program, cell.reference_run())
        leaves = {k: numbers.pop(f'_{k}_leaves') for k in ('gen', 'disc')}
        notes = [f'gan: set-up {cell.setup_parts}',
                 f'gan: {cell.window_steps} steps in {cell.window_s!r} s; '
                 f'worst gradient, worst change leaf and leaves left out of '
                 f'the change {leaves}']
        if args.trace:
            notes += cell.traced_notes()
        return {'e2e': e2e, 'ctx': ctx, 'device': dev, 'check': numbers,
                'notes': notes, 'attempted': cell.window_steps, 'failed': 0}
    finally:
        cell.cleanup()


def readings(cfg, traffic, seed: int, control: bool, device='cuda'
             ) -> List[Dict[str, Any]]:
    """The program's compared numbers at `seed` and, with `control`, the
    bfloat16 reference's and the half-batch reference's."""
    cell = GANCell(cfg, traffic, seed, device)
    try:
        cell.setup()
        cell.release()
        want = cell.reference_run()
        rows = [dict(cell.compare(cell.program, want), who='program',
                     losses=cell.program['losses'],
                     ref_losses=want['losses'])]
        if control:
            rows.append(dict(cell.compare(
                cell.reference_run(dt=torch.bfloat16), want),
                who='control_bf16'))
            rows.append(dict(cell.compare(cell.reference_run(halve=True),
                                          want), who='half_batch'))
        return rows
    finally:
        cell.cleanup()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description='Readings behind the limits '
                                            'of a gan_steps cell')
    p.add_argument('--workload', default='hifigan_v1_ljspeech.gan_b16')
    p.add_argument('--seeds', default='1')
    p.add_argument('--control', action='store_true')
    p.add_argument('--no-tf32', action='store_true')
    args = p.parse_args(argv)
    from perfbench.harness import common
    from perfbench.run import cell_inputs
    common.set_cache_dirs()
    _, cell, cfg, traffic, _ = cell_inputs(args.workload)
    common.require_cards(int(cell['chips']))
    if args.no_tf32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({'card': common.nvidia_smi_line(),
                      'workload': args.workload,
                      'tf32': torch.backends.cudnn.allow_tf32}), flush=True)
    for seed in (int(s) for s in args.seeds.split(',')):
        for row in readings(cfg, traffic, seed, args.control):
            print(json.dumps(dict(row, seed=seed), default=str), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
