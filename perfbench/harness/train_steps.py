"""Traffic kind `train_steps`: the student's training step as
`train_forward` runs it, `train/common.py:train_step` over the port's
data layer (`get_tts_datasets` -> `BucketBatcher` with the native loader,
`Prefetcher`, `batch_to_device`), one optimizer step after another for
the window.

Set-up writes the LJSpeech-like dataset, builds the model and Adam from
the seed, and drives that same object through its first steps: the
three that the check follows, then until every bucket's shape has run.
The window counts the steps completed until `seconds` have passed and
ends on a synchronise. The check (after the window, the program freed)
runs the plain reference's three steps from the same weights on batches
it reads itself from the raw files, and compares each step's loss, the
norm of each leaf's first gradient as Adam received it (its first moment
over 1 - beta1) and the norm of each leaf's change after the three.
"""
from __future__ import annotations

import gc
import shutil
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from perfbench.harness import flops
from perfbench.harness.dataset import write_dataset
from perfbench.harness.weights import draw, sub_seed
from perfbench.reference import batch as ref_batch
from perfbench.reference import fast_pitch as ref_fp
from perfbench.reference import forward_tacotron as ref_ft
from perfbench.reference import train as ref_train
from perfbench.reference.spec import duration_head

CHECK_STEPS = 3
REFERENCES = {'forward_tacotron': ref_ft, 'fast_pitch': ref_fp}


def _first_session(train_cfg: Dict[str, Any]):
    lr, _, bs = [float(v) for v in
                 str(train_cfg['schedule'][0]).split(',')]
    return lr, int(bs)


class TrainCell:

    def __init__(self, cfg: Dict[str, Any], traffic: Dict[str, Any],
                 seed: int, device: str = 'cuda') -> None:
        self.cfg = cfg
        self.traffic = traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.kind = cfg['tts_model']
        self.train_cfg = cfg[self.kind]['training']
        self.lr, self.batch_size = _first_session(self.train_cfg)
        if 'batch_size' in traffic:
            self.batch_size = int(traffic['batch_size'])
        self.ref = REFERENCES[self.kind]
        self.step_seed = sub_seed(self.seed, 2) % (2 ** 31)
        self.dropout_seed = sub_seed(self.seed, 3)
        self.tmp: Optional[Path] = None
        self.check_batches: List[Dict[str, Any]] = []
        self.program: Dict[str, Any] = {}
        self.shapes: List[tuple] = []        # (Tx, Tm, mel_len) a step
        self.data_wait_s: List[float] = []

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from forwardtacotron_tpu_torch.data.dataset import get_tts_datasets
        from forwardtacotron_tpu_torch.train import common as tc
        self.tc = tc
        clock = time.perf_counter()
        base = tempfile.gettempdir()
        self.tmp = Path(tempfile.mkdtemp(prefix='perfbench_train_', dir=base))
        write_dataset(self.tmp / 'data', self.traffic, self.seed)
        self.setup_parts = {'dataset_s': time.perf_counter() - clock}
        self.train_set, _ = get_tts_datasets(
            path=self.tmp / 'data', batch_size=self.batch_size, r=1,
            model_type='forward', max_mel_len=self.train_cfg['max_mel_len'],
            filter_attention=self.train_cfg['filter_attention'],
            filter_min_alignment=self.train_cfg['min_attention_alignment'],
            filter_min_sharpness=self.train_cfg['min_attention_sharpness'])
        self.setup_parts['batcher_s'] = time.perf_counter() - clock
        self.model = self._model()
        self.optimizer = tc.make_optimizer(self.model, self.lr)
        self._sync()
        self.setup_parts['model_s'] = time.perf_counter() - clock
        if self.device.type == 'cuda':
            torch.cuda.manual_seed(self.dropout_seed)
        else:
            torch.manual_seed(self.dropout_seed)
        self.feed = self._batches()
        self.n_steps = 0
        names = [n for n, _ in self.model.named_parameters()]
        params = dict(self.model.named_parameters())
        p0 = {n: params[n].detach().clone() for n in names}
        seen = set()
        buckets = len(self.train_set.buckets)
        while self.n_steps < CHECK_STEPS or len(seen) < buckets:
            raw, metrics = self.step(record=False)
            seen.add(tuple(raw['mel'].shape))
            if self.n_steps <= CHECK_STEPS:
                self.check_batches.append(
                    {'items': list(raw['item_id']), 'Tx': raw['x'].shape[1],
                     'Tm': raw['mel'].shape[1]})
                self.program.setdefault('losses', []).append(
                    float(metrics['loss']))
            if self.n_steps == 1:
                self.program['grad'] = self._first_gradients(params)
            if self.n_steps == CHECK_STEPS:
                self.program['change'] = {
                    n: float((params[n].detach() - p0[n]).norm())
                    for n in names}
                del p0
        self._sync()
        self.setup_parts['steps_s'] = time.perf_counter() - clock
        self.setup_parts['steps'] = self.n_steps

    def _first_gradients(self, params) -> Dict[str, float]:
        """Each leaf's gradient norm as Adam received it in the first step:
        its first moment over 1 - beta1 (0 where it holds none)."""
        beta1 = self.optimizer.param_groups[0]['betas'][0]
        out = {}
        for n, p in params.items():
            moment = self.optimizer.state.get(p, {}).get('exp_avg')
            out[n] = 0.0 if moment is None else \
                float(moment.norm()) / (1.0 - beta1)
        return out

    def _model(self) -> torch.nn.Module:
        if self.kind == 'fast_pitch':
            from forwardtacotron_tpu_torch.models.fast_pitch import FastPitch
            model = FastPitch.from_config(self.cfg)
        else:
            from forwardtacotron_tpu_torch.models.forward_tacotron import \
                ForwardTacotron
            model = ForwardTacotron.from_config(self.cfg)
        model = model.to(self.device)
        load_weights(model, self.weights())
        return model

    def weights(self) -> Dict[str, torch.Tensor]:
        entries = self.ref.weight_spec(self.cfg)
        if 'duration_frames' in self.cfg.get('assumed', {}):
            a = self.cfg['assumed']
            entries = duration_head(entries, 'dur_pred.lin',
                                    a['duration_frames'],
                                    a['duration_head_gain'])
        return draw(entries, self.seed, self.device)

    def _batches(self):
        from forwardtacotron_tpu_torch.data.dataset import Prefetcher
        epoch = 0
        while True:
            yield from Prefetcher(self.train_set.batches(epoch))
            epoch += 1

    def step(self, record: bool = True):
        """One step as the trainer runs it; returns the host batch and the
        step's metrics (device tensors)."""
        from forwardtacotron_tpu_torch.train.forward_trainer import \
            batch_to_device
        t0 = time.perf_counter()
        with torch.profiler.record_function('perfbench.data_wait'):
            raw = next(self.feed)
            batch = batch_to_device(raw, self.device)
        waited = time.perf_counter() - t0
        gen = torch.Generator(device=self.device).manual_seed(
            self.step_seed * 1_000_003 + self.n_steps)
        with torch.profiler.record_function('perfbench.train_step'):
            metrics = self.tc.train_step(self.model, self.optimizer, batch,
                                         gen, self.train_cfg)
        self.n_steps += 1
        if record:
            self.data_wait_s.append(waited)
            self.shapes.append((raw['x'].shape[1], raw['mel'].shape[1],
                                [int(v) for v in raw['mel_len']]))
        return raw, metrics

    def _sync(self) -> None:
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> Dict[str, float]:
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            self.step()
            n += 1
        self._sync()
        window_s = time.perf_counter() - t0
        self.window_s, self.window_steps = window_s, n
        return {'train_step_ms': 1e3 * window_s / max(n, 1)}

    def trace_slice(self, steps: int):
        """`steps` more steps with the card's activity profiled (the busy
        time, device time by kernel), then `steps` with the host's
        operations too (what the host did in the card's idle gaps); after
        the window, their shapes and waits kept apart from the window's."""
        from perfbench.harness.trace import Slice
        kept = len(self.shapes), len(self.data_wait_s)
        summaries = []
        for host_ops in (False, True):
            s = Slice(host_ops=host_ops)
            s.start()
            for _ in range(steps):
                self.step()
            s.stop()
            summaries.append(s.summary())
        self.traced_shapes = self.shapes[kept[0]:kept[0] + steps]
        del self.shapes[kept[0]:], self.data_wait_s[kept[1]:]
        out = summaries[0]
        out['idle_gaps'] = summaries[1]['idle_gaps']
        return out

    def context(self) -> Dict[str, Any]:
        """What the per-layer readers read."""
        peak = 'tf32' if torch.backends.cudnn.allow_tf32 else 'fp32'
        return {'kind': self.kind, 'cfg': self.cfg,
                'batch_size': self.batch_size, 'window_s': self.window_s,
                'window_steps': self.window_steps, 'shapes': self.shapes,
                'traced_shapes': getattr(self, 'traced_shapes', []),
                'data_wait_s': self.data_wait_s, 'peak': peak}

    def release(self) -> None:
        self.feed.close()
        del self.model, self.optimizer, self.feed
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def reference_run(self, dt=torch.float32, halve: bool = False
                      ) -> Dict[str, Any]:
        batches = [ref_batch.collate(self.tmp / 'data', b['items'], b['Tx'],
                                     b['Tm'], self.device)
                   for b in self.check_batches]
        if halve:
            batches = [ref_batch.half(b) for b in batches]
        P = self.weights()
        train_cfg = self.train_cfg

        def loss_of(params, i):
            if self.kind == 'fast_pitch':
                gen = torch.Generator(device=self.device).manual_seed(
                    self.step_seed * 1_000_003 + i)
                pred = ref_fp.forward(params, batches[i], self.cfg, gen, dt)
            else:
                if i == 0:
                    if self.device.type == 'cuda':
                        torch.cuda.manual_seed(self.dropout_seed)
                    else:
                        torch.manual_seed(self.dropout_seed)
                pred = ref_ft.forward(params, batches[i], self.cfg, dt)
            return ref_ft.loss(pred, batches[i], train_cfg)

        with strict_float32():
            out = ref_train.run_steps(P, loss_of, CHECK_STEPS, self.lr,
                                      float(train_cfg['clip_grad_norm']))
        names = list(self.program['grad'])
        return {'losses': out['losses'],
                'grad': {n: float(out['first_grad'][n].norm())
                         for n in names},
                'change': {n: float((out['final'][n] - P[n]).norm())
                           for n in names}}

    def compare(self, got: Dict[str, Any], ref: Dict[str, Any]
                ) -> Dict[str, float]:
        """The numbers compared: the largest relative loss gap of the three
        steps, the worst leaf's gap of first-gradient norms, and the worst
        leaf's gap of change norms over the leaves whose reference
        gradient is at least a thousandth of the median leaf's."""
        loss_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(got['losses'], ref['losses']))
        names = list(ref['grad'])
        grad = ref_train.leaf_gap(got['grad'], ref['grad'], names)
        moved = [n for n in names if ref['grad'][n] >= 1e-3 * grad['median']]
        change = ref_train.leaf_gap(got['change'], ref['change'], moved)
        return {'loss_gap': loss_gap, 'grad_gap': grad['gap'],
                'change_gap': change['gap'],
                'grad_gap_median': grad['median_gap'],
                'change_gap_median': change['median_gap'],
                '_grad_leaf': grad['leaf'], '_change_leaf': change['leaf'],
                '_left_out': sorted(set(names) - set(moved))}

    def cleanup(self) -> None:
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)


def load_weights(model: torch.nn.Module, weights: Dict[str, torch.Tensor]
                 ) -> None:
    """The drawn weights into the program's model, by name; every
    parameter of the model has to be among them."""
    missing, unexpected = model.load_state_dict(weights, strict=False)
    params = {n for n, _ in model.named_parameters()}
    if unexpected or params.intersection(missing):
        raise RuntimeError(f'weights do not fit the model: missing '
                           f'{sorted(params.intersection(missing))[:5]}, '
                           f'unexpected {unexpected[:5]}')


class strict_float32:
    """Within it, float32 products and convolutions on the card are
    float32, not TF32."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def model_flops(ctx: Dict[str, Any], shapes) -> float:
    return sum(flops.train_step_flops(ctx['cfg'], ctx['batch_size'], tx, tm)
               for tx, tm, _ in shapes)



def run(cfg, traffic, workload, args, t_start, device='cuda'
        ) -> Dict[str, Any]:
    """One run of a `train_steps` cell: set-up with the checked steps, the
    window, the traced slice, the card's readings, then the check."""
    from perfbench.harness.common import device_block
    cell = TrainCell(cfg, traffic, args.seed, device)
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
        notes = [f'train: set-up {cell.setup_parts}',
                 f'train: {cell.window_steps} steps in {cell.window_s!r} s; '
                 f'worst gradient leaf {numbers.pop("_grad_leaf")}, worst '
                 f'change leaf {numbers.pop("_change_leaf")}, left out of '
                 f'the change {numbers.pop("_left_out")}']
        return {'e2e': e2e, 'ctx': ctx, 'device': dev, 'check': numbers,
                'notes': notes, 'attempted': cell.window_steps, 'failed': 0}
    finally:
        cell.cleanup()
