"""Adversarial GAN vocoder trainer (HiFi-GAN or MelGAN generator).

Mirrors the JAX package's `train/hifigan_trainer.py`: the generator
(`models/hifigan.py:make_generator`, `hifigan.model.generator_type`
hifigan or melgan) trains against the MPD and MSD discriminators
(`models/gan_discriminators.py`) with the LSGAN, feature-matching and
mel-L1 losses (`train/gan_losses.py`), over the vocoders' data layout
(`--gta`: the student's ground-truth-aligned mels). A step updates the
discriminator on a detached generation, then the generator against the
updated discriminator, each with AdamW (betas 0.8 / 0.99, weight decay
0.01; the session's learning rate), as `build_gan_train_step` orders it.
On one CUDA device each half replays a CUDA graph of its own
(`GANStepGraphs`), so that the card, not the host's ~3,000 dispatches a
step, sets the pace; elsewhere the step runs eagerly.
Sessions follow the (lr, max_step, batch size) schedule with epoch-seeded
crops and mid-epoch resume; `evaluate()` scores the generator's mel L1 on
the validation batches at the end of every epoch; `generate_samples`
vocodes whole validation mels every `gen_samples_every` steps, and the
`keep_top_k` best generators by their mel L1 are kept. `precision: bf16`
runs both halves in bfloat16 as the JAX step does (the generator's
parameters and the mel cast, ŷ back to float32 for the mel L1; the
discriminators' parameters and both waveforms cast, their logits and
feature maps back to float32); the other options are refused, the JAX
trainer has none. Unlike the JAX trainer, `generate_samples` lets a
failure through.

Files: the generator is stored in the official weight-norm layout
(`weight_norm_state_dict`, under 'generator', with a config.json beside
it), which `models/hifigan.py:load_gan_vocoder` (and so `gen_forward
hifigan|melgan --voc_checkpoint`) and the JAX package's official-file
loader read. `latest_model.pt` also holds the discriminators, both
optimizers (a plain AdamW state, `utils/checkpoints.py:optimizer_state`),
the config and the step; `hifigan_step{k}k.pt` and the top-k
files the generator alone, all written off the step loop
(`AsyncCheckpointWriter`). The convolutions run on the card through
cuDNN. Under a mesh (`mesh=`, or a process group of more than one rank)
each rank trains on its rows of every global batch, both halves' gradients
averaged over the ranks before their updates, and rank 0 alone evaluates,
generates the samples, prints and writes (`train/common.py`, data
parallelism).
"""
from __future__ import annotations

import contextlib
import json
import time
import weakref
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Tuple)

import numpy as np
import torch

from forwardtacotron_tpu_torch.data.dataset import (Prefetcher,
                                                    get_gan_vocoder_datasets)
from forwardtacotron_tpu_torch.models.gan_discriminators import (
    HiFiGANDiscriminators)
from forwardtacotron_tpu_torch.models.hifigan import (
    fold_weight_norm, vocode_generator, weight_norm_state_dict)
from forwardtacotron_tpu_torch.train import common as tc
from forwardtacotron_tpu_torch.train.gan_losses import (
    discriminator_loss, feature_matching_loss, generator_adversarial_loss,
    mel_l1_loss)
from forwardtacotron_tpu_torch.train.voc_trainer import batch_to_device
from forwardtacotron_tpu_torch.utils.checkpoints import optimizer_state
from forwardtacotron_tpu_torch.utils.display import log_audio, simple_table
from forwardtacotron_tpu_torch.utils.files import parse_schedule
from forwardtacotron_tpu_torch.utils.paths import Paths
from forwardtacotron_tpu_torch.utils.profiling import (
    STEP_SPAN, StepTraceController, annotate)


def make_gan_optimizer(model: torch.nn.Module, lr: float = 2e-4
                       ) -> torch.optim.AdamW:
    """AdamW with the official betas (0.8, 0.99) and weight decay 0.01:
    torch's decoupled decay p(1 - lr wd) - lr adam equals optax's
    `adamw` update."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.8, 0.99),
                             weight_decay=0.01)


def _generate(gen: torch.nn.Module, mel: torch.Tensor,
              half: Optional[torch.dtype]) -> torch.Tensor:
    return tc.full(tc.forward_model(gen, mel, half=half))


def _disc_backward(gen: torch.nn.Module, disc: HiFiGANDiscriminators,
                   mel: torch.Tensor, y: torch.Tensor,
                   half: Optional[torch.dtype]) -> Dict[str, torch.Tensor]:
    """The discriminators' loss on a detached generation, and its
    backward."""
    with torch.no_grad(), annotate('ftt.gan.generator'):
        y_hat = _generate(gen, mel, half)
    with annotate('ftt.gan.discriminators'):
        logits_r, logits_g, _, _ = tc.full(tc.forward_model(
            disc, y, y_hat, half=half))
    d_loss = discriminator_loss(logits_r, logits_g)
    with annotate('ftt.train.backward'):
        d_loss.backward()
    return {'disc_loss': d_loss}


def _gen_backward(gen: torch.nn.Module, disc: HiFiGANDiscriminators,
                  mel: torch.Tensor, y: torch.Tensor,
                  wav_to_mel: Callable[[torch.Tensor], torch.Tensor],
                  half: Optional[torch.dtype]) -> Dict[str, torch.Tensor]:
    """The generator's losses against the discriminators as they are, and
    their backward (no gradient for the discriminators)."""
    disc.requires_grad_(False)
    try:
        with annotate('ftt.gan.generator'):
            y_hat = _generate(gen, mel, half)
        with annotate('ftt.gan.discriminators'):
            _, logits_g, fmaps_r, fmaps_g = tc.full(tc.forward_model(
                disc, y, y_hat, half=half))
        adv = generator_adversarial_loss(logits_g)
        fm = feature_matching_loss(fmaps_r, fmaps_g)
        with annotate('ftt.gan.mel'):
            mel_l = mel_l1_loss(wav_to_mel, y, y_hat)
        g_loss = adv + fm + mel_l
        with annotate('ftt.train.backward'):
            g_loss.backward()
    finally:
        disc.requires_grad_(True)
    return {'gen_loss': g_loss, 'gen_adv': adv, 'gen_fm': fm,
            'gen_mel': mel_l}


def _update(net: torch.nn.Module, opt: torch.optim.Optimizer,
            losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    metrics = {k: v.detach() for k, v in losses.items()}
    tc.apply_update(net, opt, metrics, None)
    return metrics


def disc_step(gen: torch.nn.Module, disc: HiFiGANDiscriminators,
              disc_opt: torch.optim.Optimizer, mel: torch.Tensor,
              y: torch.Tensor, half: Optional[torch.dtype] = None
              ) -> torch.Tensor:
    """The discriminators' update on a detached generation of mel (B,
    n_mels, T), in `half` where given; returns the loss."""
    disc_opt.zero_grad(set_to_none=True)
    return _update(disc, disc_opt, _disc_backward(gen, disc, mel, y, half)
                   )['disc_loss']


def gen_step(gen: torch.nn.Module, disc: HiFiGANDiscriminators,
             gen_opt: torch.optim.Optimizer, mel: torch.Tensor,
             y: torch.Tensor,
             wav_to_mel: Callable[[torch.Tensor], torch.Tensor],
             half: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """The generator's update against the discriminators as they are (no
    gradient for them), in `half` where given; returns its losses."""
    gen_opt.zero_grad(set_to_none=True)
    return _update(gen, gen_opt,
                   _gen_backward(gen, disc, mel, y, wav_to_mel, half))


def _inputs(batch: Dict[str, torch.Tensor]):
    return batch['mel'].transpose(1, 2), batch['audio']


def _eager_gan_step(gen, disc, gen_opt, disc_opt, batch, wav_to_mel,
                    half=None) -> Dict[str, torch.Tensor]:
    """`gan_train_step` run eagerly, whatever the graph path would do."""
    mel, y = _inputs(batch)
    with annotate(STEP_SPAN, path='eager', B=int(y.shape[0]),
                  seg_len=int(y.shape[1])):
        with annotate('ftt.gan.disc_update'):
            d_loss = disc_step(gen, disc, disc_opt, mel, y, half)
        with annotate('ftt.gan.gen_update'):
            metrics = gen_step(gen, disc, gen_opt, mel, y, wav_to_mel, half)
    return {'disc_loss': d_loss, **metrics}


# what of a batch the step reads (a GAN batch also has the host's rows)
BATCH_KEYS = ('mel', 'audio')


class _Half(NamedTuple):
    """One captured half: its graph, metric names and packed output."""
    graph: Any
    keys: List[str]
    packed: torch.Tensor


class _GANGraph(NamedTuple):
    static: Dict[str, torch.Tensor]
    disc: _Half
    gen: _Half
    grads: List[List[Optional[torch.Tensor]]]


class GANStepGraphs:
    """The GAN step of one (generator, discriminators, their AdamW) as
    CUDA graphs, two per batch key (the batch's shapes and dtypes, the mel
    function, `half`): the discriminators' update and the generator's,
    captured apart and replayed in that order, each inside its span, from
    one memory pool; the gradients and AdamW's state are one set outside
    it. A key's first step is its capture (`_capture`): each half's
    forward and backward once with no update on a side stream (the first
    use of each cuDNN algorithm and cuFFT plan stays out of the capture),
    the gradients and buffers put back; both AdamW made capturable
    (`tc._make_capturable`); the halves captured (zero the gradients,
    forward, losses, backward, AdamW); then replayed for this very step as
    for every later one (`_replay`): the batch copied into the graphs'
    static inputs, each parameter's `.grad` set to the gradient its graph
    wrote. The nets hold no random draw. A change of what the graphs hold
    (`fits`) drops them all."""

    def __init__(self, nets: Tuple[torch.nn.Module, torch.nn.Module],
                 opts: Tuple[torch.optim.Optimizer, torch.optim.Optimizer],
                 device: torch.device) -> None:
        self.nets, self.opts, self.device = nets, opts, device
        self.params = [list(net.parameters()) for net in nets]
        self.ptrs = self._ptrs()
        self.opt_states = [opt.state for opt in opts]
        self.groups = [list(opt.param_groups) for opt in opts]
        self.pool = torch.cuda.graph_pool_handle()
        self.grads: List[Dict[int, torch.Tensor]] = [{}, {}]
        self.lrs: List[List[Any]] = [[], []]
        self.graphs: Dict[tuple, _GANGraph] = {}

    def _ptrs(self) -> tuple:
        return tuple(p.data_ptr() for ps in self.params for p in ps)

    def fits(self, nets, opts) -> bool:
        return all(a is b for a, b in zip(nets, self.nets)) \
            and all(o.state is s and len(o.param_groups) == len(g)
                    and all(a is b for a, b in zip(o.param_groups, g))
                    for o, s, g in zip(opts, self.opt_states, self.groups)) \
            and self._ptrs() == self.ptrs

    def step(self, batch, wav_to_mel, half) -> Dict[str, torch.Tensor]:
        key = (tuple((k, batch[k].shape, batch[k].dtype)
                     for k in BATCH_KEYS), wav_to_mel, half)
        graph = self.graphs.get(key)
        B, seg_len = batch['audio'].shape
        with annotate(STEP_SPAN,
                      path='replay' if graph is not None else 'capture',
                      B=int(B), seg_len=int(seg_len)):
            if graph is None:
                graph = self.graphs[key] = self._capture(batch, wav_to_mel,
                                                         half)
            return self._replay(graph, batch)

    def _backward(self, static, wav_to_mel, half):
        """Both halves' forward and backward, with no update."""
        gen, disc = self.nets
        mel, y = _inputs(static)
        return (_disc_backward(gen, disc, mel, y, half),
                _gen_backward(gen, disc, mel, y, wav_to_mel, half))

    def _warm_up(self, static, wav_to_mel, half) -> List[List[bool]]:
        """Each half's forward and backward on a side stream, then `.grad`
        and the buffers put back. Returns which parameters of each net got
        a gradient."""
        dev = self.device
        saved = [[p.grad for p in ps] for ps in self.params]
        buffers = [b.detach().clone()
                   for net in self.nets for b in net.buffers()]
        for ps in self.params:
            for p in ps:
                p.grad = None
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._backward(static, wav_to_mel, half)
        torch.cuda.current_stream(dev).wait_stream(side)
        trained = [[p.grad is not None for p in ps] for ps in self.params]
        for ps, grads in zip(self.params, saved):
            for p, grad in zip(ps, grads):
                p.grad = grad
        with torch.no_grad():
            for b, value in zip((b for net in self.nets
                                 for b in net.buffers()), buffers):
                b.copy_(value)
        return trained

    def _capture(self, batch, wav_to_mel, half) -> _GANGraph:
        static = {k: batch[k].clone() for k in BATCH_KEYS}
        trained = self._warm_up(static, wav_to_mel, half)
        grads: List[List[Optional[torch.Tensor]]] = []
        for i, (opt, ps, t) in enumerate(zip(self.opts, self.params,
                                             trained)):
            tc._make_capturable(opt, [p for p, ok in zip(ps, t) if ok],
                                self.device)
            self.lrs[i] = [g['lr'] for g in opt.param_groups]
            net_grads = []
            for j, (p, ok) in enumerate(zip(ps, t)):
                if ok and j not in self.grads[i]:
                    self.grads[i][j] = torch.zeros_like(p)
                net_grads.append(self.grads[i][j] if ok else None)
                p.grad = net_grads[-1]
            grads.append(net_grads)
        (gen, disc), (gen_opt, disc_opt) = self.nets, self.opts
        mel, y = _inputs(static)

        def half_graph(live, body) -> _Half:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode='thread_local'):
                if live:
                    torch._foreach_zero_(live)
                metrics = body()
                keys = list(metrics)
                packed = torch.stack([metrics[k].float() for k in keys])
            return _Half(graph, keys, packed)

        live = [[g for g in net_grads if g is not None]
                for net_grads in grads]
        d = half_graph(live[1], lambda: _update(
            disc, disc_opt, _disc_backward(gen, disc, mel, y, half)))
        g = half_graph(live[0], lambda: _update(
            gen, gen_opt, _gen_backward(gen, disc, mel, y, wav_to_mel,
                                        half)))
        return _GANGraph(static, d, g, grads)

    def _replay(self, g: _GANGraph, batch) -> Dict[str, torch.Tensor]:
        torch._foreach_copy_([g.static[k] for k in BATCH_KEYS],
                             [batch[k] for k in BATCH_KEYS])
        for opt, lrs in zip(self.opts, self.lrs):
            for group, lr in zip(opt.param_groups, lrs):
                if group['lr'] is not lr:       # a float put there directly
                    lr.fill_(float(group['lr']))
                    group['lr'] = lr
        with annotate('ftt.gan.disc_update'):
            g.disc.graph.replay()
        with annotate('ftt.gan.gen_update'):
            g.gen.graph.replay()
        for ps, grads in zip(self.params, g.grads):
            for p, grad in zip(ps, grads):
                if p.grad is not grad:
                    p.grad = grad
        return {k: v for half in (g.disc, g.gen)
                for k, v in zip(half.keys, half.packed.clone().unbind(0))}


# the GAN step graphs of each generator optimizer (dropped with it)
_GRAPHS: 'weakref.WeakKeyDictionary[torch.optim.Optimizer, GANStepGraphs]' \
    = weakref.WeakKeyDictionary()


def _graph_device(nets, opts, batch, graphs: Optional[GANStepGraphs]
                  ) -> Optional[torch.device]:
    """The CUDA device on which `gan_train_step` runs as graphs (that of
    `graphs` where they still fit), or None where it runs eagerly (its
    list of cases)."""
    if not torch.cuda.is_available() or tc.active_mesh() is not None \
            or any(tc.shards_of(net) is not None for net in nets) \
            or (torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1) \
            or any(type(opt) not in (torch.optim.Adam, torch.optim.AdamW)
                   or any(g.get('fused') or g.get('differentiable')
                          for g in opt.param_groups) for opt in opts):
        return None
    devices = {graphs.device} if graphs is not None \
        else {p.device for net in nets for p in net.parameters()}
    if len(devices) != 1:
        return None
    (dev,) = devices
    if dev.type != 'cuda' or any(
            not torch.is_tensor(batch.get(k)) or batch[k].device != dev
            for k in BATCH_KEYS):
        return None
    return dev


def gan_train_step(gen: torch.nn.Module, disc: HiFiGANDiscriminators,
                   gen_opt: torch.optim.Optimizer,
                   disc_opt: torch.optim.Optimizer,
                   batch: Dict[str, torch.Tensor],
                   wav_to_mel: Callable[[torch.Tensor], torch.Tensor],
                   half: Optional[torch.dtype] = None
                   ) -> Dict[str, torch.Tensor]:
    """One step: the discriminators on a detached generation, then the
    generator against the updated discriminators, each in `half` where
    given. batch: 'mel' (B, T, n_mels) time-major, 'audio' (B, T * hop).
    Returns device tensors.

    Where both nets lie on one CUDA device, the halves replay the CUDA
    graphs of the batch key (`GANStepGraphs`; captured at the key's first
    step, which is a replay too) and both optimizers become capturable
    AdamW for good. The step runs eagerly for CPU tensors, inside
    `parallel.data_parallel` with a mesh of any size or with a process
    group of more than one rank up, over a 'model' axis, for an optimizer
    other than torch's Adam or AdamW (or a fused or differentiable one),
    and where 'mel' or 'audio' is not a tensor on that device. While a
    profiler records, the step is the span `ftt.train.step` (`path`
    'replay', 'capture' or 'eager', `B`, `seg_len`) around
    `ftt.gan.disc_update` and `ftt.gan.gen_update`; a replay records none
    of the spans inside those two."""
    nets, opts = (gen, disc), (gen_opt, disc_opt)
    graphs = _GRAPHS.get(gen_opt)
    if graphs is not None and not graphs.fits(nets, opts):
        del _GRAPHS[gen_opt]
        graphs = None
    dev = _graph_device(nets, opts, batch, graphs)
    if dev is None:
        return _eager_gan_step(gen, disc, gen_opt, disc_opt, batch,
                               wav_to_mel, half)
    if graphs is None:
        graphs = _GRAPHS[gen_opt] = GANStepGraphs(nets, opts, dev)
    return graphs.step(batch, wav_to_mel, half)


def generator_file(gen: torch.nn.Module) -> Dict[str, Any]:
    """The generator as an official checkpoint: {'generator': the
    weight-norm state_dict}."""
    return {'generator': weight_norm_state_dict(gen)}


def load_generator(gen: torch.nn.Module, payload: Dict[str, Any]) -> None:
    """Weights of a file written by `generator_file` (or a latest model)
    into `gen`, exactly as they were saved."""
    gen.load_state_dict(fold_weight_norm(payload['generator']))


class HiFiGANTrainer(tc.Logging):

    def __init__(self, paths: Paths, dsp, config: Dict[str, Any],
                 device='cuda', writer=None, mesh=None) -> None:
        self.paths = paths
        self.dsp = dsp
        self.config = config
        self.ranks = tc.Ranks(tc.trainer_mesh(config, mesh))
        self.device = self.ranks.device(device)
        self.train_cfg = config['hifigan']['training']
        tc.check_supported(self.train_cfg, 'gan')
        self.ckpt = self.ranks.writer()
        # FTT_PROFILE_DIR traces a window of steps
        self.tracer = StepTraceController()
        self.log_dir = paths.hifigan_log
        self.writer = writer
        self.preemption = tc.Preemption()
        self.top_k = tc.TopKTracker(
            paths.hifigan_top_k, k=int(self.train_cfg.get('keep_top_k', 3)),
            prefix='hifigan')
        model_cfg = {k: v for k, v in config['hifigan']['model'].items()
                     if k != 'generator_type'}
        if self.ranks.main:
            for d in (paths.hifigan_checkpoints, paths.hifigan_top_k):
                (d / 'config.json').write_text(json.dumps(model_cfg))

    def save_latest(self, gen, disc, gen_opt, disc_opt, step: int) -> None:
        """latest_model.pt of whole tensors (every rank calls it; rank 0
        writes it)."""
        with self.ranks.whole():
            self.ckpt.save({**generator_file(gen),
                            'discriminator': disc.state_dict(),
                            'optim_g': optimizer_state(gen_opt),
                            'optim_d': optimizer_state(disc_opt),
                            'config': self.config, 'step': int(step)},
                           self.paths.hifigan_checkpoints
                           / 'latest_model.pt')

    def train(self, gen: torch.nn.Module, disc: HiFiGANDiscriminators,
              gen_opt: Optional[torch.optim.Optimizer] = None,
              disc_opt: Optional[torch.optim.Optimizer] = None,
              step: int = 0, train_gta: bool = False,
              max_steps_override: Optional[int] = None) -> int:
        """Run the schedule from `step` on the trainer's device; the nets
        and optimizers are updated in place. Returns the final step."""
        gen.to(self.device).train()
        disc.to(self.device).train()
        gen_opt = gen_opt or make_gan_optimizer(gen)
        disc_opt = disc_opt or make_gan_optimizer(disc)
        self.ranks.start([gen, disc])
        self.ranks.shard([gen, disc], [gen_opt, disc_opt])
        schedule = parse_schedule(self.train_cfg['schedule'])
        session_start = 0
        with self.preemption, contextlib.closing(self.tracer), \
                self.ranks.output():
            for i, (lr, max_step, bs) in enumerate(schedule, 1):
                prev_max, session_start = session_start, max_step
                if self.ranks.stop(self.preemption):
                    break
                if max_steps_override is not None:
                    max_step = min(max_step, max_steps_override)
                if step >= max_step:
                    continue
                train_set, val_set, val_set_samples = \
                    get_gan_vocoder_datasets(
                        path=self.paths.data, batch_size=bs,
                        train_gta=train_gta,
                        max_mel_len=self.train_cfg['max_mel_len'],
                        hop_length=self.dsp.hop_length,
                        seg_len=self.train_cfg['seg_len'],
                        voc_mode=self.dsp.voc_mode, bits=self.dsp.bits,
                        mu_law=self.dsp.mu_law,
                        num_gen_samples=self.train_cfg['num_gen_samples'])
                session = tc.VocSession(
                    index=i, lr=lr, max_step=max_step, bs=bs,
                    train_set=train_set, val_set=val_set,
                    val_set_samples=val_set_samples, start_step=prev_max)
                step = self.train_session(gen, disc, gen_opt, disc_opt,
                                          step, session, train_gta)
        self.ranks.finish()
        self._flush_writer()
        return step

    def train_session(self, gen, disc, gen_opt, disc_opt, step: int,
                      session: tc.VocSession, train_gta: bool) -> int:
        total_iters = len(session.train_set)
        epoch0, offset0 = tc.resume_position(step, session.start_step,
                                             total_iters)
        epochs = max((session.max_step - step + offset0)
                     // max(total_iters, 1) + 1, 1)
        simple_table([('Remaining', f'{session.max_step - step} Steps'),
                      ('Batch Size', session.bs), ('LR', session.lr),
                      ('Segment Len', self.train_cfg['seg_len']),
                      ('GTA Train', train_gta), ('Device', self.device)])
        tc.set_learning_rate(gen_opt, session.lr)
        tc.set_learning_rate(disc_opt, session.lr)
        half = tc.half_dtype(self.train_cfg)
        loss_avg, duration_avg = tc.Averager(), tc.Averager()
        last_t = time.time()

        def flush_metrics(metrics, pstep, pe, pi) -> None:
            nonlocal last_t
            values = {k: float(v) for k, v in metrics.items()}  # waits
            loss_avg.add(values['gen_loss'])
            now = time.time()
            duration_avg.add(now - last_t)
            last_t = now
            speed = 1.0 / max(duration_avg.get(), 1e-9)
            print(f'| Epoch: {pe}/{epochs} ({pi}/{total_iters}) '
                  f'| Gen: {loss_avg.get():#.4} '
                  f'| Disc: {values["disc_loss"]:#.4} | {speed:#.2} '
                  f'steps/s | Step: {pstep} | ', flush=True)
            for name, value in values.items():
                self._scalar(f'Loss/{name}', value, pstep)
            self._scalar('Params/learning_rate', session.lr, pstep)

        deferred = tc.DeferredFlush(flush_metrics)
        for e in range(1, epochs + 1):
            epoch = epoch0 + e - 1
            start = offset0 if epoch == epoch0 else 0
            batches = Prefetcher(session.train_set.batches(epoch, start))
            for i, batch in enumerate(batches, start + 1):
                with self.ranks.step():
                    metrics = gan_train_step(
                        gen, disc, gen_opt, disc_opt,
                        batch_to_device(self.ranks.rows(batch), self.device),
                        self.dsp.wav_to_mel_batch, half)
                step += 1
                self.tracer.tick(step)
                deferred.push(metrics, step, e, i)
                if step % self.train_cfg['gen_samples_every'] == 0:
                    with self.ranks.whole():
                        if self.ranks.main:
                            mel_loss = self.generate_samples(gen, session,
                                                             step)
                            if mel_loss is not None:
                                self.track_top_models(mel_loss, gen, step)
                    self.ranks.barrier()
                if step % self.train_cfg['checkpoint_every'] == 0:
                    with self.ranks.whole():
                        self.ckpt.save(
                            generator_file(gen),
                            self.paths.hifigan_checkpoints
                            / f'hifigan_step{step // 1000}k.pt')
                if self.ranks.stop(self.preemption):
                    print('| Preemption requested: saving latest_model and '
                          'stopping.')
                    break
                if step >= session.max_step:
                    break
            else:
                deferred.flush()
                with self.ranks.whole():
                    if self.ranks.main:
                        val_loss = self.evaluate(gen, session.val_set)
                        print(f'| Validation at step {step}: mel loss '
                              f'{val_loss:#.4}')
                        self._scalar('Loss/val_mel', val_loss, step)
                        self.save_latest(gen, disc, gen_opt, disc_opt, step)
                self.ranks.barrier()
                loss_avg.reset()
                duration_avg.reset()
                last_t = time.time()
                continue
            break  # max_step reached or preempted
        deferred.flush()
        self.save_latest(gen, disc, gen_opt, disc_opt, step)
        self.ckpt.wait()    # on disk before the session returns
        self.ranks.barrier()
        return step

    @torch.no_grad()
    def evaluate(self, gen: torch.nn.Module, val_set) -> float:
        """Mean mel L1 loss (x 45) of the generator over the validation
        batches."""
        total, n = 0.0, 0
        for batch in val_set:
            b = batch_to_device(batch, self.device)
            y_hat = gen(b['mel'].transpose(1, 2))
            total += float(mel_l1_loss(self.dsp.wav_to_mel_batch,
                                       b['audio'], y_hat))
            n += 1
        return total / max(n, 1)

    @torch.no_grad()
    def generate_samples(self, gen: torch.nn.Module,
                         session: tc.VocSession, step: int
                         ) -> Optional[float]:
        """Vocode each validation sample's whole mel and score the mel L1
        of the resynthesis against it; None without samples. A failure is
        raised, not swallowed."""
        mel_losses = []
        for idx, sample in enumerate(session.val_set_samples, 1):
            mel = sample['mel']                             # (n_mels, T)
            wav = np.asarray(vocode_generator(gen, mel), dtype=np.float32)
            gen_mel = self.dsp.wav_to_mel_bucketed(wav)
            t = min(gen_mel.shape[-1], mel.shape[-1])
            mel_losses.append(float(np.mean(
                np.abs(gen_mel[:, :t] - mel[:, :t]))))
            log_audio(self.writer, f'Samples/generated_{idx}', wav, step,
                      self.dsp.sample_rate,
                      fallback_dir=self.paths.hifigan_log / 'audio')
        if not mel_losses:
            return None
        mel_loss = float(np.mean(mel_losses))
        self._scalar('Loss/generated_mel_l1', mel_loss, step)
        return mel_loss

    def track_top_models(self, mel_loss: float, gen: torch.nn.Module,
                         step: int) -> None:
        """The top-k generators by generated mel L1."""
        self.top_k.update(mel_loss, step, lambda path, on_disk:
                          self.ckpt.save(generator_file(gen), path,
                                         on_complete=on_disk))
