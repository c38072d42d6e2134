"""Tacotron teacher trainer.

Mirrors the JAX package's `train/taco_trainer.py` (the reference's
trainer/taco_trainer.py): (r, lr, max_step, batch size) schedule
sessions, each with its own reduction factor r and epoch-seeded bucket
batches with mid-epoch resume; the plain (unmasked) L1 of the decoder
and the postnet outputs against the mel; global-norm clipping with
optax's formula, then Adam (`train/common.py`); metrics and the train
attention score read one step late; `evaluate()` in eval mode at the end
of every epoch (no gradient, so the BiGRUs take the inference kernel
#1), with the attention score of the validation batches;
`latest_model.pt` and `taco_step{k}k.pt` checkpoints, and the
`keep_top_k` (default 3) best by validation attention score in
`top_k_models/`, written off the step loop (`AsyncCheckpointWriter`);
graceful preemption. Dropout and zoneout draw from a `torch.Generator`
seeded with (seed, step), so a resumed run draws what an uninterrupted
one does. The step runs the options of the JAX step
(`build_taco_train_step`): `precision` (the parameters and the
teacher-forced mel cast to bfloat16; m1, m2 and the attention back to
float32), `grad_accum` (the attention re-assembled to the full batch)
and `remat` (the generator replayed for the recompute); `ema_decay` is
refused, the JAX teacher has none. Scalars go to stdout and to the
`writer` (`writer=`, an object with `add_scalar(tag, value, step)`, else a
tensorboardX `SummaryWriter` under `paths.taco_log` where tensorboardX is
installed). Every `plot_every` steps `generate_plots` writes JAX's figures
and Griffin-Lim audio samples: the teacher-forced attention and mels of
the first validation batch (`session.val_sample`), and a free-running
`Tacotron.generate` of its first item. Under a mesh (`mesh=`, or a process
group of more than one rank) each rank trains on its rows of every global
batch (the train attention score averaged over the ranks), the 'model'
axis keeps the weights in shards, and global rank 0 alone evaluates,
plots, prints and writes (`train/common.py`, data parallelism).
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from forwardtacotron_tpu_torch.align.metrics import attention_score
from forwardtacotron_tpu_torch.data.dataset import (Prefetcher,
                                                    get_tts_datasets)
from forwardtacotron_tpu_torch.train import common as tc
from forwardtacotron_tpu_torch.utils.checkpoints import checkpoint_payload
from forwardtacotron_tpu_torch.utils.display import (log_audio,
                                                     plot_attention, plot_mel)
from forwardtacotron_tpu_torch.utils.files import parse_schedule
from forwardtacotron_tpu_torch.utils.paths import Paths
from forwardtacotron_tpu_torch.utils.profiling import StepTraceController


def taco_batch_to_device(batch: Dict[str, Any], device
                         ) -> Dict[str, torch.Tensor]:
    """x, mel and mel_len on `device`, with a multi-speaker corpus's (B,)
    `speaker` ids."""
    keys = ('x', 'mel', 'mel_len') + (('speaker',) if 'speaker' in batch
                                      else ())
    return {k: torch.from_numpy(np.asarray(batch[k])).to(device,
                                                         non_blocking=True)
            for k in keys}


def taco_loss(m1: torch.Tensor, m2: torch.Tensor, mel: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """L1 of the decoder and the postnet outputs over every frame, padding
    included (the reference's taco_trainer.py:62-64)."""
    m1_loss = (m1 - mel).abs().mean()
    m2_loss = (m2 - mel).abs().mean()
    loss = m1_loss + m2_loss
    return loss, {'loss': loss.detach(), 'm1_loss': m1_loss.detach(),
                  'm2_loss': m2_loss.detach()}


def taco_micro_loss(model: torch.nn.Module, r: int,
                    generator: torch.Generator, train_cfg: Dict[str, Any]):
    """The teacher step's `micro_loss(b) -> (loss, metrics, attention)`
    for `tc.accumulate`: the teacher-forced forward at r under
    `train_cfg`'s precision and remat (`generator` replayed for the
    recompute), conditioned on the batch's `speaker` where it has one;
    m1, m2 and the attention in float32, the loss."""
    half = tc.half_dtype(train_cfg)
    remat = bool(train_cfg.get('remat', False))

    def micro_loss(b):
        m1, m2, att = tc.full(tc.forward_model(
            model, b['x'], b['mel'], r, generator, b.get('speaker'),
            half=half, remat=remat, generators=(generator,)))
        loss, metrics = taco_loss(m1, m2, b['mel'])
        return loss, metrics, att.detach()
    return micro_loss


def taco_train_step(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    batch: Dict[str, torch.Tensor], r: int,
                    generator: torch.Generator, train_cfg: Dict[str, Any]
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One optimization step in train mode: teacher-forced forward at r,
    loss, backward (kernels #2/#3 for the BiGRUs), global-norm clip,
    Adam, with the options of `train_cfg` (precision, grad_accum, remat;
    `train/common.py`). Returns (metrics, attention), device tensors."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    metrics, att = tc.accumulate(
        taco_micro_loss(model, r, generator, train_cfg), batch,
        tc.grad_accum(train_cfg), model)
    tc.apply_update(model, optimizer, metrics,
                    train_cfg.get('clip_grad_norm'))
    return metrics, att


@torch.no_grad()
def taco_eval_step(model: torch.nn.Module, batch: Dict[str, torch.Tensor],
                   r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, attention) of the teacher-forced forward in eval mode; the
    model's mode is restored."""
    was_training = model.training
    model.eval()
    try:
        m1, m2, att = model(batch['x'], batch['mel'], r,
                            speaker=batch.get('speaker'))
    finally:
        model.train(was_training)
    return taco_loss(m1, m2, batch['mel'])[0], att


class TacoTrainer(tc.Logging):

    def __init__(self, paths: Paths, config: Dict[str, Any],
                 device='cuda', writer=None, mesh=None, dsp=None) -> None:
        self.paths = paths
        self.config = config
        self.ranks = tc.Ranks(tc.trainer_mesh(config, mesh))
        self.device = self.ranks.device(device)
        self.train_cfg = config['tacotron']['training']
        tc.check_supported(self.train_cfg, 'tacotron')
        self.log_dir = paths.taco_log
        self.writer = writer
        # Griffin-Lim of the plots' audio (default: the config's DSP on
        # the trainer's device, made at the first plot)
        self.dsp = dsp
        self.preemption = tc.Preemption()
        self.top_k = tc.TopKTracker(
            paths.taco_top_k, k=int(self.train_cfg.get('keep_top_k', 3)),
            prefix='taco')
        self.ckpt = self.ranks.writer()
        # FTT_PROFILE_DIR traces a window of steps
        self.tracer = StepTraceController()

    def _save(self, model, optimizer, path, step: int,
              on_complete=None) -> None:
        """A checkpoint of whole tensors (every rank calls it; rank 0
        writes it)."""
        with self.ranks.whole():
            self.ckpt.save(checkpoint_payload(model, optimizer, self.config,
                                              step),
                           path, on_complete=on_complete)

    def train(self, model: torch.nn.Module,
              optimizer: Optional[torch.optim.Optimizer] = None,
              step: int = 0, seed: int = 42,
              max_steps_override: Optional[int] = None) -> int:
        """Run the schedule from `step` on the trainer's device; the model
        and optimizer are updated in place. Returns the final step."""
        model.to(self.device)
        if optimizer is None:
            optimizer = tc.make_optimizer(model)
        self.ranks.start([model], seed)
        self.ranks.shard([model], [optimizer])
        schedule = parse_schedule(self.train_cfg['schedule'])
        session_start = 0
        with self.preemption, contextlib.closing(self.tracer), \
                self.ranks.output():
            for i, (r, lr, max_step, bs) in enumerate(schedule, 1):
                prev_max, session_start = session_start, max_step
                if self.ranks.stop(self.preemption):
                    break
                if max_steps_override is not None:
                    max_step = min(max_step, max_steps_override)
                if step >= max_step:
                    continue
                train_set, val_set = get_tts_datasets(
                    path=self.paths.data, batch_size=bs, r=r,
                    model_type='tacotron',
                    max_mel_len=self.train_cfg['max_mel_len'],
                    filter_attention=False)
                if len(train_set) == 0:
                    raise RuntimeError('No training items: check the '
                                       'dataset and max_mel_len.')
                session = tc.TTSSession(index=i, r=r, lr=lr,
                                        max_step=max_step, bs=bs,
                                        train_set=train_set, val_set=val_set,
                                        start_step=prev_max)
                step = self.train_session(model, optimizer, step, session,
                                          seed)
        self.ranks.finish()
        self._flush_writer()
        return step

    def train_session(self, model, optimizer, step: int,
                      session: tc.TTSSession, seed: int) -> int:
        total_iters = len(session.train_set)
        epoch0, offset0 = tc.resume_position(step, session.start_step,
                                             total_iters)
        epochs = max((session.max_step - step + offset0)
                     // max(total_iters, 1) + 1, 1)
        print(f'| Session {session.index}: {session.max_step - step} steps '
              f'with r={session.r}, batch size {session.bs}, learning rate '
              f'{session.lr}, device {self.device}')
        tc.set_learning_rate(optimizer, session.lr)
        model.decoder.r.fill_(session.r)
        loss_avg, duration_avg = tc.Averager(), tc.Averager()
        last_t = time.time()

        def flush_metrics(metrics, pstep, pe, pi) -> None:
            nonlocal last_t
            loss = float(metrics['loss'])                 # waits
            loss_avg.add(loss)
            now = time.time()
            duration_avg.add(now - last_t)
            last_t = now
            speed = 1.0 / max(duration_avg.get(), 1e-9)
            att_score = float(metrics['att_score'])
            print(f'| Epoch: {pe}/{epochs} ({pi}/{total_iters}) '
                  f'| Loss: {loss_avg.get():#.4} '
                  f'| {speed:#.2} steps/s | Step: {pstep} | ', flush=True)
            self._scalar('Attention_Score/train', att_score, pstep)
            self._scalar('Loss/train', loss, pstep)
            self._scalar('Params/reduction_factor', session.r, pstep)
            self._scalar('Params/batch_size', session.bs, pstep)
            self._scalar('Params/learning_rate', session.lr, pstep)

        deferred = tc.DeferredFlush(flush_metrics)
        for e in range(1, epochs + 1):
            epoch = epoch0 + e - 1
            start = offset0 if epoch == epoch0 else 0
            batches = Prefetcher(session.train_set.batches(epoch, start))
            for i, batch in enumerate(batches, start + 1):
                # dropout and zoneout draw from (seed + rank, step): a
                # resumed run draws the same masks
                gen = self.ranks.generator(self.device, seed, step)
                tbatch = taco_batch_to_device(self.ranks.rows(
                    batch, tc.grad_accum(self.train_cfg)), self.device)
                with self.ranks.step():
                    metrics, att = taco_train_step(model, optimizer, tbatch,
                                                   session.r, gen,
                                                   self.train_cfg)
                    # the train attention score, averaged over the ranks
                    metrics.update(tc.reduce_metrics({'att_score': (
                        attention_score(att, tbatch['mel_len'],
                                        r=session.r)[1].mean())}))
                step += 1
                self.tracer.tick(step)
                deferred.push(metrics, step, e, i)
                if step % self.train_cfg['checkpoint_every'] == 0:
                    self._save(model, optimizer,
                               self.paths.taco_checkpoints /
                               f'taco_step{step // 1000}k.pt', step)
                if step % self.train_cfg['plot_every'] == 0:
                    with self.ranks.whole():
                        if self.ranks.main:
                            self.generate_plots(model, session, step)
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
                        self._end_of_epoch(model, optimizer, session, step)
                self.ranks.barrier()
                loss_avg.reset()
                duration_avg.reset()
                last_t = time.time()
                continue
            break  # max_step reached or preempted
        deferred.flush()
        self._save(model, optimizer,
                   self.paths.taco_checkpoints / 'latest_model.pt', step)
        self.ckpt.wait()    # on disk before the session returns
        self.ranks.barrier()
        return step

    def _end_of_epoch(self, model, optimizer, session: tc.TTSSession,
                      step: int) -> None:
        """Rank 0's end of an epoch: `evaluate()`, latest_model.pt and
        the k best teachers by validation attention score (negated: the
        tracker keeps the lowest)."""
        val_loss, val_att = self.evaluate(model, session.val_set, session.r)
        print(f'| Validation at step {step}: loss {val_loss:#.4}, '
              f'attention score {val_att:#.4}')
        self._scalar('Loss/val', val_loss, step)
        self._scalar('Attention_Score/val', val_att, step)
        self._save(model, optimizer, self.paths.taco_checkpoints
                   / 'latest_model.pt', step)
        self.top_k.update(-val_att, step,
                          lambda path, on_disk: self._save(
                              model, optimizer, path, step, on_disk))

    def evaluate(self, model: torch.nn.Module, val_set, r: int
                 ) -> Tuple[float, float]:
        """(mean loss, mean sharpness score) over the validation batches at
        r, eval mode, no gradient; the score is taken at r=1 over the
        step-level attention, as the JAX package does."""
        val_loss, val_att, n = 0.0, 0.0, 0
        for batch in val_set:
            tbatch = taco_batch_to_device(batch, self.device)
            loss, att = taco_eval_step(model, tbatch, r)
            _, score = attention_score(att, tbatch['mel_len'], r=1)
            val_loss += float(loss)
            val_att += float(score.mean())
            n += 1
        return val_loss / max(n, 1), val_att / max(n, 1)

    @torch.no_grad()
    def generate_plots(self, model: torch.nn.Module, session: tc.TTSSession,
                       step: int) -> None:
        """JAX's `TacoTrainer.generate_plots` on `session.val_sample`, in
        eval mode: the teacher-forced attention and mels (first 600
        frames) of its first item as figures and the Griffin-Lim wavs of
        the target and the postnet mel (`log_audio`, wavs in
        `taco_log/audio` where the writer takes no audio); then a
        free-running `Tacotron.generate` of that item in its speaker, of
        mel_len + 20 frames rounded up to a multiple of r: its attention,
        mels and wav. A failure is raised, not swallowed; without
        matplotlib the figures are skipped (`tc.Logging._add_figure`)."""
        if session.val_sample is None:
            return
        if self.dsp is None:
            from forwardtacotron_tpu_torch.dsp.audio import DSP
            self.dsp = DSP.from_config(self.config, device=self.device)
        batch = taco_batch_to_device(session.val_sample, self.device)
        spk = batch.get('speaker')
        was_training = model.training
        model.eval()
        try:
            m1, m2, att = model(batch['x'], batch['mel'], session.r,
                                speaker=spk)
            gen_steps = int(batch['mel_len'][0]) + 20
            gen_steps += (-gen_steps) % session.r
            m1g, m2g, attg, n_valid = model.generate(
                batch['x'][0:1], gen_steps, session.r,
                speaker=None if spk is None else spk[0:1])
        finally:
            model.train(was_training)
        m2_hat = m2[0, :600].float().cpu().numpy()
        m_target = batch['mel'][0, :600].cpu().numpy()
        for tag, plot, data in (
                ('Ground_Truth_Aligned/attention', plot_attention, att[0]),
                ('Ground_Truth_Aligned/target', plot_mel, m_target),
                ('Ground_Truth_Aligned/linear', plot_mel, m1[0, :600]),
                ('Ground_Truth_Aligned/postnet', plot_mel, m2_hat)):
            self._add_figure(tag, plot, data, step)
        sr = self.dsp.sample_rate
        audio_dir = self.paths.taco_log / 'audio'
        log_audio(self.writer, 'Ground_Truth_Aligned/target_wav',
                  self.dsp.griffinlim(m_target.T), step, sr,
                  fallback_dir=audio_dir)
        log_audio(self.writer, 'Ground_Truth_Aligned/postnet_wav',
                  self.dsp.griffinlim(m2_hat.T), step, sr,
                  fallback_dir=audio_dir)
        n_valid = max(int(n_valid), 1)
        m2_gen = m2g[0, :n_valid].float().cpu().numpy()
        for tag, plot, data in (
                ('Generated/attention', plot_attention, attg[0]),
                ('Generated/linear', plot_mel, m1g[0, :n_valid]),
                ('Generated/postnet', plot_mel, m2_gen)):
            self._add_figure(tag, plot, data, step)
        log_audio(self.writer, 'Generated/postnet_wav',
                  self.dsp.griffinlim(m2_gen.T), step, sr,
                  fallback_dir=audio_dir)
