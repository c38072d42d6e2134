"""Student trainer of ForwardTacotron and FastPitch.

Mirrors the JAX package's `train/forward_trainer.py` (the reference's
trainer/forward_trainer.py), for the model `config['tts_model']` names and
with that model's `training` section: progressive (lr, max_step, batch size)
schedule sessions, epoch-seeded bucket batches with mid-epoch resume, the
masked-L1 losses, metrics read one step late, `evaluate()` in eval mode at
the end of every epoch, `latest_model.pt` / `forward_step{k}k.pt`
checkpoints, and the `keep_top_k` (default 3) best by validation mel loss
in `top_k_models/`, written off the step loop (`AsyncCheckpointWriter`).
It runs every option of the JAX step (`train/common.py`): `precision`,
`grad_accum`, `remat` and `ema_decay`, whose EMA weights `evaluate()`
and the top-k score use and the checkpoints serve. FastPitch draws its
dropout from the step's generator. Scalars go to stdout and to the
`writer` (`writer=`, an object with `add_scalar(tag, value, step)`, else
a tensorboardX `SummaryWriter` under `paths.forward_log` where tensorboardX
is installed). Every `plot_every` steps `generate_plots` writes JAX's
figures and Griffin-Lim audio samples of the first validation batch
(`session.val_sample`); `FTT_PROFILE_DIR` traces a window of steps
(`utils/profiling.py`). Under a mesh (`mesh=`, or a process group of more
than one rank) each rank trains on its rows of every global batch, the
'model' axis keeps the weights in shards, and global rank 0 alone
evaluates, plots, prints and writes (`train/common.py`, data parallelism).
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from forwardtacotron_tpu_torch.data.dataset import (Prefetcher,
                                                    get_tts_datasets)
from forwardtacotron_tpu_torch.train import common as tc
from forwardtacotron_tpu_torch.utils.checkpoints import checkpoint_payload
from forwardtacotron_tpu_torch.utils.display import (log_audio, plot_mel,
                                                     plot_pitch)
from forwardtacotron_tpu_torch.utils.files import parse_schedule
from forwardtacotron_tpu_torch.utils.paths import Paths
from forwardtacotron_tpu_torch.utils.profiling import StepTraceController

BATCH_KEYS = ('x', 'x_len', 'mel', 'mel_len', 'dur', 'pitch', 'energy')


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """The batch's tensors on `device`, with a multi-speaker corpus's (B,)
    `speaker` ids."""
    keys = BATCH_KEYS + (('speaker',) if 'speaker' in batch else ())
    return {k: torch.from_numpy(np.asarray(batch[k])).to(device,
                                                         non_blocking=True)
            for k in keys}


class ForwardTrainer(tc.Logging):

    def __init__(self, paths: Paths, config: Dict[str, Any],
                 device='cuda', writer=None, mesh=None, dsp=None) -> None:
        self.paths = paths
        self.config = config
        self.ranks = tc.Ranks(tc.trainer_mesh(config, mesh))
        self.device = self.ranks.device(device)
        # the section of the model that config['tts_model'] names
        model_type = config.get('tts_model', 'forward_tacotron')
        self.train_cfg = config[model_type]['training']
        tc.check_supported(self.train_cfg, 'forward', f'{model_type}.training')
        self.log_dir = paths.forward_log
        self.writer = writer
        # Griffin-Lim of the plots' audio (default: the config's DSP on
        # the trainer's device, made at the first plot)
        self.dsp = dsp
        self.preemption = tc.Preemption()
        self.top_k = tc.TopKTracker(
            paths.forward_top_k, k=int(self.train_cfg.get('keep_top_k', 3)),
            prefix='forward')
        self.ckpt = self.ranks.writer()
        # FTT_PROFILE_DIR traces a window of steps
        self.tracer = StepTraceController()
        # the EMA weights (`ema_decay` > 0); a resume sets them first
        self.ema: Optional[tc.EMA] = None

    def _save(self, model, optimizer, path, step: int,
              on_complete=None) -> None:
        """A checkpoint of whole tensors (every rank calls it; rank 0
        writes it)."""
        with self.ranks.whole():
            self.ckpt.save(checkpoint_payload(model, optimizer, self.config,
                                              step, self.ema),
                           path, on_complete=on_complete)

    def train(self, model: torch.nn.Module,
              optimizer: Optional[torch.optim.Optimizer] = None,
              step: int = 0, seed: int = 42,
              max_steps_override: Optional[int] = None) -> int:
        """Run the schedule from `step` on the trainer's device; the model
        and optimizer (and `self.ema`) are updated in place. Returns the
        final step."""
        model.to(self.device)
        if optimizer is None:
            optimizer = tc.make_optimizer(model)
        self.ranks.start([model], seed)
        if self.ema is None:
            self.ema = tc.make_ema(model, self.train_cfg)
        self.ranks.shard([model], [optimizer], self.ema)
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
                train_set, val_set = get_tts_datasets(
                    path=self.paths.data, batch_size=bs, r=1,
                    model_type='forward',
                    max_mel_len=self.train_cfg['max_mel_len'],
                    filter_attention=self.train_cfg['filter_attention'],
                    filter_min_alignment=self.train_cfg[
                        'min_attention_alignment'],
                    filter_min_sharpness=self.train_cfg[
                        'min_attention_sharpness'])
                if len(train_set) == 0:
                    raise RuntimeError(
                        'No training items left after filtering: check '
                        'attention scores (filter_attention) and '
                        'max_mel_len.')
                session = tc.TTSSession(index=i, r=1, lr=lr,
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
        print(f'| Session {session.index}: {session.max_step - step} steps, '
              f'batch size {session.bs}, learning rate {session.lr}, '
              f'device {self.device}')
        tc.set_learning_rate(optimizer, session.lr)
        m_loss_avg, dur_loss_avg = tc.Averager(), tc.Averager()
        duration_avg, pitch_loss_avg = tc.Averager(), tc.Averager()
        last_t = time.time()

        def flush_metrics(metrics, pstep, pe, pi, mel_shape) -> None:
            nonlocal last_t
            values = {k: float(v) for k, v in metrics.items()}  # waits
            m_loss_avg.add(values['mel_loss'])
            dur_loss_avg.add(values['dur_loss'])
            pitch_loss_avg.add(values['pitch_loss'])
            now = time.time()
            duration_avg.add(now - last_t)
            last_t = now
            speed = 1.0 / max(duration_avg.get(), 1e-9)
            print(f'| Epoch: {pe}/{epochs} ({pi}/{total_iters}) '
                  f'| Mel Loss: {m_loss_avg.get():#.4} '
                  f'| Dur Loss: {dur_loss_avg.get():#.4} '
                  f'| Pitch Loss: {pitch_loss_avg.get():#.4} '
                  f'| {speed:#.2} steps/s | Step: {pstep} | ', flush=True)
            self._scalar('Perf/steps_per_sec', speed, pstep)
            self._scalar('Perf/mel_frames_per_sec',
                         speed * mel_shape[0] * mel_shape[1], pstep)
            for name, key in (('Mel_Loss', 'mel_loss'),
                              ('Pitch_Loss', 'pitch_loss'),
                              ('Energy_Loss', 'energy_loss'),
                              ('Duration_Loss', 'dur_loss')):
                self._scalar(f'{name}/train', values[key], pstep)
            self._scalar('Params/batch_size', session.bs, pstep)
            self._scalar('Params/learning_rate', session.lr, pstep)

        deferred = tc.DeferredFlush(flush_metrics)
        for e in range(1, epochs + 1):
            epoch = epoch0 + e - 1
            start = offset0 if epoch == epoch0 else 0
            batches = Prefetcher(session.train_set.batches(epoch, start))
            for i, batch in enumerate(batches, start + 1):
                # zoneout (and FastPitch's dropout) draws from (seed +
                # rank, step): a resumed run draws the same masks
                gen = self.ranks.generator(self.device, seed, step)
                rows = self.ranks.rows(batch, tc.grad_accum(self.train_cfg))
                with self.ranks.step():
                    metrics = tc.train_step(
                        model, optimizer, batch_to_device(rows, self.device),
                        gen, self.train_cfg, self.ema)
                step += 1
                self.tracer.tick(step)
                deferred.push(metrics, step, e, i, batch['mel'].shape[:2])
                if step % self.train_cfg['checkpoint_every'] == 0:
                    self._save(model, optimizer,
                               self.paths.forward_checkpoints /
                               f'forward_step{step // 1000}k.pt', step)
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
                m_loss_avg.reset()
                duration_avg.reset()
                pitch_loss_avg.reset()
                last_t = time.time()
                continue
            break  # max_step reached or preempted
        deferred.flush()
        self._save(model, optimizer,
                   self.paths.forward_checkpoints / 'latest_model.pt', step)
        self.ckpt.wait()    # on disk before the session returns
        self.ranks.barrier()
        return step

    def _end_of_epoch(self, model, optimizer, session: tc.TTSSession,
                      step: int) -> None:
        """Rank 0's end of an epoch: `evaluate()`, latest_model.pt and
        the k best students by validation mel loss."""
        val = self.evaluate(model, session.val_set)
        print(f'| Validation at step {step}: ' + ', '.join(
            f'{k} {v:#.4}' for k, v in val.items()))
        for name, key in (('Mel_Loss', 'mel_loss'),
                          ('Duration_Loss', 'dur_loss'),
                          ('Pitch_Loss', 'pitch_loss'),
                          ('Energy_Loss', 'energy_loss')):
            self._scalar(f'{name}/val', val[key], step)
        self._save(model, optimizer, self.paths.forward_checkpoints
                   / 'latest_model.pt', step)
        self.top_k.update(val['mel_loss'], step,
                          lambda path, on_disk: self._save(
                              model, optimizer, path, step, on_disk))

    def evaluate(self, model: torch.nn.Module, val_set) -> Dict[str, float]:
        """Mean loss metrics over the validation batches, eval mode, no
        gradient (so the recurrences run the inference kernel), with the
        EMA weights where they are kept (and the live buffers)."""
        params = None if self.ema is None else self.ema.params
        totals = {'mel_loss': 0.0, 'dur_loss': 0.0, 'pitch_loss': 0.0,
                  'energy_loss': 0.0}
        n = 0
        for batch in val_set:
            metrics = tc.eval_step(model, batch_to_device(batch, self.device),
                                   self.train_cfg, params)
            for k in totals:
                totals[k] += float(metrics[k])
            n += 1
        return {k: v / max(n, 1) for k, v in totals.items()}

    @torch.no_grad()
    def generate_plots(self, model: torch.nn.Module, session: tc.TTSSession,
                       step: int) -> None:
        """JAX's `ForwardTrainer.generate_plots` on `session.val_sample`,
        in eval mode with the EMA weights where kept: the teacher-forced
        mels (first 600 frames), pitch and energy of its first item as
        figures, the Griffin-Lim wavs of the target and the postnet mel
        (`log_audio`, wavs in `forward_log/audio` where the writer takes
        no audio), then a free-running float32 `generate` of that item up
        to the batch's mel length: its postnet mel, pitch and energy, and
        its wav. A failure is raised, not swallowed; without matplotlib the
        figures are skipped (`tc.Logging._add_figure`)."""
        if session.val_sample is None:
            return
        if self.dsp is None:
            from forwardtacotron_tpu_torch.dsp.audio import DSP
            self.dsp = DSP.from_config(self.config, device=self.device)
        batch = batch_to_device(session.val_sample, self.device)
        was_training = model.training
        model.eval()
        try:
            with tc.swapped_params(model, None if self.ema is None
                                   else self.ema.params):
                pred = model(batch)
                x_len = int(batch['x_len'][0])
                max_t = int(batch['mel'].shape[1])
                gen = model.generate(batch['x'][0:1], max_t,
                                     x_len=batch['x_len'][0:1],
                                     compute_dtype=torch.float32)
        finally:
            model.train(was_training)
        m1_hat = pred['mel'][0, :600].float().cpu().numpy()
        m2_hat = pred['mel_post'][0, :600].float().cpu().numpy()
        m_target = batch['mel'][0, :600].cpu().numpy()
        for tag, plot, data in (
                ('Ground_Truth_Aligned/target', plot_mel, m_target),
                ('Ground_Truth_Aligned/linear', plot_mel, m1_hat),
                ('Ground_Truth_Aligned/postnet', plot_mel, m2_hat),
                ('Pitch/target', plot_pitch, batch['pitch'][0]),
                ('Pitch/ground_truth_aligned', plot_pitch, pred['pitch'][0]),
                ('Energy/target', plot_pitch, batch['energy'][0]),
                ('Energy/ground_truth_aligned', plot_pitch,
                 pred['energy'][0])):
            self._add_figure(tag, plot, data, step)
        sr = self.dsp.sample_rate
        audio_dir = self.paths.forward_log / 'audio'
        log_audio(self.writer, 'Ground_Truth_Aligned/target_wav',
                  self.dsp.griffinlim(m_target.T), step, sr,
                  fallback_dir=audio_dir)
        log_audio(self.writer, 'Ground_Truth_Aligned/postnet_wav',
                  self.dsp.griffinlim(m2_hat.T), step, sr,
                  fallback_dir=audio_dir)
        gen_len = int(gen['mel_len'][0])
        m2_gen = gen['mel_post'][0, :max(gen_len, 1)].float().cpu().numpy()
        self._add_figure('Generated/postnet', plot_mel, m2_gen, step)
        self._add_figure('Pitch/generated', plot_pitch,
                         gen['pitch'][0][:x_len], step)
        self._add_figure('Energy/generated', plot_pitch,
                         gen['energy'][0][:x_len], step)
        log_audio(self.writer, 'Generated/postnet_wav',
                  self.dsp.griffinlim(m2_gen.T), step, sr,
                  fallback_dir=audio_dir)
