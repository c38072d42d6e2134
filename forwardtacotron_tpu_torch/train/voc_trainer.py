"""WaveRNN vocoder trainer.

Mirrors the JAX package's `train/voc_trainer.py` (the reference's
trainer/voc_trainer.py): (lr, max_step, batch size) schedule sessions,
epoch-seeded random windows with mid-epoch resume, the cross-entropy
(RAW) or discretized-MOL loss, global-norm clipping with optax's formula
and Adam, `evaluate()` in eval mode at the end of every epoch, sample
generation every `gen_samples_every` steps scored by the mel L1 of the
resynthesis, the `keep_top_k` best checkpoints by that score, and
`latest_model.pt` / `wave_step{k}k.pt` checkpoints in the reference's
WaveRNN layout, written off the step loop (`AsyncCheckpointWriter`). The
step runs the options of the JAX step (`build_voc_train_step`):
`precision` (the parameters, x and the mel cast to bfloat16, the logits
back to float32 for the loss) and `remat`; `ema_decay` and `grad_accum`
are refused, the JAX trainer has neither. Both GRUs of a training step
run as one stream of the
BiRNN training kernels (#2 forward, #3 backward); `evaluate()` runs them
through the inference kernel (#1) and `generate_samples` through the
sampler (#4). Unlike the JAX trainer, `generate_samples` lets a failure
through: it is the sampler kernel's path. Scalars go to stdout and to an
optional `writer` with `add_scalar`; audio samples to its `add_audio`
or, failing that, to wav files under the log directory. Under a mesh
(`mesh=`, or a process group of more than one rank) each rank trains on
its rows of every global batch and rank 0 alone evaluates, generates the
samples, prints and writes (`train/common.py`, data parallelism).
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.nn import functional as F

from forwardtacotron_tpu_torch.data.dataset import (GANVocCollator,
                                                    Prefetcher,
                                                    get_vocoder_datasets)
from forwardtacotron_tpu_torch.models.wavernn import WaveRNN, generate_wav
from forwardtacotron_tpu_torch.ops.mol import discretized_mix_logistic_loss
from forwardtacotron_tpu_torch.train import common as tc
from forwardtacotron_tpu_torch.utils.checkpoints import checkpoint_payload
from forwardtacotron_tpu_torch.utils.display import log_audio, simple_table
from forwardtacotron_tpu_torch.utils.files import parse_schedule
from forwardtacotron_tpu_torch.utils.paths import Paths
from forwardtacotron_tpu_torch.utils.profiling import StepTraceController


def voc_loss(logits: torch.Tensor, y: torch.Tensor, mode: str
             ) -> torch.Tensor:
    """Mean cross-entropy of the class labels y (RAW) or the MOL negative
    log-likelihood of the float targets y, over every sample."""
    if mode == 'RAW':
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               y.reshape(-1).long())
    return discretized_mix_logistic_loss(logits, y)


def voc_micro_loss(model: WaveRNN, mode: str,
                   half: Optional[torch.dtype] = None, remat: bool = False):
    """The WaveRNN step's `micro_loss(b) -> (loss, metrics, None)` for
    `tc.accumulate`: the teacher-forced forward (in `half` where given,
    recomputed in the backward under `remat`), the loss of the float32
    logits."""
    def micro_loss(b):
        logits = tc.full(tc.forward_model(model, b['x'], b['mel'],
                                          half=half, remat=remat))
        loss = voc_loss(logits, b['y'], mode)
        return loss, {'loss': loss.detach()}, None
    return micro_loss


def voc_train_step(model: WaveRNN, optimizer: torch.optim.Optimizer,
                   batch: Dict[str, torch.Tensor], mode: str,
                   clip: Optional[float], half: Optional[torch.dtype] = None,
                   remat: bool = False) -> Dict[str, torch.Tensor]:
    """One optimization step in train mode: teacher-forced forward (in
    `half` where given, recomputed in the backward under `remat`;
    `train/common.py:forward_model`), the loss of the float32 logits,
    backward, global-norm clip (where `clip` is set), Adam. The clipped
    gradients stay in `.grad`. Returns device tensors: the loss and the
    norm before clipping."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    metrics, _ = tc.accumulate(voc_micro_loss(model, mode, half, remat),
                               batch, 1, model)
    tc.apply_update(model, optimizer, metrics, clip)
    return metrics


def batch_to_device(batch: Dict[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
    """The batch's arrays on `device`; a GAN batch's row indices and crop
    offsets (`GANVocCollator.ROW_KEYS`), which no step reads, stay on the
    host."""
    return {k: torch.from_numpy(np.asarray(v)).to(device, non_blocking=True)
            for k, v in batch.items() if k not in GANVocCollator.ROW_KEYS}


class VocTrainer(tc.Logging):

    def __init__(self, paths: Paths, dsp, config: Dict[str, Any],
                 device='cuda', writer=None, mesh=None) -> None:
        self.paths = paths
        self.dsp = dsp
        self.config = config
        self.ranks = tc.Ranks(tc.trainer_mesh(config, mesh))
        self.device = self.ranks.device(device)
        self.train_cfg = config['vocoder']['training']
        tc.check_supported(self.train_cfg, 'wavernn')
        self.log_dir = paths.voc_log
        self.writer = writer
        self.preemption = tc.Preemption()
        self.top_k = tc.TopKTracker(
            paths.voc_top_k, k=int(self.train_cfg.get('keep_top_k', 3)),
            prefix='wave')
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

    def train(self, model: WaveRNN,
              optimizer: Optional[torch.optim.Optimizer] = None,
              step: int = 0, train_gta: bool = False,
              max_steps_override: Optional[int] = None) -> int:
        """Run the schedule from `step` on the trainer's device; the model
        and optimizer are updated in place. Returns the final step."""
        model.to(self.device)
        if optimizer is None:
            optimizer = tc.make_optimizer(model)
        self.ranks.start([model])
        self.ranks.shard([model], [optimizer])
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
                train_set, val_set, val_set_samples = get_vocoder_datasets(
                    path=self.paths.data, batch_size=bs,
                    train_gta=train_gta,
                    max_mel_len=self.train_cfg['max_mel_len'],
                    hop_length=self.dsp.hop_length, voc_pad=model.pad,
                    voc_seq_len=self.train_cfg['seq_len'],
                    voc_mode=self.dsp.voc_mode, bits=self.dsp.bits,
                    num_gen_samples=self.train_cfg['num_gen_samples'])
                session = tc.VocSession(
                    index=i, lr=lr, max_step=max_step, bs=bs,
                    train_set=train_set, val_set=val_set,
                    val_set_samples=val_set_samples, start_step=prev_max)
                step = self.train_session(model, optimizer, step, session,
                                          train_gta)
        self.ranks.finish()
        self._flush_writer()
        return step

    def train_session(self, model: WaveRNN, optimizer, step: int,
                      session: tc.VocSession, train_gta: bool) -> int:
        total_iters = len(session.train_set)
        epoch0, offset0 = tc.resume_position(step, session.start_step,
                                             total_iters)
        epochs = max((session.max_step - step + offset0)
                     // max(total_iters, 1) + 1, 1)
        simple_table([('Remaining', f'{session.max_step - step} Steps'),
                      ('Batch Size', session.bs), ('LR', session.lr),
                      ('Sequence Len', self.train_cfg['seq_len']),
                      ('GTA Train', train_gta),
                      ('Device', self.device)])
        tc.set_learning_rate(optimizer, session.lr)
        mode, clip = self.dsp.voc_mode, self.train_cfg.get('clip_grad_norm')
        half = tc.half_dtype(self.train_cfg)
        remat = bool(self.train_cfg.get('remat', False))
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
            print(f'| Epoch: {pe}/{epochs} ({pi}/{total_iters}) '
                  f'| Loss: {loss_avg.get():#.4} | {speed:#.2} steps/s '
                  f'| Step: {pstep} | ', flush=True)
            self._scalar('Loss/train', loss, pstep)
            self._scalar('Params/batch_size', session.bs, pstep)
            self._scalar('Params/learning_rate', session.lr, pstep)

        deferred = tc.DeferredFlush(flush_metrics)
        for e in range(1, epochs + 1):
            epoch = epoch0 + e - 1
            start = offset0 if epoch == epoch0 else 0
            batches = Prefetcher(session.train_set.batches(epoch, start))
            for i, batch in enumerate(batches, start + 1):
                with self.ranks.step():
                    metrics = voc_train_step(
                        model, optimizer,
                        batch_to_device(self.ranks.rows(batch), self.device),
                        mode, clip, half, remat)
                step += 1
                self.tracer.tick(step)
                deferred.push(metrics, step, e, i)
                if step % self.train_cfg['gen_samples_every'] == 0:
                    with self.ranks.whole():
                        if self.ranks.main:
                            mel_loss = self.generate_samples(model, session,
                                                             step)
                            if mel_loss is not None:
                                self.track_top_models(mel_loss, model, step)
                    self.ranks.barrier()
                if step % self.train_cfg['checkpoint_every'] == 0:
                    self._save(model, optimizer, self.paths.voc_checkpoints
                               / f'wave_step{step // 1000}k.pt', step)
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
                        self._end_of_epoch(model, optimizer, session.val_set,
                                           step)
                self.ranks.barrier()
                loss_avg.reset()
                duration_avg.reset()
                last_t = time.time()
                continue
            break  # max_step reached or preempted
        deferred.flush()
        self._save(model, optimizer,
                   self.paths.voc_checkpoints / 'latest_model.pt', step)
        self.ckpt.wait()    # on disk before the session returns
        self.ranks.barrier()
        return step

    def _end_of_epoch(self, model, optimizer, val_set, step: int) -> None:
        """Rank 0's end of an epoch: `evaluate()` and latest_model.pt."""
        val_loss = self.evaluate(model, val_set)
        print(f'| Validation at step {step}: loss {val_loss:#.4}')
        self._scalar('Loss/val', val_loss, step)
        self._save(model, optimizer, self.paths.voc_checkpoints
                   / 'latest_model.pt', step)

    @torch.no_grad()
    def evaluate(self, model: WaveRNN, val_set) -> float:
        """Mean loss over the validation batches in eval mode (running
        batch-norm statistics; the GRUs through kernel #1); the model's
        mode is restored."""
        was_training = model.training
        model.eval()
        try:
            total, n = 0.0, 0
            for batch in val_set:
                b = batch_to_device(batch, self.device)
                total += float(voc_loss(model(b['x'], b['mel']), b['y'],
                                        self.dsp.voc_mode))
                n += 1
        finally:
            model.train(was_training)
        return total / max(n, 1)

    @torch.no_grad()
    def generate_samples(self, model: WaveRNN, session: tc.VocSession,
                         step: int) -> Optional[float]:
        """Vocode each validation sample's whole mel with the config's
        `gen_batched`, `target` and `overlap` (on the card the sampler
        kernel #4) and score the mel L1 of the resynthesis against it (the
        reference's voc_trainer.py:160-202). Returns the mean, or None
        without samples. A failure is raised, not swallowed."""
        was_training = model.training
        model.eval()
        try:
            mel_losses = []
            for idx, sample in enumerate(session.val_set_samples, 1):
                mel = sample['mel']                        # (n_mels, T)
                wav = generate_wav(model, mel,
                                   batched=self.train_cfg['gen_batched'],
                                   target=self.train_cfg['target'],
                                   overlap=self.train_cfg['overlap'],
                                   mu_law=self.dsp.mu_law)
                wav = np.asarray(wav, dtype=np.float32)
                gen_mel = self.dsp.wav_to_mel_bucketed(wav)
                t = min(gen_mel.shape[-1], mel.shape[-1])
                mel_losses.append(float(np.mean(
                    np.abs(gen_mel[:, :t] - mel[:, :t]))))
                log_audio(self.writer, f'Samples/generated_{idx}', wav, step,
                          self.dsp.sample_rate,
                          fallback_dir=self.paths.voc_log / 'audio')
        finally:
            model.train(was_training)
        if not mel_losses:
            return None
        mel_loss = float(np.mean(mel_losses))
        self._scalar('Loss/generated_mel_l1', mel_loss, step)
        return mel_loss

    def track_top_models(self, mel_loss: float, model: WaveRNN,
                         step: int) -> None:
        """Keep the top-k checkpoints by generated mel L1 (the reference's
        voc_trainer.py:204-226), weights only."""
        self.top_k.update(mel_loss, step, lambda path, on_disk: self._save(
            model, None, path, step, on_disk))
