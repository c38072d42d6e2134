"""Trainer of the teacher-free aligner, and its alignment features.

Mirrors the JAX package's `train/aligner_trainer.py`: (lr, max_step,
batch size) schedule sessions over the teacher's bucket batches
(`get_tts_datasets(model_type='tacotron', r=1)`) with mid-epoch resume,
the forward-sum loss (`align/aligner.py`), global-norm clipping with
optax's formula, then Adam (`train/common.py`), metrics read one step
late, and every `checkpoint_every` steps and at the session's end the
validation loss and `latest_model.pt` under `Paths.aligner_checkpoints`,
written off the step loop (`AsyncCheckpointWriter`); graceful preemption.
Dropout draws from a `torch.Generator` seeded with (seed, step), so a
resumed run draws what an uninterrupted one does. The options of the
other trainers (precision, EMA, grad_accum, remat) are refused: the JAX
aligner step has none. The model has no recurrence, so its step
launches none of the BiRNN kernels. Under a mesh (`mesh=`, or a process
group of more than one rank) each rank trains on its rows of every global
batch and rank 0 alone validates, prints and writes (`train/common.py`,
data parallelism).

`create_align_features_from_aligner` writes what the teacher's
alignment writes (`alg/*.npy`, `att_score_dict.pkl`, `phon_pitch/`,
`phon_energy/`), so `train_forward` runs on it unchanged.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from forwardtacotron_tpu_torch.align.aligner import (Aligner, align_extract,
                                                     forward_sum_loss)
from forwardtacotron_tpu_torch.align.features import extract_pitch_energy
from forwardtacotron_tpu_torch.align.metrics import attention_score
from forwardtacotron_tpu_torch.data.dataset import (Prefetcher,
                                                    get_tts_datasets)
from forwardtacotron_tpu_torch.train import common as tc
from forwardtacotron_tpu_torch.utils.checkpoints import checkpoint_payload
from forwardtacotron_tpu_torch.utils.display import (progbar, simple_table,
                                                     stream)
from forwardtacotron_tpu_torch.utils.files import (parse_schedule,
                                                   pickle_binary)
from forwardtacotron_tpu_torch.utils.paths import Paths
from forwardtacotron_tpu_torch.utils.profiling import StepTraceController

DEFAULT_SCHEDULE = ['1e-3, 10_000, 32']    # the JAX trainer's default
ALIGNER_KEYS = ('x', 'mel', 'x_len', 'mel_len')


def aligner_batch_to_device(batch: Dict[str, Any], device
                            ) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(batch[k])).to(device,
                                                         non_blocking=True)
            for k in ALIGNER_KEYS}


def aligner_loss(model: Aligner, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """The forward-sum loss of the model's log attention over a batch."""
    log_att = tc.forward_model(model, batch['x'], batch['mel'],
                               batch['x_len'], generator)
    return forward_sum_loss(log_att, batch['x_len'], batch['mel_len'])


def aligner_train_step(model: Aligner, optimizer: torch.optim.Optimizer,
                       batch: Dict[str, torch.Tensor],
                       generator: torch.Generator,
                       clip: Optional[float]) -> Dict[str, torch.Tensor]:
    """One optimization step in train mode (the JAX package's
    `build_aligner_train_step`): forward-sum loss, backward, global-norm
    clip, Adam. Returns the loss and the norm before clipping, device
    tensors."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss = aligner_loss(model, batch, generator)
    loss.backward()
    metrics = {'loss': loss.detach()}
    tc.apply_update(model, optimizer, metrics, clip)
    return metrics


@torch.no_grad()
def aligner_eval_loss(model: Aligner, val_set, device) -> float:
    """Mean forward-sum loss over the validation batches in eval mode
    (nan without any); the model's mode is restored."""
    was_training = model.training
    model.eval()
    try:
        losses = [float(aligner_loss(model, aligner_batch_to_device(
            b, device))) for b in val_set]
    finally:
        model.train(was_training)
    return float(np.mean(losses)) if losses else float('nan')


class AlignerTrainer(tc.Logging):

    def __init__(self, paths: Paths, config: Dict[str, Any],
                 device='cuda', writer=None, mesh=None) -> None:
        self.paths = paths
        self.config = config
        self.ranks = tc.Ranks(tc.trainer_mesh(config, mesh))
        self.device = self.ranks.device(device)
        self.train_cfg = config.get('aligner', {}).get('training', {})
        tc.check_supported(self.train_cfg, 'aligner', 'aligner.training')
        self.log_dir = paths.aligner_log
        self.writer = writer
        self.preemption = tc.Preemption()
        self.ckpt = self.ranks.writer()
        # FTT_PROFILE_DIR traces a window of steps
        self.tracer = StepTraceController()

    def train(self, model: Aligner,
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
        schedule = parse_schedule(self.train_cfg.get('schedule',
                                                     DEFAULT_SCHEDULE))
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
                    model_type='tacotron',
                    max_mel_len=self.train_cfg.get('max_mel_len', 1250),
                    filter_attention=False)
                if len(train_set) == 0:
                    raise RuntimeError('No training items: check the '
                                       'dataset and max_mel_len.')
                simple_table([('Session', i), ('lr', lr),
                              ('max_step', max_step), ('batch_size', bs),
                              ('batches/epoch', len(train_set)),
                              ('device', self.device)])
                session = tc.TTSSession(index=i, r=1, lr=lr,
                                        max_step=max_step, bs=bs,
                                        train_set=train_set, val_set=val_set,
                                        start_step=prev_max)
                step = self.train_session(model, optimizer, step, session,
                                          seed)
        self.ranks.finish()
        self._flush_writer()
        return step

    def train_session(self, model: Aligner, optimizer, step: int,
                      session: tc.TTSSession, seed: int) -> int:
        tc.set_learning_rate(optimizer, session.lr)
        clip = self.train_cfg.get('clip_grad_norm', 1.0)
        ckpt_every = int(self.train_cfg.get('checkpoint_every', 10_000))
        avg, t0 = tc.Averager(), time.time()

        def flush_metrics(metrics, pstep) -> None:
            nonlocal t0
            avg.add(float(metrics['loss']))          # waits
            if pstep % 10 == 0:
                sps = 10 / max(time.time() - t0, 1e-9)
                t0 = time.time()
                stream(f'| Aligner step {pstep}/{session.max_step} '
                       f'loss {avg.get():.4f} {sps:.1f} steps/s ')
                self._scalar('aligner/loss', avg.get(), pstep)
                avg.reset()

        deferred = tc.DeferredFlush(flush_metrics)
        while step < session.max_step \
                and not self.ranks.stop(self.preemption):
            epoch, start = tc.resume_position(step, session.start_step,
                                              len(session.train_set))
            for batch in Prefetcher(session.train_set.batches(epoch, start)):
                gen = self.ranks.generator(self.device, seed, step)
                with self.ranks.step():
                    metrics = aligner_train_step(
                        model, optimizer, aligner_batch_to_device(
                            self.ranks.rows(batch), self.device), gen, clip)
                step += 1
                self.tracer.tick(step)
                deferred.push(metrics, step)
                if step % ckpt_every == 0 or step >= session.max_step:
                    with self.ranks.whole():
                        if self.ranks.main:
                            val = aligner_eval_loss(model, session.val_set,
                                                    self.device)
                            print(f'\n| Validation at step {step}: loss '
                                  f'{val:#.4}')
                            self._scalar('aligner/val_loss', val, step)
                            self.ckpt.save(checkpoint_payload(
                                model, optimizer, self.config, step),
                                self.paths.aligner_checkpoints
                                / 'latest_model.pt')
                    self.ranks.barrier()
                if step >= session.max_step \
                        or self.ranks.stop(self.preemption):
                    break
        deferred.flush()
        if self.preemption.requested:
            with self.ranks.whole():
                self.ckpt.save(checkpoint_payload(model, optimizer,
                                                  self.config, step),
                               self.paths.aligner_checkpoints
                               / 'latest_model.pt')
        self.ckpt.wait()    # on disk before the session returns
        self.ranks.barrier()
        return step


def create_align_features_from_aligner(model: Aligner, train_set, val_set,
                                       paths: Paths,
                                       pitch_max_freq: float) -> None:
    """Durations from the Viterbi path (`alg/*.npy`, int32, summing to
    mel_len), attention scores from the soft posterior
    (`att_score_dict.pkl`), then the per-phoneme pitch and energy, for
    every item of both sets, on the model's device."""
    device = next(model.parameters()).device
    att_score_dict = {}
    iters = len(train_set) + len(val_set)
    i = 0
    for batcher in (train_set, val_set):
        for batch in batcher:
            dev = aligner_batch_to_device(batch, device)
            durs, att = align_extract(model, dev['x'], dev['mel'],
                                      dev['x_len'], dev['mel_len'])
            align_scores, sharp_scores = attention_score(
                att, dev['mel_len'], r=1)
            durs = durs.cpu().numpy()
            align_scores = align_scores.cpu().numpy()
            sharp_scores = sharp_scores.cpu().numpy()
            for j in range(batch.get('n_real', durs.shape[0])):
                item_id = batch['item_id'][j]
                x_len = int(batch['x_len'][j])
                mel_len = int(batch['mel_len'][j])
                d = durs[j, :x_len]
                if int(d.sum()) != mel_len:
                    print(f'WARNING: Sum of durations did not match mel '
                          f'length for item {item_id}!')
                att_score_dict[item_id] = (float(align_scores[j]),
                                           float(sharp_scores[j]))
                np.save(str(paths.alg / f'{item_id}.npy'),
                        d.astype(np.int32), allow_pickle=False)
            i += 1
            stream(f'{progbar(i, iters)} {i}/{iters} Batches ')

    pickle_binary(att_score_dict, paths.data / 'att_score_dict.pkl')
    print('\nExtracting Pitch Values...')
    extract_pitch_energy(paths, save_path_pitch=paths.phon_pitch,
                         save_path_energy=paths.phon_energy,
                         pitch_max_freq=pitch_max_freq)
