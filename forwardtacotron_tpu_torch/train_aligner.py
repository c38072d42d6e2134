"""Teacher-free aligner training and alignment CLI.

    python -m forwardtacotron_tpu_torch.train_aligner [--force_align] \\
        [--config FILE] [--device cuda]

The contract follows the JAX package's root `train_aligner.py`: on a
dataset that `forwardtacotron_tpu_torch.preprocess` wrote under
`data_path`, the plain run trains the aligner (`align/aligner.py`) per
the `aligner.training` schedule, resuming from `latest_model.pt` when the
checkpoint directory (`Paths.aligner_checkpoints`) has one, then writes
the durations (`data/alg`), the attention scores (`att_score_dict.pkl`)
and the per-phoneme pitch and energy (`phon_pitch/`, `phon_energy/`)
unless preempted; `--force_align` only writes them, from the checkpoint.
`python -m forwardtacotron_tpu_torch.train_forward` then trains on them
as on the teacher's. A JAX `latest_model.fjax` in the checkpoint
directory, where there is no `latest_model.pt`, seeds the weights, the
step and Adam's state (fresh when the file has none). Without `--config`
the built-in copy of config.yaml is used. Everything runs on `--device`
(default `cuda`).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from forwardtacotron_tpu_torch import resolve_device
from forwardtacotron_tpu_torch.parallel import (is_main_process,
                                                training_device, wait_for_all)
from forwardtacotron_tpu_torch.align.aligner import aligner_from_config
from forwardtacotron_tpu_torch.config import default_config, read_config
from forwardtacotron_tpu_torch.data.dataset import get_tts_datasets
from forwardtacotron_tpu_torch.train import common as tc
from forwardtacotron_tpu_torch.train.aligner_trainer import (
    AlignerTrainer, create_align_features_from_aligner)
from forwardtacotron_tpu_torch.utils.checkpoints import (load_checkpoint,
                                                         restore)
from forwardtacotron_tpu_torch.utils.paths import Paths
from forwardtacotron_tpu_torch.weights import (aligner_state_dict,
                                               load_fjax,
                                               load_optimizer_state)

SEED = 42      # the JAX trainer's fixed seed


def _restore(model, optimizer, paths: Paths) -> Optional[int]:
    """The step of the checkpoint loaded into model (and optimizer), or
    None when the checkpoint directory has none."""
    latest = paths.aligner_checkpoints / 'latest_model.pt'
    latest_fjax = latest.with_suffix('.fjax')
    if latest.is_file():
        step = restore(model, optimizer, load_checkpoint(latest))
        print(f'Restored aligner with step {step}')
        return step
    if latest_fjax.is_file():
        payload = load_fjax(latest_fjax, use_ema=False)
        step = payload['step']

        def to_state_dict(variables):
            return aligner_state_dict(variables, step)
        model.load_state_dict(to_state_dict(payload['model']))
        carried = load_optimizer_state(
            payload, [(optimizer, model, payload['model'], to_state_dict)])
        what = 'the weights and Adam' if carried else 'the weights'
        print(f'Seeded {what} from {latest_fjax} (step {step})')
        return step
    return None


def main(argv: Optional[Sequence[str]] = None, writer=None
         ) -> Optional[int]:
    parser = argparse.ArgumentParser(
        description='Train the teacher-free neural aligner (PyTorch)')
    parser.add_argument('--force_align', '-a', action='store_true',
                        help='write durations, pitch and energy from the '
                             'existing aligner checkpoint, no training')
    parser.add_argument('--config', metavar='FILE', default=None,
                        help='YAML (needs pyyaml) or .json config '
                             '(default: built-in copy of config.yaml)')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    config = read_config(args.config) if args.config else default_config()
    device = training_device(config, resolve_device(args.device))
    paths = Paths(config['data_path'], config['tts_model_id'])

    print('\nInitialising Aligner Model...\n')
    trainer = None if args.force_align else \
        AlignerTrainer(paths, config, device, writer=writer)
    torch.manual_seed(SEED)
    model = aligner_from_config(config).to(device)
    optimizer = tc.make_optimizer(model)
    step = _restore(model, optimizer, paths)

    if args.force_align:
        if step is None:
            raise SystemExit(f'No aligner checkpoint in '
                             f'{paths.aligner_checkpoints}: train the '
                             'aligner first')
    else:
        step = trainer.train(model, optimizer, step or 0, seed=SEED)
        if trainer.preemption.requested:
            print('Preempted mid-training: latest_model saved; rerun to '
                  'resume (alignment extraction deferred).')
            return step

    print('Creating Attention Alignments and Pitch Values...')
    train_set, val_set = get_tts_datasets(
        paths.data, 8, 1, max_mel_len=None, filter_attention=False,
        model_type='tacotron')
    if is_main_process():
        create_align_features_from_aligner(
            model, train_set, val_set, paths,
            pitch_max_freq=config['dsp']['pitch_max_freq'])
    wait_for_all()
    print('\n\nYou can now train ForwardTacotron - use python -m '
          'forwardtacotron_tpu_torch.train_forward\n')
    return step


if __name__ == '__main__':
    main()
