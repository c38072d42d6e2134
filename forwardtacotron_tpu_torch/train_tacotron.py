"""Tacotron teacher training and alignment CLI.

    python -m forwardtacotron_tpu_torch.train_tacotron [--config FILE] \\
        [--force_align | --extract_pitch | --force_gta] [--device cuda]

The contract follows the JAX package's root `train_tacotron.py` (the
reference's train_tacotron.py) on a dataset that
`forwardtacotron_tpu_torch.preprocess` wrote under `data_path`:

- the plain run trains the teacher per the `tacotron.training` schedule,
  resuming from `latest_model.pt` when the checkpoint directory has one,
  then extracts alignments as `--force_align` does (unless preempted);
- `--force_align` runs the trained teacher over every item and writes
  the durations (`data/alg`), the attention scores
  (`att_score_dict.pkl`) and the per-phoneme pitch and energy
  (`phon_pitch/`, `phon_energy/`), which `train_forward` trains on;
- `--extract_pitch` rewrites only the per-phoneme pitch and energy;
- `--force_gta` writes the teacher-forced postnet mels (`data/gta`).

A JAX `latest_model.fjax` in the checkpoint directory, where there is no
`latest_model.pt`, seeds the weights, the step and Adam's state (a file
written without an optimizer state leaves Adam fresh).
The checkpoint directory lies under $FTT_BASE when that is set, else
under the repository root. Without `--config` the built-in copy of
config.yaml is used. Everything runs on `--device` (default `cuda`);
`--device cpu` runs the plain PyTorch versions of the kernels. Under
torchrun each process trains on cuda:LOCAL_RANK over the global batch's
rows (`parallel/`); rank 0 alone writes the checkpoints and the alignment
files.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from forwardtacotron_tpu_torch import resolve_device
from forwardtacotron_tpu_torch.parallel import (is_main_process,
                                                training_device, wait_for_all)
from forwardtacotron_tpu_torch.align.features import (create_align_features,
                                                      create_gta_features,
                                                      extract_pitch_energy)
from forwardtacotron_tpu_torch.config import default_config, read_config
from forwardtacotron_tpu_torch.data.dataset import get_tts_datasets
from forwardtacotron_tpu_torch.models.tacotron import Tacotron
from forwardtacotron_tpu_torch.train import common as tc
from forwardtacotron_tpu_torch.train.taco_trainer import TacoTrainer
from forwardtacotron_tpu_torch.utils.checkpoints import (load_checkpoint,
                                                         restore)
from forwardtacotron_tpu_torch.utils.paths import Paths
from forwardtacotron_tpu_torch.weights import (load_fjax,
                                               load_optimizer_state,
                                               tacotron_state_dict)

SEED = 42      # the JAX trainer's fixed seed


def _restore(model, optimizer, paths: Paths, config) -> Optional[int]:
    """The step of the checkpoint loaded into model (and optimizer), or
    None when the checkpoint directory has none."""
    latest = paths.taco_checkpoints / 'latest_model.pt'
    latest_fjax = latest.with_suffix('.fjax')
    if latest.is_file():
        step = restore(model, optimizer, load_checkpoint(latest))
        print(f'Restored model and optimizer with step {step}')
        return step
    if latest_fjax.is_file():
        payload = load_fjax(latest_fjax, use_ema=False)
        step = payload['step']

        def to_state_dict(variables):
            return tacotron_state_dict(variables,
                                       config['tacotron']['model'], step)
        model.load_state_dict(to_state_dict(payload['model']))
        carried = load_optimizer_state(
            payload, [(optimizer, model, payload['model'], to_state_dict)])
        what = 'the weights and Adam' if carried else 'the weights'
        print(f'Seeded {what} from {latest_fjax} (step {step})')
        return step
    return None


def _align(model, paths: Paths, config) -> None:
    print('Creating Attention Alignments and Pitch Values...')
    train_set, val_set = get_tts_datasets(
        paths.data, 8, 1, max_mel_len=None, filter_attention=False,
        model_type='tacotron')
    create_align_features(model, train_set, val_set, paths, config,
                          pitch_max_freq=config['dsp']['pitch_max_freq'])
    print('\n\nYou can now train ForwardTacotron - use python -m '
          'forwardtacotron_tpu_torch.train_forward\n')


def main(argv: Optional[Sequence[str]] = None, writer=None
         ) -> Optional[int]:
    parser = argparse.ArgumentParser(description='Train Tacotron TTS '
                                                 '(PyTorch)')
    parser.add_argument('--force_gta', '-g', action='store_true',
                        help='Force the model to create GTA features')
    parser.add_argument('--force_align', '-a', action='store_true',
                        help='Force the model to create attention '
                             'alignment features')
    parser.add_argument('--extract_pitch', '-p', action='store_true',
                        help='Extracts phoneme-pitch values only')
    parser.add_argument('--config', metavar='FILE', default=None,
                        help='YAML (needs pyyaml) or .json config '
                             '(default: built-in copy of config.yaml)')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    config = read_config(args.config) if args.config else default_config()
    device = training_device(config, resolve_device(args.device))
    paths = Paths(config['data_path'], config['tts_model_id'])

    if args.extract_pitch:
        print('Extracting Pitch and Energy Values...')
        if is_main_process():
            extract_pitch_energy(
                paths, save_path_pitch=paths.phon_pitch,
                save_path_energy=paths.phon_energy,
                pitch_max_freq=config['dsp']['pitch_max_freq'])
        wait_for_all()
        print('\n\nYou can now train ForwardTacotron - use python -m '
              'forwardtacotron_tpu_torch.train_forward\n')
        return None

    print('\nInitialising Tacotron Model...\n')
    trainer = None if (args.force_gta or args.force_align) else \
        TacoTrainer(paths, config, device, writer=writer)
    torch.manual_seed(SEED)
    model = Tacotron.from_config(config).to(device)
    optimizer = tc.make_optimizer(model)
    step = _restore(model, optimizer, paths, config)

    if args.force_gta or args.force_align:
        if step is None:
            raise SystemExit(f'No teacher checkpoint in '
                             f'{paths.taco_checkpoints}: train the teacher '
                             'first')
        if not is_main_process():
            pass
        elif args.force_gta:
            print('Creating Ground Truth Aligned Dataset...\n')
            train_set, val_set = get_tts_datasets(
                paths.data, 8, 1,
                max_mel_len=config['tacotron']['training']['max_mel_len'],
                filter_attention=False, model_type='tacotron')
            create_gta_features(model, train_set, val_set, paths.gta, r=1)
            print('\n\nGTA mels written to', paths.gta)
        else:
            _align(model, paths, config)
        wait_for_all()
        return step

    step = trainer.train(model, optimizer, step or 0, seed=SEED)
    if trainer.preemption.requested:
        print('Preempted mid-training: latest_model saved; rerun to resume '
              '(alignment extraction deferred).')
        return step
    if is_main_process():
        _align(model, paths, config)
    wait_for_all()
    return step


if __name__ == '__main__':
    main()
