"""ForwardTacotron student training CLI.

    python -m forwardtacotron_tpu_torch.train_forward [--config FILE] \\
        [--device cuda]

The contract follows the JAX package's `train_forward.py`: it needs the
durations (`data/alg`) and the per-phoneme pitch/energy of a preprocessed
dataset under `data_path`, trains per the config's schedule and resumes
from `latest_model.pt` when the checkpoint directory has one. A JAX
`latest_model.fjax` there instead seeds the weights and the step, with a
fresh optimizer: its raw parameters, not its EMA weights, as the JAX
trainer resumes (the port trains without EMA). The checkpoint directory
lies under $FTT_BASE when that is set, else under the repository root.
Without `--config` the built-in copy of config.yaml is
used. Everything runs on `--device` (default `cuda`); `--device cpu` runs
the plain PyTorch versions of the kernels. `--force_gta` (ground-truth-
aligned features for the vocoder) is not ported yet.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from forwardtacotron_tpu_torch import resolve_device
from forwardtacotron_tpu_torch.config import default_config, read_config
from forwardtacotron_tpu_torch.models.forward_tacotron import ForwardTacotron
from forwardtacotron_tpu_torch.train import common as tc
from forwardtacotron_tpu_torch.train.forward_trainer import ForwardTrainer
from forwardtacotron_tpu_torch.utils.checkpoints import (load_checkpoint,
                                                         restore)
from forwardtacotron_tpu_torch.utils.paths import Paths
from forwardtacotron_tpu_torch.weights import (forward_tacotron_state_dict,
                                               load_fjax)

SEED = 42      # the JAX trainer's fixed seed


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description='Train ForwardTacotron TTS '
                                                 '(PyTorch)')
    parser.add_argument('--force_gta', '-g', action='store_true',
                        help='create GTA features (not ported yet)')
    parser.add_argument('--config', metavar='FILE', default=None,
                        help='YAML config (needs pyyaml; default: built-in '
                             'copy of config.yaml)')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)
    if args.force_gta:
        parser.error('--force_gta is not ported yet')

    config = read_config(args.config) if args.config else default_config()
    device = resolve_device(args.device)
    paths = Paths(config['data_path'], config['tts_model_id'])
    if not any(paths.alg.iterdir()):
        raise SystemExit(f'Could not find alignment files in {paths.alg}; '
                         'extract durations first (python -m '
                         'forwardtacotron_tpu_torch.train_tacotron '
                         '--force_align).')
    trainer = ForwardTrainer(paths, config, device)

    torch.manual_seed(SEED)
    model = ForwardTacotron.from_config(config).to(device)
    print(f'Initialized tts model: {type(model).__name__}')
    optimizer = tc.make_optimizer(model)
    step = 0
    latest = paths.forward_checkpoints / 'latest_model.pt'
    latest_fjax = latest.with_suffix('.fjax')
    if latest.is_file():
        step = restore(model, optimizer, load_checkpoint(latest))
        print(f'Restored model and optimizer with step {step}')
    elif latest_fjax.is_file():
        payload = load_fjax(latest_fjax, use_ema=False)
        step = payload['step']
        model.load_state_dict(forward_tacotron_state_dict(
            payload['model'], config['forward_tacotron']['model'], step))
        print(f'Seeded the weights from {latest_fjax} (step {step}); the '
              'optimizer state is not converted and starts fresh')
    return trainer.train(model, optimizer, step, seed=SEED)


if __name__ == '__main__':
    main()
