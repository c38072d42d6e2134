"""WaveRNN vocoder training CLI.

    python -m forwardtacotron_tpu_torch.train_wavernn [--gta] \\
        [--config FILE] [--device cuda]

The contract follows the JAX package's `train_wavernn.py`: it trains on
the quant labels and mels (`--gta`: the student's ground-truth-aligned
mels of `data/gta`, written by `train_forward --force_gta`) of a
preprocessed dataset under `data_path`, per `vocoder.training`, and
resumes from `latest_model.pt` when the checkpoint directory has one. A
JAX `latest_model.fjax` there instead seeds the weights, the step and
Adam's state (fresh when the file has none). The checkpoint directory
lies under $FTT_BASE when that is set, else under the repository root.
Without `--config` the built-in copy of config.yaml is used. Everything
runs on `--device` (default `cuda`); `--device cpu` runs the plain
PyTorch versions of the kernels.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from forwardtacotron_tpu_torch import resolve_device
from forwardtacotron_tpu_torch.parallel import training_device
from forwardtacotron_tpu_torch.config import default_config, read_config
from forwardtacotron_tpu_torch.dsp.audio import DSP
from forwardtacotron_tpu_torch.models.wavernn import WaveRNN
from forwardtacotron_tpu_torch.train import common as tc
from forwardtacotron_tpu_torch.train.voc_trainer import VocTrainer
from forwardtacotron_tpu_torch.utils.checkpoints import (load_checkpoint,
                                                         restore)
from forwardtacotron_tpu_torch.utils.paths import Paths
from forwardtacotron_tpu_torch.weights import (load_fjax,
                                               load_optimizer_state,
                                               wavernn_state_dict)

SEED = 42


def main(argv: Optional[Sequence[str]] = None, writer=None) -> int:
    parser = argparse.ArgumentParser(description='Train WaveRNN Vocoder '
                                                 '(PyTorch)')
    parser.add_argument('--gta', '-g', action='store_true',
                        help='train wavernn on GTA features')
    parser.add_argument('--config', metavar='FILE', default=None,
                        help='YAML (needs pyyaml) or .json config '
                             '(default: built-in copy of config.yaml)')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    config = read_config(args.config) if args.config else default_config()
    device = training_device(config, resolve_device(args.device))
    paths = Paths(config['data_path'], config['tts_model_id'],
                  voc_id=config['voc_model_id'])
    dsp = DSP.from_config(config, device=device)
    if np.cumprod(config['vocoder']['model']['upsample_factors'])[-1] \
            != dsp.hop_length:
        raise ValueError('upsample_factors must factorise hop_length')
    trainer = VocTrainer(paths, dsp, config, device, writer=writer)

    print('\nInitialising Model...\n')
    torch.manual_seed(SEED)
    model = WaveRNN.from_config(config).to(device)
    optimizer = tc.make_optimizer(model)
    step = 0
    latest = paths.voc_checkpoints / 'latest_model.pt'
    latest_fjax = latest.with_suffix('.fjax')
    if latest.is_file():
        step = restore(model, optimizer, load_checkpoint(latest))
        print(f'Restored model and optimizer with step {step}')
    elif latest_fjax.is_file():
        payload = load_fjax(latest_fjax, use_ema=False)
        step = payload['step']

        def to_state_dict(variables):
            return wavernn_state_dict(variables,
                                      config['vocoder']['model'], step)
        model.load_state_dict(to_state_dict(payload['model']))
        carried = load_optimizer_state(
            payload, [(optimizer, model, payload['model'], to_state_dict)])
        what = 'the weights and Adam' if carried else 'the weights'
        print(f'Seeded {what} from {latest_fjax} (step {step})')
    return trainer.train(model, optimizer, step, train_gta=args.gta)


if __name__ == '__main__':
    main()
