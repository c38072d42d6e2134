"""Adversarial GAN vocoder training CLI.

    python -m forwardtacotron_tpu_torch.train_hifigan [--gta] \\
        [--config FILE] [--device cuda]

The contract follows the JAX package's `train_hifigan.py`: the generator
of `hifigan.model` (`generator_type` hifigan or melgan) trains against
the MPD and MSD discriminators on the quant labels and mels (`--gta`: the
student's ground-truth-aligned mels of `data/gta`) of a preprocessed
dataset, per `hifigan.training`, and resumes from `latest_model.pt`
(both nets, both optimizers, the step) when the checkpoint directory has
one; a JAX `latest_model.fjax` there instead seeds both nets, the step
and both AdamW states (fresh when the file has none), as the JAX
package's `train_hifigan.py` resumes its own file. The checkpoint
directory lies under $FTT_BASE when that is set, else under the
repository root; `gen_forward hifigan|melgan --voc_checkpoint` serves its
files. Without `--config` the built-in copy of config.yaml is used.
Everything runs on `--device` (default `cuda`).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from forwardtacotron_tpu_torch import resolve_device
from forwardtacotron_tpu_torch.parallel import training_device
from forwardtacotron_tpu_torch.config import default_config, read_config
from forwardtacotron_tpu_torch.dsp.audio import DSP
from forwardtacotron_tpu_torch.models.gan_discriminators import (
    HiFiGANDiscriminators)
from forwardtacotron_tpu_torch.models.hifigan import make_generator
from forwardtacotron_tpu_torch.train.hifigan_trainer import (
    HiFiGANTrainer, load_generator, make_gan_optimizer)
from forwardtacotron_tpu_torch.utils.checkpoints import load_checkpoint
from forwardtacotron_tpu_torch.utils.paths import Paths
from forwardtacotron_tpu_torch.weights import (ADAMW_HYPERPARAMS,
                                               discriminator_state_dict,
                                               hifigan_state_dict, load_fjax,
                                               load_optimizer_state)

SEED = 42


def main(argv: Optional[Sequence[str]] = None, writer=None) -> int:
    parser = argparse.ArgumentParser(
        description='Train the HiFi-GAN vocoder (generator + MPD/MSD '
                    'discriminators; PyTorch)')
    parser.add_argument('--gta', '-g', action='store_true',
                        help='train on GTA features from the student')
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
    print('\nInitialising GAN vocoder...\n')
    torch.manual_seed(SEED)
    gen = make_generator(config).to(device)
    disc = HiFiGANDiscriminators().to(device)
    if gen.hop_length != dsp.hop_length:
        raise ValueError('generator upsample_rates must factorise '
                         'dsp.hop_length')
    trainer = HiFiGANTrainer(paths, dsp, config, device, writer=writer)
    gen_opt, disc_opt = make_gan_optimizer(gen), make_gan_optimizer(disc)
    step = 0
    latest = paths.hifigan_checkpoints / 'latest_model.pt'
    latest_fjax = latest.with_suffix('.fjax')
    if latest.is_file():
        payload = load_checkpoint(latest)
        load_generator(gen, payload)
        disc.load_state_dict(payload['discriminator'])
        gen_opt.load_state_dict(payload['optim_g'])
        disc_opt.load_state_dict(payload['optim_d'])
        step = int(payload['step'])
        print(f'Restored model with step {step}')
    elif latest_fjax.is_file():
        payload = load_fjax(latest_fjax, use_ema=False)
        params, step = payload['model']['params'], payload['step']
        entries = [
            (gen_opt, gen, {'params': params['generator']},
             lambda v: hifigan_state_dict(v, config)),
            (disc_opt, disc, {'params': params['discriminator']},
             discriminator_state_dict)]
        for _, model, variables, to_state_dict in entries:
            model.load_state_dict(to_state_dict(variables))
        carried = load_optimizer_state(payload, entries, ADAMW_HYPERPARAMS)
        what = 'both nets and both AdamW states' if carried else 'both nets'
        print(f'Seeded {what} from {latest_fjax} (step {step})')
    return trainer.train(gen, disc, gen_opt, disc_opt, step,
                         train_gta=args.gta)


if __name__ == '__main__':
    main()
