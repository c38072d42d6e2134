"""Student training CLI: ForwardTacotron or FastPitch, as the config's
`tts_model` names.

    python -m forwardtacotron_tpu_torch.train_forward [--config FILE] \\
        [--device cuda]

The contract follows the JAX package's `train_forward.py`: it needs the
durations (`data/alg`) and the per-phoneme pitch/energy of a preprocessed
dataset under `data_path`, trains per the config's schedule and resumes
from `latest_model.pt` when the checkpoint directory has one: its raw
weights ('raw_model' where the file keeps EMA weights under 'model'), the
optimizer and, with `ema_decay` > 0, the EMA weights. A JAX
`latest_model.fjax` there instead seeds the weights, the step and Adam's
state (fresh when the file has none): its raw parameters, as the JAX
trainer resumes, and with
`ema_decay` > 0 the EMA from its `ema_params`, or from the raw parameters
where it has none (the JAX package's `train_forward.py:100-119`); with
`ema_decay` 0 a stored EMA is dropped. The checkpoint directory
lies under $FTT_BASE when that is set, else under the repository root.
Without `--config` the built-in copy of config.yaml is
used. Everything runs on `--device` (default `cuda`); `--device cpu` runs
the plain PyTorch versions of the kernels. `--force_gta` trains nothing:
it runs the trained student teacher-forced over the whole dataset and
writes each item's postnet mel to `data/gta`, the mels that
`train_wavernn --gta` and `train_hifigan --gta` learn from; it uses the
raw weights, as the JAX package's `create_gta_features` applies
`state.variables`. Under torchrun (`python -m torch.distributed.run
--nproc_per_node N -m forwardtacotron_tpu_torch.train_forward`) each
process trains on cuda:LOCAL_RANK over the global batch's rows
(`parallel/`), and rank 0 alone writes the checkpoints and the GTA mels.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from forwardtacotron_tpu_torch import resolve_device
from forwardtacotron_tpu_torch.parallel import (is_main_process,
                                                training_device, wait_for_all)
from forwardtacotron_tpu_torch.config import default_config, read_config
from forwardtacotron_tpu_torch.data.dataset import get_tts_datasets
from forwardtacotron_tpu_torch.train import common as tc
from forwardtacotron_tpu_torch.train.forward_trainer import (
    ForwardTrainer, batch_to_device)
from forwardtacotron_tpu_torch.utils.checkpoints import (init_tts_model,
                                                         load_checkpoint,
                                                         restore)
from forwardtacotron_tpu_torch.utils.display import progbar, stream
from forwardtacotron_tpu_torch.utils.paths import Paths
from forwardtacotron_tpu_torch.weights import (load_fjax,
                                               load_optimizer_state,
                                               tts_state_dict)

SEED = 42      # the JAX trainer's fixed seed


def create_gta_features(model: torch.nn.Module, train_set, val_set,
                        save_path: Path) -> int:
    """Write the teacher-forced postnet mel (n_mels, mel_len) of every
    real item of the two batchers to `save_path`, the model in eval mode
    under no_grad on its device (the JAX package's
    `train_forward.py:create_gta_features`). Returns the items written."""
    device = next(model.parameters()).device
    model.eval()
    iters, n_items = len(train_set) + len(val_set), 0
    for i, batch in enumerate((b for batcher in (train_set, val_set)
                               for b in batcher), 1):
        with torch.no_grad():
            gta = model(batch_to_device(batch, device))['mel_post']
        gta = gta.cpu().numpy()
        for j in range(batch.get('n_real', gta.shape[0])):
            mel_len = int(batch['mel_len'][j])
            np.save(str(save_path / f'{batch["item_id"][j]}.npy'),
                    gta[j, :mel_len].T.astype(np.float32),
                    allow_pickle=False)
            n_items += 1
        stream(f'{progbar(i, iters)} {i}/{iters} Batches ')
    return n_items


def main(argv: Optional[Sequence[str]] = None, writer=None) -> int:
    parser = argparse.ArgumentParser(description='Train ForwardTacotron or '
                                                 'FastPitch TTS (PyTorch)')
    parser.add_argument('--force_gta', '-g', action='store_true',
                        help='write the GTA mels of a trained model to '
                             'data/gta')
    parser.add_argument('--config', metavar='FILE', default=None,
                        help='YAML (needs pyyaml) or .json config '
                             '(default: built-in copy of config.yaml)')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    config = read_config(args.config) if args.config else default_config()
    device = training_device(config, resolve_device(args.device))
    paths = Paths(config['data_path'], config['tts_model_id'])
    if not any(paths.alg.iterdir()):
        raise SystemExit(f'Could not find alignment files in {paths.alg}; '
                         'extract durations first (python -m '
                         'forwardtacotron_tpu_torch.train_tacotron '
                         '--force_align).')
    trainer = ForwardTrainer(paths, config, device, writer=writer)

    torch.manual_seed(SEED)
    model = init_tts_model(config).to(device)
    print(f'Initialized tts model: {type(model).__name__}')
    optimizer = tc.make_optimizer(model)
    trainer.ema = tc.make_ema(model, trainer.train_cfg)
    step = 0
    latest = paths.forward_checkpoints / 'latest_model.pt'
    latest_fjax = latest.with_suffix('.fjax')
    if latest.is_file():
        step = restore(model, optimizer, load_checkpoint(latest),
                       trainer.ema)
        print(f'Restored model and optimizer with step {step}')
    elif latest_fjax.is_file():
        payload = load_fjax(latest_fjax, use_ema=False)
        step = payload['step']

        def to_state_dict(variables):
            return tts_state_dict(variables, config, step)
        model.load_state_dict(to_state_dict(payload['model']))
        if trainer.ema is not None:
            ema = load_fjax(latest_fjax, use_ema=True)['model']
            trainer.ema.load(to_state_dict(ema), model)
        carried = load_optimizer_state(
            payload, [(optimizer, model, payload['model'], to_state_dict)])
        what = 'the weights and Adam' if carried else 'the weights'
        print(f'Seeded {what} from {latest_fjax} (step {step})')
    if args.force_gta:
        if not (latest.is_file() or latest_fjax.is_file()):
            raise SystemExit(f'No student checkpoint in '
                             f'{paths.forward_checkpoints}: train the model '
                             'first (GTA features need a trained model)')
        print('Creating Ground Truth Aligned Dataset...\n')
        train_set, val_set = get_tts_datasets(
            paths.data, 8, 1, max_mel_len=None, filter_attention=False,
            model_type='forward')
        if is_main_process():
            create_gta_features(model, train_set, val_set, paths.gta)
        wait_for_all()
        print('\n\nYou can now train WaveRNN on GTA features - use python '
              '-m forwardtacotron_tpu_torch.train_wavernn --gta\n')
        return step
    return trainer.train(model, optimizer, step, seed=SEED)


if __name__ == '__main__':
    main()
