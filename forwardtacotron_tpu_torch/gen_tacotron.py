"""Free-running synthesis from the Tacotron teacher: text -> mel ->
waveform.

    python -m forwardtacotron_tpu_torch.gen_tacotron -i "Hello world." \\
        [--checkpoint taco.pt|taco.fjax] [--steps 1000] \\
        {griffinlim | wavernn [--voc_checkpoint voc.pt|voc.fjax]
         [--target N] [--overlap N] | hifigan [--voc_checkpoint g.pt]
         [--voc_config config.json] | melgan [--voc_checkpoint g.pt]}

The contract follows the JAX package's `gen_tacotron.py`: `-i`,
`--checkpoint`, `--config`, `--speaker` (the voice of a multi-speaker
teacher, range-checked as `gen_forward`'s), `--steps` (at most that many
frames, r = 1) and the four
vocoder subcommands, built and written as `gen_forward`'s (its `hifigan
--voc_config` too); `hifigan` and `melgan` without `--voc_checkpoint`
export the mels (`.npy`, `.mel`). The teacher is a `.pt` of this
package's `train_tacotron` or a JAX `.fjax`; without `--checkpoint` the
`latest_model.pt` (or `.fjax`) of the config's teacher directory, and
where there is none random weights from `--seed`. Outputs are written to
`model_outputs/` as `{i}_tacotron_{k}k_{vocoder}`. Everything runs on
`--device` (default `cuda`): the decoder's steps in PyTorch ops, the two
CBHG BiGRUs through kernel #1, WaveRNN through kernel #4; `--device cpu`
runs the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from forwardtacotron_tpu_torch.config import default_config, read_config
from forwardtacotron_tpu_torch.dsp.audio import DSP
from forwardtacotron_tpu_torch.gen_forward import (VOCODERS,
                                                   add_vocoder_subcommands,
                                                   check_speaker,
                                                   load_vocoder, load_weights,
                                                   read_texts, text_to_ids,
                                                   write_output)
from forwardtacotron_tpu_torch.models.tacotron import Tacotron
from forwardtacotron_tpu_torch.utils.paths import Paths
from forwardtacotron_tpu_torch.weights import tacotron_state_dict


def _tacotron_state_dict(variables, config, step):
    return tacotron_state_dict(variables, config['tacotron']['model'], step)


def synthesize(model: Tacotron, text_ids: Sequence[int],
               steps: int = 1000, speaker: int = 0) -> np.ndarray:
    """Phoneme ids -> the teacher's linear (postnet) mel (n_mels, T) of
    its valid frames, at r = 1, in the voice `speaker`."""
    device = next(model.parameters()).device
    x = torch.as_tensor([list(text_ids)], dtype=torch.long, device=device)
    spk = torch.tensor([int(speaker)], device=device)
    _, linear, _, n_valid = model.generate(x, steps, 1, speaker=spk)
    return linear[0, :max(n_valid, 1)].T.float().cpu().numpy()


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='TTS Generator (Tacotron, PyTorch)')
    parser.add_argument('--input_text', '-i', default=None, type=str,
                        help='text to speak (default: every line of '
                             'sentences.txt)')
    parser.add_argument('--checkpoint', type=str, default=None,
                        help='Tacotron .pt (this package) or .fjax file '
                             '(default: the config\'s latest_model, else '
                             'random weights from --seed)')
    parser.add_argument('--config', metavar='FILE', default=None,
                        help='YAML (needs pyyaml) or .json config '
                             '(default: built-in config)')
    parser.add_argument('--speaker', type=int, default=0,
                        help='speaker id of a multi-speaker teacher, in '
                             '[0, n_speakers)')
    parser.add_argument('--steps', type=int, default=1000,
                        help='most decoder steps (frames) per utterance')
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--seed', type=int, default=0,
                        help='seed of random weights and of sampling')
    add_vocoder_subcommands(parser)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> List[Path]:
    parser = _parser()
    args = parser.parse_args(argv)
    if args.vocoder not in VOCODERS:
        parser.error(f'please choose a vocoder: {", ".join(VOCODERS)}')
    if args.steps < 1:
        parser.error('--steps must be >= 1')

    config = read_config(args.config) if args.config else default_config()
    checkpoint = args.checkpoint
    if checkpoint is None:
        latest = Paths(config['data_path'], config['tts_model_id']) \
            .taco_checkpoints / 'latest_model.pt'
        for path in (latest, latest.with_suffix('.fjax')):
            if path.is_file():
                checkpoint = str(path)
                break
        else:
            print(f'| No teacher in {latest.parent}: random weights from '
                  f'seed {args.seed}')
    model, config, step = load_weights(checkpoint, config,
                                       Tacotron.from_config,
                                       _tacotron_state_dict, args.device,
                                       args.seed)
    error = check_speaker(model, args.speaker, 'checkpoint')
    if error:
        parser.error(f'--{error}')
    dsp = DSP.from_config(config, args.device)
    voc_model, mu_law = load_vocoder(args, config)
    texts = read_texts(args)
    out_dir = Path('model_outputs')
    out_dir.mkdir(parents=True, exist_ok=True)
    tts_k = step // 1000
    print(f'| Tacotron {tts_k}k, vocoder {args.vocoder}')
    written = []
    for i, text in enumerate(texts, 1):
        t0 = time.perf_counter()
        mel = synthesize(model, text_to_ids(text, config), args.steps,
                         args.speaker)
        path = write_output(args, mel, out_dir,
                            f'{i}_tacotron_{tts_k}k_{args.vocoder}', dsp,
                            voc_model, mu_law)
        written.append(path)
        print(f'| {i}/{len(texts)} {path} ({mel.shape[1]} frames, '
              f'{time.perf_counter() - t0:.2f} s)')
    return written


if __name__ == '__main__':
    main()
