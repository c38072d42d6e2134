"""Text-to-speech CLI: text -> ForwardTacotron mel -> WaveRNN waveform.

    python -m forwardtacotron_tpu_torch.gen_forward -i "Hello world." \\
        [--checkpoint tts.pt|tts.fjax] wavernn [--voc_checkpoint voc.fjax]

The contract follows the JAX package's `gen_forward.py`: `-i`,
`--checkpoint`, `--config`, `--alpha`, `--amp`, and the `wavernn`
subcommand with `--voc_checkpoint`, `--target` and `--overlap`. Without
checkpoints the models are built from the built-in config with random
weights from `--seed`. Everything runs on `--device` (default `cuda`);
`--device cpu` runs the plain PyTorch versions of the kernels. Wavs are
written to `model_outputs/`.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from forwardtacotron_tpu_torch import resolve_device
from forwardtacotron_tpu_torch.config import default_config, read_config
from forwardtacotron_tpu_torch.dsp.audio import save_wav
from forwardtacotron_tpu_torch.models.forward_tacotron import ForwardTacotron
from forwardtacotron_tpu_torch.models.wavernn import (OVERLAP, TARGET,
                                                      WaveRNN, vocode)
from forwardtacotron_tpu_torch.text.cleaners import Cleaner
from forwardtacotron_tpu_torch.text.tokenizer import Tokenizer
from forwardtacotron_tpu_torch.utils.checkpoints import load_checkpoint
from forwardtacotron_tpu_torch.weights import (forward_tacotron_state_dict,
                                               load_fjax, wavernn_state_dict)

NOT_PORTED = ('griffinlim', 'melgan', 'hifigan')


def _bucket(n: int, multiple: int, minimum: int) -> int:
    return max(((n + multiple - 1) // multiple) * multiple, minimum)


def _seeded(build, seed: int):
    """Build a module with its random init drawn from `seed`, leaving the
    caller's global RNG state untouched."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def load_tts(checkpoint: Optional[str], config: Dict[str, Any],
             device='cuda', seed: int = 0
             ) -> Tuple[ForwardTacotron, Dict[str, Any], int]:
    """ForwardTacotron on `device` from a checkpoint: a `.pt` written by
    this package's trainer or a JAX `.fjax`. With `checkpoint` None the
    weights are random, seeded, from `config`."""
    device = resolve_device(device)
    step = 0
    if checkpoint is not None and str(checkpoint).endswith('.pt'):
        payload = load_checkpoint(checkpoint)
        config, step = payload['config'], payload['step']
        model = ForwardTacotron.from_config(config)
        model.load_state_dict(payload['model'])
    elif checkpoint is not None:
        if not str(checkpoint).endswith('.fjax'):
            raise ValueError('TTS checkpoints are .pt (this package) or '
                             '.fjax (the JAX package)')
        payload = load_fjax(checkpoint)
        config, step = payload['config'], payload['step']
        model = ForwardTacotron.from_config(config)
        model.load_state_dict(forward_tacotron_state_dict(
            payload['model'], config['forward_tacotron']['model'], step))
    else:
        model = _seeded(lambda: ForwardTacotron.from_config(config), seed)
    return model.to(device).eval(), config, step


def load_voc(checkpoint: Optional[str], config: Dict[str, Any],
             device='cuda', seed: int = 0) -> Tuple[WaveRNN, Dict[str, Any]]:
    """WaveRNN on `device` from a `.fjax` checkpoint, or seeded random
    weights."""
    device = resolve_device(device)
    if checkpoint is not None:
        if not str(checkpoint).endswith('.fjax'):
            raise ValueError('only .fjax vocoder checkpoints are supported')
        payload = load_fjax(checkpoint)
        config = payload['config']
        model = WaveRNN.from_config(config)
        model.load_state_dict(wavernn_state_dict(
            payload['model'], config['vocoder']['model'], payload['step']))
    else:
        model = _seeded(lambda: WaveRNN.from_config(config), seed + 1)
    return model.to(device).eval(), config


def text_to_ids(text: str, config: Dict[str, Any]) -> List[int]:
    return Tokenizer()(Cleaner.from_config(config)(text))


def synthesize(model: ForwardTacotron, text_ids: Sequence[int],
               alpha: float = 1.0, amp: float = 1.0,
               mel_multiple: int = 256,
               compute_dtype: torch.dtype = torch.bfloat16) -> np.ndarray:
    """Phoneme ids -> mel_post (n_mels, T): predict the series on a
    16-token bucket, scale the pitch by `amp`, then expand and decode on
    a `mel_multiple` frame bucket."""
    device = next(model.parameters()).device
    x_len = len(text_ids)
    x = torch.zeros((1, _bucket(x_len, 16, 16)), dtype=torch.long,
                    device=device)
    x[0, :x_len] = torch.as_tensor(list(text_ids), device=device)
    xl = torch.tensor([x_len], device=device)
    series = model.predict_series(x, alpha=alpha, x_len=xl,
                                  compute_dtype=compute_dtype)
    dur = series['dur'][0, :x_len].float().cpu().numpy()
    total = int(np.sum(np.floor(np.maximum(dur, 0) + 0.5)))
    max_t = _bucket(total + 1, mel_multiple, mel_multiple)
    gen = model.generate_from_series(x, series['dur'], series['pitch'] * amp,
                                     series['energy'], max_t, x_len=xl,
                                     compute_dtype=compute_dtype)
    mel_len = int(gen['mel_len'][0])
    return gen['mel_post'][0, :mel_len].T.float().cpu().numpy()


def main(argv: Optional[Sequence[str]] = None) -> List[Path]:
    parser = argparse.ArgumentParser(description='TTS Generator (PyTorch)')
    parser.add_argument('--input_text', '-i', default=None, type=str,
                        help='text to speak (default: every line of '
                             'sentences.txt)')
    parser.add_argument('--checkpoint', type=str, default=None,
                        help='ForwardTacotron .pt (this package) or .fjax '
                             'file (default: random weights from --seed)')
    parser.add_argument('--config', metavar='FILE', default=None,
                        help='YAML config used without a checkpoint '
                             '(needs pyyaml; default: built-in config)')
    parser.add_argument('--alpha', type=float, default=1.0,
                        help='length regulator speed control')
    parser.add_argument('--amp', type=float, default=1.0,
                        help='pitch amplification')
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--seed', type=int, default=0,
                        help='seed of random weights and of sampling')
    subparsers = parser.add_subparsers(dest='vocoder')
    wr = subparsers.add_parser('wavernn')
    wr.add_argument('--overlap', '-o', default=OVERLAP, type=int)
    wr.add_argument('--target', '-t', default=TARGET, type=int)
    wr.add_argument('--voc_checkpoint', type=str, default=None)
    wr.add_argument('--stream', action='store_true')
    wr.add_argument('--batched_utterances', action='store_true')
    for name in NOT_PORTED:
        subparsers.add_parser(name)
    args = parser.parse_args(argv)

    if args.vocoder in NOT_PORTED:
        parser.error(f'vocoder {args.vocoder!r} is not ported yet; use '
                     'wavernn')
    if args.vocoder != 'wavernn':
        parser.error('please choose a vocoder: wavernn')
    if args.stream or args.batched_utterances:
        parser.error('--stream and --batched_utterances are not ported yet')
    if args.alpha <= 0:
        parser.error('--alpha must be > 0')

    config = read_config(args.config) if args.config else default_config()
    model, config, step = load_tts(args.checkpoint, config, args.device,
                                   args.seed)
    voc_model, voc_config = load_voc(args.voc_checkpoint, config,
                                     args.device, args.seed)
    mu_law = voc_config['dsp']['mu_law']

    if args.input_text:
        texts = [args.input_text]
    else:
        with open('sentences.txt', encoding='utf-8') as f:
            texts = [line for line in f.read().splitlines() if line.strip()]

    out_dir = Path('model_outputs')
    out_dir.mkdir(parents=True, exist_ok=True)
    tts_k = step // 1000
    written = []
    for i, text in enumerate(texts, 1):
        t0 = time.perf_counter()
        mel = synthesize(model, text_to_ids(text, config), args.alpha,
                         args.amp)
        wav = vocode(voc_model, mel, target=args.target,
                     overlap=args.overlap, mu_law=mu_law, seed=args.seed,
                     pcm16=True)
        path = out_dir / (f'{i}_forward_{tts_k}k_alpha{args.alpha}_'
                          f'amp{args.amp}_wavernn.wav')
        save_wav(wav, path, voc_config['dsp']['sample_rate'])
        written.append(path)
        print(f'| {i}/{len(texts)} {path} ({mel.shape[1]} frames, '
              f'{len(wav)} samples, {time.perf_counter() - t0:.2f} s)')
    return written


if __name__ == '__main__':
    main()
