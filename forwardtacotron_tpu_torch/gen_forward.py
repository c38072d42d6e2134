"""Text-to-speech CLI: text -> ForwardTacotron or FastPitch mel ->
waveform.

    python -m forwardtacotron_tpu_torch.gen_forward -i "Hello world." \\
        [--checkpoint tts.pt|tts.fjax] [--split_sentences] \\
        {griffinlim | wavernn [--voc_checkpoint voc.pt|voc.fjax] [--stream]
         [--batched_utterances] | hifigan [--voc_checkpoint g.pt]
         [--voc_config config.json] | melgan [--voc_checkpoint g.pt]}

The contract follows the JAX package's `gen_forward.py`: `-i`,
`--checkpoint`, `--config`, `--alpha`, `--amp`, `--speaker` (the voice of
a multi-speaker model, range-checked against its `n_speakers`),
`--split_sentences` and the four vocoder subcommands. The TTS model is the
one the checkpoint's config (or `--config`) names in `tts_model`:
`forward_tacotron` or `fast_pitch`. `hifigan` and `melgan` without
`--voc_checkpoint` export the mels (`.npy`, `.mel`) as the reference does.
Without checkpoints the TTS model and WaveRNN are built from the built-in
config with random weights from `--seed`. Everything runs on `--device`
(default `cuda`); `--device cpu` runs the plain PyTorch versions of the
kernels. Outputs are written to `model_outputs/`.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from forwardtacotron_tpu_torch import resolve_device
from forwardtacotron_tpu_torch.config import default_config, read_config
from forwardtacotron_tpu_torch.data.dataset import MEL_PAD
from forwardtacotron_tpu_torch.dsp.audio import DSP
from forwardtacotron_tpu_torch.models.hifigan import (load_hifigan,
                                                      vocode_generator)
from forwardtacotron_tpu_torch.models.melgan import load_melgan
from forwardtacotron_tpu_torch.models.streaming import (stream_wav,
                                                        write_wav_streaming)
from forwardtacotron_tpu_torch.models.wavernn import (OVERLAP, WaveRNN,
                                                      vocode, vocode_batch)
from forwardtacotron_tpu_torch.text.cleaners import Cleaner
from forwardtacotron_tpu_torch.text.segmenter import split_sentences
from forwardtacotron_tpu_torch.text.tokenizer import Tokenizer
from forwardtacotron_tpu_torch.utils.checkpoints import (init_tts_model,
                                                         load_checkpoint)
from forwardtacotron_tpu_torch.weights import (load_fjax, tts_state_dict,
                                               wavernn_state_dict)

VOCODERS = ('griffinlim', 'wavernn', 'melgan', 'hifigan')
SENTENCE_GAP_FRAMES = 10      # MEL_PAD frames between split sentences


def _bucket(n: int, multiple: int, minimum: int) -> int:
    return max(((n + multiple - 1) // multiple) * multiple, minimum)


def _seeded(build, seed: int):
    """Build a module with its random init drawn from `seed`, leaving the
    caller's global RNG state untouched."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def load_weights(checkpoint: Optional[str], config: Dict[str, Any],
                 build: Callable[[Dict[str, Any]], torch.nn.Module],
                 convert: Callable[..., Dict[str, torch.Tensor]],
                 device='cuda', seed: int = 0
                 ) -> Tuple[torch.nn.Module, Dict[str, Any], int]:
    """`build(config)` on `device` in eval mode, with its weights from a
    checkpoint: a `.pt` file or `.dcp` directory written by this
    package's trainers, or a JAX `.fjax` turned into the state_dict by
    `convert(variables, config, step)`; either's config replaces `config`.
    With `checkpoint` None the weights are random, seeded, from `config`."""
    device = resolve_device(device)
    step = 0
    if checkpoint is not None and Path(checkpoint).suffix in ('.pt', '.dcp'):
        payload = load_checkpoint(checkpoint)
        config, step = payload['config'], payload['step']
        model = build(config)
        model.load_state_dict(payload['model'])
    elif checkpoint is not None:
        if not str(checkpoint).endswith('.fjax'):
            raise ValueError('checkpoints are .pt or .dcp (this package) '
                             'or .fjax (the JAX package)')
        payload = load_fjax(checkpoint)
        config, step = payload['config'], payload['step']
        model = build(config)
        model.load_state_dict(convert(payload['model'], config, step))
    else:
        model = _seeded(lambda: build(config), seed)
    return model.to(device).eval(), config, step


def load_tts(checkpoint: Optional[str], config: Dict[str, Any],
             device='cuda', seed: int = 0
             ) -> Tuple[torch.nn.Module, Dict[str, Any], int]:
    """The TTS model that the config's `tts_model` names (ForwardTacotron
    or FastPitch) through `load_weights`."""
    return load_weights(checkpoint, config, init_tts_model, tts_state_dict,
                        device, seed)


def tts_dtype(model: torch.nn.Module,
              compute_dtype: torch.dtype) -> torch.dtype:
    """The type a TTS model infers in: FastPitch its own (float32, as the
    JAX model), ForwardTacotron's recurrences `compute_dtype`."""
    return getattr(model, 'inference_dtype', compute_dtype)


def _wavernn_state_dict(variables, config, step):
    return wavernn_state_dict(variables, config['vocoder']['model'], step)


def load_voc(checkpoint: Optional[str], config: Dict[str, Any],
             device='cuda', seed: int = 0) -> Tuple[WaveRNN, Dict[str, Any]]:
    """WaveRNN through `load_weights` (a `.pt` of this package's
    `train_wavernn`, a JAX `.fjax`, or random weights from `seed` + 1)."""
    model, config, _ = load_weights(checkpoint, config, WaveRNN.from_config,
                                    _wavernn_state_dict, device, seed + 1)
    return model, config


def load_vocoder(args: argparse.Namespace, config: Dict[str, Any]
                 ) -> Tuple[Optional[torch.nn.Module], Optional[bool]]:
    """The vocoder of `args.vocoder` on `args.device` and WaveRNN's
    `mu_law`: WaveRNN (`load_voc`), a GAN generator from
    `--voc_checkpoint`, or None (Griffin-Lim; a GAN without a checkpoint
    exports the mels)."""
    if args.vocoder == 'wavernn':
        voc_model, voc_config = load_voc(args.voc_checkpoint, config,
                                         args.device, args.seed)
        return voc_model, voc_config['dsp']['mu_law']
    if args.vocoder == 'hifigan' and args.voc_checkpoint:
        voc_config = None
        if args.voc_config:
            with open(args.voc_config, encoding='utf-8') as f:
                voc_config = json.load(f)
        return load_hifigan(args.voc_checkpoint, voc_config,
                            args.device), None
    if args.vocoder == 'melgan' and args.voc_checkpoint:
        return load_melgan(args.voc_checkpoint, device=args.device), None
    return None, None


def write_output(args: argparse.Namespace, mel: np.ndarray, out_dir: Path,
                 name: str, dsp: DSP, voc_model: Optional[torch.nn.Module],
                 mu_law: Optional[bool]) -> Path:
    """One mel (n_mels, T) -> `out_dir/name` and the suffix of what is
    written: the mel exported (`.mel` for MelGAN, `.npy` for HiFi-GAN)
    where a GAN has no generator, else a wav by the GAN, Griffin-Lim or
    WaveRNN (one utterance, `--target` and `--overlap`)."""
    if args.vocoder in ('melgan', 'hifigan') and voc_model is None:
        if args.vocoder == 'melgan':
            path = out_dir / f'{name}.mel'
            torch.save(torch.tensor(mel[None]), path)
        else:
            path = out_dir / f'{name}.npy'
            np.save(path, mel[None], allow_pickle=False)
        return path
    path = out_dir / f'{name}.wav'
    if args.vocoder in ('melgan', 'hifigan'):
        dsp.save_wav(vocode_generator(voc_model, mel, pcm16=True), path)
    elif args.vocoder == 'griffinlim':
        dsp.save_wav(dsp.griffinlim(mel, seed=args.seed), path)
    else:
        dsp.save_wav(vocode(voc_model, mel, target=args.target,
                            overlap=args.overlap, mu_law=mu_law,
                            seed=args.seed, pcm16=True), path)
    return path


def text_to_ids(text: str, config: Dict[str, Any]) -> List[int]:
    return Tokenizer()(Cleaner.from_config(config)(text))


def check_speaker(model: torch.nn.Module, speaker: int,
                  what: str = 'model') -> Optional[str]:
    """The error of a speaker id outside [0, n_speakers) of `model` (a
    single-speaker model has speaker 0 only), else None; `what` names the
    model in the message ('checkpoint' in the CLIs, as JAX's)."""
    n_spk = getattr(model, 'n_speakers', 1)
    if not 0 <= int(speaker) < n_spk:
        return f'speaker {speaker} out of range for a {n_spk}-speaker {what}'
    return None


def synthesize(model: torch.nn.Module, text_ids: Sequence[int],
               alpha: float = 1.0, amp: float = 1.0,
               mel_multiple: int = 256, energy_scale: float = 1.0,
               compute_dtype: torch.dtype = torch.bfloat16,
               speaker: int = 0) -> np.ndarray:
    """Phoneme ids -> mel_post (n_mels, T) of either TTS model in the
    voice `speaker`: predict the series on a 16-token bucket, scale the
    pitch by `amp` and the energy by `energy_scale`, then expand and
    decode on a `mel_multiple` frame bucket (`tts_dtype` of
    `compute_dtype`)."""
    device = next(model.parameters()).device
    compute_dtype = tts_dtype(model, compute_dtype)
    x_len = len(text_ids)
    x = torch.zeros((1, _bucket(x_len, 16, 16)), dtype=torch.long,
                    device=device)
    x[0, :x_len] = torch.as_tensor(list(text_ids), device=device)
    xl = torch.tensor([x_len], device=device)
    spk = torch.tensor([int(speaker)], device=device)
    series = model.predict_series(x, alpha=alpha, x_len=xl,
                                  compute_dtype=compute_dtype, speaker=spk)
    dur = series['dur'][0, :x_len].float().cpu().numpy()
    total = int(np.sum(np.floor(np.maximum(dur, 0) + 0.5)))
    max_t = _bucket(total + 1, mel_multiple, mel_multiple)
    gen = model.generate_from_series(x, series['dur'], series['pitch'] * amp,
                                     series['energy'] * energy_scale, max_t,
                                     x_len=xl, compute_dtype=compute_dtype,
                                     speaker=spk)
    mel_len = int(gen['mel_len'][0])
    return gen['mel_post'][0, :mel_len].T.float().cpu().numpy()


def synthesize_text(model: torch.nn.Module, text: str,
                    config: Dict[str, Any], alpha: float = 1.0,
                    amp: float = 1.0, split: bool = False,
                    speaker: int = 0) -> np.ndarray:
    """Text -> mel (n_mels, T) in the voice `speaker`. With `split`, each
    sentence is synthesized
    alone and the mels are joined with SENTENCE_GAP_FRAMES of MEL_PAD (a
    silence for every vocoder)."""
    pieces = (split_sentences(text) or [text]) if split else [text]
    gap = np.full((config['dsp']['num_mels'], SENTENCE_GAP_FRAMES), MEL_PAD,
                  np.float32)
    mels = []
    for sentence in pieces:
        if mels:
            mels.append(gap)
        mels.append(synthesize(model, text_to_ids(sentence, config), alpha,
                               amp, speaker=speaker))
    return np.concatenate(mels, axis=1)


def add_vocoder_subcommands(parser: argparse.ArgumentParser
                            ) -> argparse.ArgumentParser:
    """The four vocoder subcommands with the options that `load_vocoder`
    and `write_output` read; returns `wavernn`'s parser."""
    subparsers = parser.add_subparsers(dest='vocoder')
    wr = subparsers.add_parser('wavernn')
    wr.add_argument('--overlap', '-o', default=OVERLAP, type=int)
    wr.add_argument('--target', '-t', default=None, type=int,
                    help='fold length in samples (default: 2750 for the '
                         'sampling kernel on the card, 11000 for the '
                         'plain sampler on the CPU)')
    wr.add_argument('--voc_checkpoint', type=str, default=None)
    subparsers.add_parser('griffinlim')
    mg = subparsers.add_parser('melgan')
    mg.add_argument('--voc_checkpoint', type=str, default=None,
                    help='MelGAN generator (hub-lineage torch file); '
                         'without it the mels are exported as .mel')
    hg = subparsers.add_parser('hifigan')
    hg.add_argument('--voc_checkpoint', type=str, default=None,
                    help='HiFi-GAN generator (official torch file or '
                         '.fjax); without it the mels are exported as .npy')
    hg.add_argument('--voc_config', type=str, default=None,
                    help='HiFi-GAN config.json (default: the one beside '
                         'the checkpoint, else V1)')
    return wr


def read_texts(args: argparse.Namespace) -> List[str]:
    """`--input_text`, else every non-empty line of sentences.txt."""
    if args.input_text:
        return [args.input_text]
    with open('sentences.txt', encoding='utf-8') as f:
        return [line for line in f.read().splitlines() if line.strip()]


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='TTS Generator (PyTorch)')
    parser.add_argument('--input_text', '-i', default=None, type=str,
                        help='text to speak (default: every line of '
                             'sentences.txt)')
    parser.add_argument('--checkpoint', type=str, default=None,
                        help='ForwardTacotron or FastPitch .pt (this '
                             'package) or .fjax file (default: random '
                             'weights from --seed)')
    parser.add_argument('--config', metavar='FILE', default=None,
                        help='YAML config used without a checkpoint '
                             '(needs pyyaml; default: built-in config)')
    parser.add_argument('--alpha', type=float, default=1.0,
                        help='length regulator speed control')
    parser.add_argument('--amp', type=float, default=1.0,
                        help='pitch amplification')
    parser.add_argument('--speaker', type=int, default=0,
                        help='speaker id of a multi-speaker model, in '
                             '[0, n_speakers)')
    parser.add_argument('--split_sentences', action='store_true',
                        help='synthesize each sentence alone and join the '
                             'mels with short silences')
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--seed', type=int, default=0,
                        help='seed of random weights and of sampling')
    wr = add_vocoder_subcommands(parser)
    wr.add_argument('--stream', action='store_true',
                    help='write audio as fold groups complete')
    wr.add_argument('--stream_group', default=8, type=int,
                    help='fold lanes sampled per streamed chunk')
    wr.add_argument('--batched_utterances', action='store_true',
                    help='vocode every utterance in one batch at the end')
    return parser


def main(argv: Optional[Sequence[str]] = None) -> List[Path]:
    parser = _parser()
    args = parser.parse_args(argv)
    if args.vocoder not in VOCODERS:
        parser.error(f'please choose a vocoder: {", ".join(VOCODERS)}')
    if args.alpha <= 0:
        parser.error('--alpha must be > 0')

    config = read_config(args.config) if args.config else default_config()
    model, config, step = load_tts(args.checkpoint, config, args.device,
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
    wavernn = args.vocoder == 'wavernn'
    written, pending = [], []
    for i, text in enumerate(texts, 1):
        t0 = time.perf_counter()
        name = (f'{i}_forward_{tts_k}k_alpha{args.alpha}_amp{args.amp}_'
                f'{args.vocoder}')
        mel = synthesize_text(model, text, config, args.alpha, args.amp,
                              args.split_sentences, args.speaker)
        if wavernn and args.stream:
            path = out_dir / f'{name}.wav'
            n = write_wav_streaming(stream_wav(
                voc_model, mel, target=args.target, overlap=args.overlap,
                group=args.stream_group, mu_law=mu_law, seed=args.seed),
                path, dsp.sample_rate)
            print(f'| streamed {n} samples')
        elif wavernn and args.batched_utterances:
            pending.append((out_dir / f'{name}.wav', mel))
            continue
        else:
            path = write_output(args, mel, out_dir, name, dsp, voc_model,
                                mu_law)
        written.append(path)
        print(f'| {i}/{len(texts)} {path} ({mel.shape[1]} frames, '
              f'{time.perf_counter() - t0:.2f} s)')
    if pending:
        t0 = time.perf_counter()
        wavs = vocode_batch(voc_model, [m for _, m in pending],
                            target=args.target, overlap=args.overlap,
                            mu_law=mu_law, seed=args.seed, pcm16=True)
        for (path, _), wav in zip(pending, wavs):
            dsp.save_wav(wav, path)
            written.append(path)
        print(f'| vocoded {len(pending)} utterances in one batch '
              f'({time.perf_counter() - t0:.2f} s)')
    return written


if __name__ == '__main__':
    main()
