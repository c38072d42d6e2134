"""Export a ForwardTacotron / FastPitch to a self-contained artifact (the
JAX package's `export_forward.py`, which writes StableHLO):

    python -m forwardtacotron_tpu_torch.export_forward \\
        [--checkpoint tts.pt|tts.fjax] --output forward.ftpt \\
        --buckets 64:512,192:1536 [--device cuda|cpu] \\
        [--voc_checkpoint voc [--voc_type auto|hifigan|melgan|wavernn]]

Each bucket is a `torch.export` program with the weights baked in
(`utils/export.py`); it runs without the model classes, kernels #1 and #4
as the ops `ftt::birnn_recurrence` / `ftt::wavernn_sample` on the card
and their plain versions on the CPU:

    from forwardtacotron_tpu_torch.utils.export import ExportedTTS
    mel, dur = ExportedTTS('forward.ftpt').generate(token_ids)

With a vocoder (a HiFi-GAN / MelGAN generator file, or WaveRNN) every
bucket is a full text -> int16 PCM program (`ExportedTTS.synthesize`;
WaveRNN samples with a runtime seed). The flags are the JAX CLI's, with
`--device` in place of `--platforms` (the device the artifact is
exported for, and runs on) and, as the port's other CLIs, random seeded
weights (`--seed`) where no checkpoint is given: `--voc_type wavernn`
without `--voc_checkpoint` fuses a random WaveRNN.
"""
from __future__ import annotations

import argparse
import pickle
from typing import Optional, Sequence


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='Export TTS generate() to a torch.export artifact')
    parser.add_argument('--checkpoint', type=str, default=None,
                        help='TTS checkpoint (.pt of this package or .fjax; '
                             'default: random weights from --seed)')
    parser.add_argument('--output', type=str, required=True,
                        help='output artifact path')
    parser.add_argument('--buckets', type=str, default='64:512,192:1536',
                        help='comma list of tx:max_mel static buckets')
    parser.add_argument('--device', default='cuda',
                        help='device the artifact is exported for')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--voc_checkpoint', type=str, default=None,
                        help='vocoder checkpoint (HiFi-GAN/MelGAN generator '
                             'or a WaveRNN .pt/.fjax): the vocoder is fused '
                             'into the artifact, a full text->wav program '
                             '(int16 PCM; ExportedTTS.synthesize)')
    parser.add_argument('--voc_type', type=str, default='auto',
                        choices=['auto', 'hifigan', 'melgan', 'wavernn'],
                        help='vocoder architecture of --voc_checkpoint '
                             '(auto: sniffed from the file)')
    return parser


def _sniff_wavernn(path: str) -> bool:
    """A WaveRNN checkpoint: a `.fjax` whose flat params hold `rnn1_*`, or
    a `.pt` of `train_wavernn` whose state_dict holds `rnn1.*`."""
    if path.endswith('.fjax'):
        from forwardtacotron_tpu_torch.weights import load_fjax
        params = load_fjax(path)['model'].get('params', {})
        return 'rnn1_w_ih' in params or 'rnn1_b_ih' in params
    if path.endswith('.pt'):
        from forwardtacotron_tpu_torch.utils.checkpoints import (
            load_checkpoint)
        try:
            payload = load_checkpoint(path)
        except (RuntimeError, pickle.UnpicklingError):   # not a .pt payload
            return False
        model = payload.get('model') if isinstance(payload, dict) else None
        return isinstance(model, dict) and 'rnn1.weight_ih_l0' in model
    return False


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = _parser().parse_args(argv)
    from forwardtacotron_tpu_torch import resolve_device
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.gen_forward import load_tts, load_voc
    from forwardtacotron_tpu_torch.models.hifigan import load_gan_vocoder
    from forwardtacotron_tpu_torch.utils.export import save_exported_tts

    device = resolve_device(args.device)
    buckets = []
    for part in args.buckets.split(','):
        tx, max_t = part.split(':')
        buckets.append((int(tx), int(max_t)))
    model, config, step = load_tts(args.checkpoint, default_config(), device,
                                   args.seed)
    vocoder, voc_mu_law = None, True
    if args.voc_type == 'wavernn' or (
            args.voc_checkpoint and args.voc_type == 'auto'
            and _sniff_wavernn(args.voc_checkpoint)):
        vocoder, voc_config = load_voc(args.voc_checkpoint, config, device,
                                       args.seed)
        voc_mu_law = bool(voc_config['dsp']['mu_law'])
    elif args.voc_checkpoint:
        vocoder = load_gan_vocoder(args.voc_checkpoint, args.voc_type,
                                   device=device)
    save_exported_tts(model, args.output, buckets=buckets, vocoder=vocoder,
                      voc_mu_law=voc_mu_law)
    voc_note = ' + fused vocoder' if vocoder is not None else ''
    print(f'Exported step-{step} {type(model).__name__}{voc_note} '
          f'buckets={buckets} for {device.type} -> {args.output}')


if __name__ == '__main__':
    main()
