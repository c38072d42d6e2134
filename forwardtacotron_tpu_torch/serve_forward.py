"""TTS HTTP server over the dynamic-batching `TTSServer`.

    python -m forwardtacotron_tpu_torch.serve_forward \\
        [--checkpoint tts.pt|tts.fjax] [--device cuda] --port 8000 \\
        {griffinlim | wavernn [--voc_checkpoint voc.fjax]
         | hifigan --voc_checkpoint g.pt | melgan --voc_checkpoint g.pt}
    curl -X POST localhost:8000/tts -d '{"text": "hello", "alpha": 1.1}' \\
        -o out.wav

The flags are the JAX package's `serve_forward.py`'s, plus `--device`
and `--seed` (random weights where no checkpoint is given). The TTS model,
ForwardTacotron or FastPitch, is the one the checkpoint's config names.
`--fused` (a neural vocoder only) serves each batch as one program, on
the card a captured CUDA graph, with the mel axis fixed at
`--fused_max_t` frames (longer outputs rerun on the staged path).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='TTS HTTP server (PyTorch)')
    parser.add_argument('--checkpoint', type=str, default=None,
                        help='TTS checkpoint (.pt of this package or .fjax; '
                             'default: random weights from --seed)')
    parser.add_argument('--host', type=str, default='127.0.0.1')
    parser.add_argument('--port', type=int, default=8000)
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--max_batch', type=int, default=8,
                        help='dynamic batching: most requests per batch')
    parser.add_argument('--max_wait_ms', type=float, default=20.0,
                        help='dynamic batching: longest wait for more '
                             'requests')
    parser.add_argument('--fused', action='store_true',
                        help='neural vocoders: text -> PCM as ONE program '
                             'per batch, a captured CUDA graph on the card '
                             '(falls back to the staged path when an '
                             'output exceeds --fused_max_t frames)')
    parser.add_argument('--fused_max_t', type=int, default=1024)
    parser.add_argument('--max_queue', type=int, default=64,
                        help='queued requests beyond this get HTTP 503')
    parser.add_argument('--request_timeout', type=float, default=60.0,
                        help='per-request deadline in seconds (504 when '
                             'exceeded); <=0 disables')
    parser.add_argument('--warmup_text_buckets', type=int, default=1,
                        help='text buckets run once before serving')
    parser.add_argument('--warmup_mel_buckets', type=int, default=1,
                        help='mel buckets run once before serving')
    subparsers = parser.add_subparsers(dest='vocoder')
    subparsers.add_parser('griffinlim')
    wr = subparsers.add_parser('wavernn')
    wr.add_argument('--voc_checkpoint', type=str, default=None)
    for name in ('hifigan', 'melgan'):
        sub = subparsers.add_parser(name)
        sub.add_argument('--voc_checkpoint', type=str, required=True)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = _parser()
    args = parser.parse_args(argv)
    from forwardtacotron_tpu_torch.serving import TTSServer, make_http_server
    vocoder = args.vocoder or 'griffinlim'
    server = TTSServer(
        args.checkpoint, vocoder=vocoder,
        voc_checkpoint=getattr(args, 'voc_checkpoint', None),
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        fused=args.fused, fused_max_t=args.fused_max_t,
        max_queue=args.max_queue,
        request_timeout_s=(args.request_timeout
                           if args.request_timeout > 0 else None),
        device=args.device, seed=args.seed)
    print('Warming up...')
    stats = server.warmup(
        text_lens=[server.text_bucket * (i + 1)
                   for i in range(max(args.warmup_text_buckets, 1))],
        mel_caps=[server.mel_bucket * (i + 1)
                  for i in range(max(args.warmup_mel_buckets, 1))])
    print(f'Ran {stats["programs"]} warm-up shapes in '
          f'{stats["seconds"]:.1f}s')
    httpd = make_http_server(server, args.host, args.port)
    print(f'Serving TTS ({vocoder}) on http://{args.host}:{args.port} '
          '- POST /tts {"text": ...}')
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.close()


if __name__ == '__main__':
    main()
