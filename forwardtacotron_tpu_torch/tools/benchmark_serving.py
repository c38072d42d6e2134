"""Serving load benchmark: drive the port's `TTSServer` with N concurrent
client threads x M requests each and report latency percentiles,
throughput and realized batch sizes as ONE JSON line (the JAX package's
`tools/benchmark_serving.py` on the port, the same texts and keys).

    python -m forwardtacotron_tpu_torch.tools.benchmark_serving \\
        --checkpoint checkpoints/ljspeech_tts.forward/latest_model.pt \\
        --vocoder hifigan --voc_checkpoint g_00000000 --clients 8 \\
        --requests 4 [--fused] [--device cuda]

Without `--checkpoint` the server holds seeded random weights at the
built-in config's widths. The warmup (`TTSServer.warmup`, skipped with
`--no-warmup`) runs every power-of-two batch up to `--max_batch` at the
token buckets of the texts, so that on the card the timed window meets no
first call of a shape (with `--fused`, no graph capture). One key beyond
JAX's: `kernel_launches`, null unless `--count-launches` is given; then
the launches of kernel #1 (by path) and #4 in the timed window, counted
by kernel name in a `torch.profiler` trace of the card's activity
(`utils/profiling.kernel_launches`, which also sees the launches inside a
fused server's CUDA graph replays); all 0 on the CPU, where the kernels'
plain versions run. The profiler costs the window 8-15% of its
requests/s on an H100, which is why it is off by default.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import threading
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

TEXTS = [
    'The quick brown fox jumps over the lazy dog.',
    'A TPU systolic array multiplies matrices in hardware.',
    'Speech synthesis turns text into audible waveforms.',
    'Dynamic batching shares device programs across requests.',
    'Latency percentiles summarize the user experience.',
    'Sentence splitting bounds per dispatch work.',
]
LAUNCH_KEYS = ('birnn_stream_local', 'birnn_cooperative', 'wavernn_sample')


@contextlib.contextmanager
def _counting_launches(device: torch.device, counts: Dict[str, int]):
    """Fill `counts` with the launches of LAUNCH_KEYS on the card during
    the block (zeros off the card)."""
    counts.update(dict.fromkeys(LAUNCH_KEYS, 0))
    if device.type != 'cuda':
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    from forwardtacotron_tpu_torch.utils.profiling import kernel_launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield
        torch.cuda.synchronize(device)
    launched = kernel_launches(prof)
    counts.update({k: launched[k] for k in LAUNCH_KEYS})


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='Concurrent-load benchmark for the TTS server')
    parser.add_argument('--checkpoint', default=None,
                        help='TTS .pt / .dcp / .fjax (default: seeded '
                             'random weights)')
    parser.add_argument('--vocoder', default='griffinlim',
                        choices=['griffinlim', 'wavernn', 'hifigan',
                                 'melgan'])
    parser.add_argument('--voc_checkpoint', default=None)
    parser.add_argument('--clients', type=int, default=8)
    parser.add_argument('--requests', type=int, default=4,
                        help='requests per client')
    parser.add_argument('--max_batch', type=int, default=8)
    parser.add_argument('--max_wait_ms', type=float, default=20.0)
    parser.add_argument('--fused', action='store_true')
    parser.add_argument('--no-warmup', dest='warmup',
                        action='store_false')
    parser.add_argument('--count-launches', action='store_true',
                        help='count the kernels\' launches in the window '
                             'with a profiler, which slows it')
    parser.add_argument('--device', default='cuda')
    return parser


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = _parser().parse_args(argv)

    from forwardtacotron_tpu_torch import resolve_device
    from forwardtacotron_tpu_torch.serving import TTSServer

    device = resolve_device(args.device)
    server = TTSServer(args.checkpoint, vocoder=args.vocoder,
                       voc_checkpoint=args.voc_checkpoint,
                       max_batch=args.max_batch,
                       max_wait_ms=args.max_wait_ms, fused=args.fused,
                       device=device)
    with server:
        if args.warmup:
            t0 = time.monotonic()
            batches = [1 << i for i in range(
                (args.max_batch - 1).bit_length() + 1)]
            lengths = sorted({len(server.tokenizer(server.cleaner(t)))
                              for t in TEXTS})
            info = server.warmup(batch_sizes=batches, text_lens=lengths)
            print(f'# warmup: {info["programs"]} programs in '
                  f'{info["seconds"]:.1f}s '
                  f'({time.monotonic() - t0:.1f}s wall)')

        lat, errors = [], []
        lock = threading.Lock()

        def client(cid: int) -> None:
            for k in range(args.requests):
                text = TEXTS[(cid + k) % len(TEXTS)]
                t0 = time.monotonic()
                try:
                    pcm = server.synthesize(text, timeout=600)
                    dt = time.monotonic() - t0
                    with lock:
                        lat.append((dt, len(pcm)))
                except Exception as e:   # noqa: BLE001 - report all
                    with lock:
                        errors.append(f'{type(e).__name__}: {e}')

        launches: Dict[str, int] = {}
        counting = _counting_launches(device, launches) \
            if args.count_launches else contextlib.nullcontext()
        with counting:
            t_start = time.monotonic()
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(args.clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.monotonic() - t_start

        times = np.array([d for d, _ in lat])
        samples = sum(n for _, n in lat)
        stats = server.stats()
        result = {
            'metric': 'serving_p95_latency',
            'value': round(float(np.percentile(times, 95)), 4)
            if len(times) else None,
            'unit': 's',
            'clients': args.clients,
            'requests_total': len(lat),
            'errors': len(errors),
            'wall_s': round(wall, 3),
            'requests_per_s': round(len(lat) / wall, 2),
            'audio_s_per_s': round(
                samples / server.sample_rate / wall, 2),
            'latency_s': {
                'p50': round(float(np.percentile(times, 50)), 4),
                'p95': round(float(np.percentile(times, 95)), 4),
                'p99': round(float(np.percentile(times, 99)), 4),
                'max': round(float(times.max()), 4),
            } if len(times) else None,
            'mean_batch_size': stats['mean_batch_size'],
            'kernel_launches': launches if args.count_launches else None,
        }
        print(json.dumps(result))
        if errors:
            for e in errors[:5]:
                print(f'# error: {e}')
    return result


if __name__ == '__main__':
    main()
