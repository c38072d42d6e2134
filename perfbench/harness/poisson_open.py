"""Traffic kind `poisson_open`: independent users sending texts to the
in-process `TTSServer` (staged path) in an open loop of Poisson arrivals
at the traffic's fixed rate.

Set-up draws the weights from the seed (the TTS model loaded into the
server's, the GAN generator written as an official file the server
loads), and warms every shape the run's texts will use: the series and
decode at each power-of-two batch, text bucket and mel bucket
(`TTSServer.warmup`), then a warm-up burst through `submit` whose texts
cover every vocoder length bucket. The window submits each request when
it is due; its latency runs from the due time to the moment its PCM is
in hand, and a request shed, failed or not answered within a minute of
the close is a miss at infinite latency. A traced run profiles a stretch
of the same traffic sent again after the window (the profiler started
and stopped mid-window, while the server's thread launches kernels, once
aborted the process). The inter-arrival gaps and the
text lengths are the stratified quantiles of their distributions, in an
order drawn from the seed, so every seed offers the same load.

The check samples the finished requests from the seed, the longest among
them, and runs the plain reference (FastPitch at each text's exact
length, then HiFi-GAN over the mel as served) on the token ids of its own
front end; it compares each PCM's length and its samples.
"""
from __future__ import annotations

import gc
import math
import random
import shutil
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from perfbench.harness import texts as text_gen
from perfbench.harness.common import percentile
from perfbench.harness.train_steps import load_weights, strict_float32
from perfbench.harness.weights import draw, sub_seed
from perfbench.reference import fast_pitch as ref_fp
from perfbench.reference import hifigan as ref_hifigan
from perfbench.reference.frontend import load_lexicon, token_ids
from perfbench.reference.spec import duration_head

WAIT_AFTER_CLOSE_S = 60.0


def arrival_offsets(n: int, rate: float, rng: random.Random) -> List[float]:
    """Due times (s from the window's start) of n Poisson arrivals at
    `rate`: the midpoint quantiles of the exponential gap, shuffled."""
    gaps = [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]
    rng.shuffle(gaps)
    out, t = [], 0.0
    for g in gaps:
        out.append(t)
        t += g
    return out


class _Request:
    __slots__ = ('text', 'due', 'sent', 'done', 'pcm', 'error', 'shed')

    def __init__(self, text: str, due: float) -> None:
        self.text, self.due = text, due
        self.sent = self.done = None
        self.pcm = self.error = None
        self.shed = False


class ServeCell:

    def __init__(self, cfg: Dict[str, Any], traffic: Dict[str, Any],
                 seed: int, device: str = 'cuda') -> None:
        self.cfg = cfg
        self.traffic = traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.serving = cfg['serving']
        self.tmp: Optional[Path] = None
        self.lexicon = load_lexicon()
        self.rng = random.Random(sub_seed(self.seed, 5))

    # ------------------------------------------------------------ set-up
    def setup(self, seconds: float) -> None:
        from forwardtacotron_tpu_torch.serving import TTSServer
        rate = float(self.traffic['rate_per_s'])
        n = max(int(round(rate * seconds)), 1)
        self.requests = [
            _Request(t, d) for t, d in zip(
                text_gen.texts(n, self.traffic, sub_seed(self.seed, 6)),
                arrival_offsets(n, rate, self.rng))]
        self.tmp = Path(tempfile.mkdtemp(prefix='perfbench_serve_',
                                         dir=tempfile.gettempdir()))
        gen_file = ref_hifigan.weight_norm_file(
            self.gan_weights(), self._gan_config(), self.tmp / 'hifigan')
        s = self.serving
        self.server = TTSServer(
            None, vocoder=s['vocoder'], voc_checkpoint=str(gen_file),
            max_batch=s['max_batch'], max_wait_ms=s['max_wait_ms'],
            text_bucket=s['text_bucket'], mel_bucket=s['mel_bucket'],
            max_queue=s['max_queue'], device=self.device, config=self.cfg,
            seed=self.seed % (2 ** 31))
        load_weights(self.server.model, self.tts_weights())
        self._warm()

    def _gan_config(self) -> Dict[str, Any]:
        keys = ('resblock', 'upsample_rates', 'upsample_kernel_sizes',
                'upsample_initial_channel', 'resblock_kernel_sizes',
                'resblock_dilation_sizes')
        return {k: self.cfg['hifigan']['model'][k] for k in keys}

    def tts_weights(self) -> Dict[str, torch.Tensor]:
        a = self.cfg['assumed']
        entries = duration_head(ref_fp.weight_spec(self.cfg), 'dur_pred.lin',
                                a['duration_frames'], a['duration_head_gain'])
        return draw(entries, self.seed, self.device)

    def gan_weights(self) -> Dict[str, torch.Tensor]:
        return draw(ref_hifigan.weight_spec(self._gan_config(),
                                            self.cfg['dsp']['num_mels']),
                    sub_seed(self.seed, 4), self.device)

    def _warm(self) -> None:
        """The series and decode at every batch, text bucket and mel bucket
        the run's texts reach, then one request of each vocoder length
        bucket through `submit`."""
        s = self.serving
        frames = int(self.cfg['assumed']['duration_frames'])
        tokens = [len(token_ids(r.text, self.lexicon)) for r in self.requests]
        tb, mb = s['text_bucket'], s['mel_bucket']
        text_lens = sorted({-(-t // tb) * tb for t in tokens})
        longest = max(tokens) * frames + 1
        mel_caps = [mb * k for k in range(1, -(-longest // mb) + 1)]
        batches = [1 << i for i in range(int(math.log2(s['max_batch'])) + 1)]
        self.server.warmup(batch_sizes=batches, text_lens=text_lens,
                           mel_caps=mel_caps, vocoder=False)
        fb = int(s['vocoder_frame_bucket'])
        by_bucket: Dict[int, str] = {}
        for r, t in zip(self.requests, tokens):
            by_bucket.setdefault(-(-t * frames // fb), r.text)
        for fut in [self.server.submit(t) for t in by_bucket.values()]:
            fut.result(timeout=600)
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ window
    def _drive(self, requests: List[_Request], deadline_after: float
               ) -> float:
        """Submit each request when it is due and wait for the answers, a
        minute past the last due time at most; returns the start."""
        from forwardtacotron_tpu_torch.serving import ServerOverloaded
        lock = threading.Lock()

        def finish(req):
            def cb(fut):
                now = time.perf_counter()
                with lock:
                    req.done = now
                    if fut.exception() is None:
                        req.pcm = fut.result()
                    else:
                        req.error = repr(fut.exception())
            return cb

        t0 = time.perf_counter()
        futures = []
        for req in requests:
            wait = t0 + req.due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            req.sent = time.perf_counter()
            try:
                with torch.profiler.record_function('perfbench.submit'):
                    fut = self.server.submit(req.text)
            except ServerOverloaded:
                req.shed = True
                continue
            fut.add_done_callback(finish(req))
            futures.append(fut)
        deadline = max(t0 + deadline_after, time.perf_counter()) \
            + WAIT_AFTER_CLOSE_S
        for fut in futures:
            try:
                fut.exception(timeout=max(deadline - time.perf_counter(), 0))
            except Exception:           # not answered by the deadline
                pass
        return t0

    def window(self, seconds: float) -> Dict[str, Any]:
        self.batches_before = len(self.server.batch_sizes)
        t0 = self._drive(self.requests, seconds)
        self.batch_sizes = list(self.server.batch_sizes)[self.batches_before:]
        lat = [r.done - (t0 + r.due) if r.pcm is not None else math.inf
               for r in self.requests]
        self.latencies = lat
        late = sorted(r.sent - (t0 + r.due) for r in self.requests)
        self.lateness = {'median_s': late[len(late) // 2], 'max_s': late[-1]}
        return {'serve_p95_s': percentile(lat, 95.0)}

    def trace_stretch(self, fraction: float = 1 / 6) -> Dict[str, Any]:
        """After the window, its first `fraction` of requests sent again
        at the same due times with the card's activity profiled; the
        profiler starts and stops while the server is idle."""
        from perfbench.harness.trace import Slice
        n = max(int(len(self.requests) * fraction), 1)
        again = [_Request(r.text, r.due) for r in self.requests[:n]]
        s = Slice()
        s.start()
        self._drive(again, again[-1].due)
        s.stop()
        return s.summary()

    def context(self) -> Dict[str, Any]:
        return {'batch_sizes': self.batch_sizes,
                'max_batch': self.serving['max_batch'],
                'queue_depth': self.server.stats()['queue_depth']}

    def notes(self) -> List[str]:
        finite = sorted(x for x in self.latencies if x != math.inf)
        med = finite[len(finite) // 2] if finite else math.inf
        errors = [r.error for r in self.requests if r.error is not None]
        return [f'serve: {len(self.latencies)} requests due, '
                f'{len(finite)} answered in time, median latency '
                f'{med!r} s, p95 {percentile(self.latencies, 95.0)!r} s, '
                f'generator late by median {self.lateness["median_s"]!r} s, '
                f'at most {self.lateness["max_s"]!r} s, '
                f'{sum(r.shed for r in self.requests)} shed, '
                f'{len(errors)} failed' + (f' (first: {errors[0]})'
                                           if errors else '')]

    def counts(self) -> Dict[str, int]:
        misses = sum(1 for x in self.latencies if x == math.inf)
        return {'attempted': len(self.requests), 'failed': misses}

    def release(self) -> None:
        self.server.close()
        del self.server
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def sample(self, k: int) -> List[_Request]:
        done = [r for r in self.requests if r.pcm is not None]
        if not done:
            return []
        longest = max(done, key=lambda r: len(r.text))
        rest = [r for r in done if r is not longest]
        rng = random.Random(sub_seed(self.seed, 7))
        return [longest] + rng.sample(rest, min(k - 1, len(rest)))

    def unanswered(self) -> int:
        """Requests that were sent and got no answer: an error, or none by a
        minute past the close."""
        return sum(1 for r in self.requests
                   if not r.shed and r.pcm is None)

    def reference_pcm(self, reqs: List[_Request], dt=torch.float32
                      ) -> List[np.ndarray]:
        P = self.tts_weights()
        W = ref_hifigan.read_weights(self.tmp / 'hifigan' / 'generator.pt',
                                     self.device)
        out = []
        with strict_float32():
            for r in reqs:
                ids = torch.tensor(token_ids(r.text, self.lexicon),
                                   device=self.device)
                mel = ref_fp.infer(P, ids, self.cfg, dt)
                out.append(ref_hifigan.vocode(
                    W, self._gan_config(), mel,
                    int(self.serving['vocoder_frame_bucket']), dt))
        return out

    @staticmethod
    def compare(got: List[np.ndarray], ref: List[np.ndarray]
                ) -> Dict[str, float]:
        mismatch, rel, peak = 0, 0.0, 0.0
        for g, r in zip(got, ref):
            if len(g) != len(r):
                mismatch += 1
                continue
            d = g.astype(np.float64) - r.astype(np.float64)
            rel = max(rel, float(np.linalg.norm(d)
                                 / max(np.linalg.norm(r.astype(np.float64)),
                                       1.0)))
            peak = max(peak, float(np.abs(d).max()) / 32767.0)
        return {'length_mismatch': float(mismatch), 'pcm_rel_l2': rel,
                'pcm_max_abs': peak}

    def cleanup(self) -> None:
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)


def run(cfg, traffic, workload, args, t_start, device='cuda'
        ) -> Dict[str, Any]:
    """One run of a `poisson_open` cell: set-up, the window, the card's
    readings, then the check against the reference."""
    from perfbench.harness.common import device_block
    cell = ServeCell(cfg, traffic, args.seed, device)
    try:
        cell.setup(args.seconds)
        setup_s = time.perf_counter() - t_start
        e2e = cell.window(args.seconds)
        e2e['setup_s'] = setup_s
        ctx = cell.context()
        ctx['trace'] = cell.trace_stretch() if args.trace else None
        dev = device_block(1, ctx['trace']) if device == 'cuda' else None
        cell.release()
        sample = cell.sample(int(workload['check_requests']))
        got = [r.pcm for r in sample]
        numbers = cell.compare(got, cell.reference_pcm(sample))
        numbers['unanswered'] = float(cell.unanswered())
        return {'e2e': e2e, 'ctx': ctx, 'device': dev, 'check': numbers,
                'notes': cell.notes() + [f'serve: compared {len(sample)} '
                                         'requests with the reference'],
                **cell.counts()}
    finally:
        cell.cleanup()
