"""Dynamic-batching TTS server and its HTTP front.

Mirrors the staged path of `forwardtacotron_tpu/serving.py`. `TTSServer`
owns the models and one batcher thread, which makes every call on the
device: requests submitted concurrently are collected for up to
`max_wait_ms` (or until `max_batch`), padded to a power-of-two batch, a
`text_bucket` token bucket and a `mel_bucket` frame bucket, and run
through one series pass and one decode for the whole group (kernel #1 at
batch 1, 2, 4 or 8), then vocoded together: WaveRNN through one
`vocode_batch` (every utterance's fold lanes in sampler launches of up to
128 lanes), HiFi-GAN / MelGAN one utterance at a time, or Griffin-Lim.
Per-request `alpha` / `pitch_scale` / `energy_scale` are applied on the
host to the shared series pass (alpha divides the durations, as the
model's own argument does), and a multi-speaker model takes each row's
`speaker` (the pad rows speaker 0), so heterogeneous requests, voices
included, batch together. Request threads only wait on futures of numpy
arrays.

`fused=True` (a neural vocoder only) runs tokens -> int16 PCM as one
function a batch, as the JAX package's one `jit` does: the series, the
knobs applied on the device, the decode to `fused_max_t` frames and the
vocoder (`utils/export.py:PcmVocoder`, the exported program's tail). On
the card each (text bucket, batch, fused_max_t) is captured once into a
CUDA graph over static input buffers (all graphs share one memory pool,
`capture_error_mode='thread_local'`), so a batch is a copy in, one
replay and one copy of pcm, mel_len and wav_len out; kernels #1 and #4
run inside the graph. A batch whose mel reaches `fused_max_t` frames
reruns on the staged path (JAX's rule). On the CPU the same function
runs directly.

`mesh=` (a `parallel.Mesh`) shards the staged WaveRNN vocode's
utterances over the mesh's devices (`vocode_batch(mesh=)`), as the JAX
server passes its mesh to that vocode only; the fused path and the other
vocoders ignore it.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from forwardtacotron_tpu_torch import resolve_device
from forwardtacotron_tpu_torch.config import default_config
from forwardtacotron_tpu_torch.dsp.audio import DSP
from forwardtacotron_tpu_torch.gen_forward import (VOCODERS, check_speaker,
                                                   load_tts, load_voc,
                                                   tts_dtype)
from forwardtacotron_tpu_torch.kernels.birnn import recurrence
from forwardtacotron_tpu_torch.models.forward_tacotron import PADDING_VALUE
from forwardtacotron_tpu_torch.models.hifigan import (load_gan_vocoder,
                                                      vocode_generator)
from forwardtacotron_tpu_torch.models.wavernn import vocode_batch
from forwardtacotron_tpu_torch.parallel.mesh import Mesh
from forwardtacotron_tpu_torch.text.cleaners import Cleaner
from forwardtacotron_tpu_torch.text.segmenter import split_sentences
from forwardtacotron_tpu_torch.text.tokenizer import Tokenizer
from forwardtacotron_tpu_torch.utils.export import PcmVocoder


class ServerOverloaded(RuntimeError):
    """Raised by submit() when the request queue is at max_queue; the
    HTTP front answers 503."""


@dataclass
class _Request:
    text: str
    alpha: float
    pitch_scale: float
    energy_scale: float
    speaker: int = 0
    future: Future = field(default_factory=Future)
    deadline: Optional[float] = None   # time.monotonic() cutoff
    enqueued: float = 0.0              # time.monotonic() at submit


def _bucket(n: int, multiple: int, minimum: int) -> int:
    return max(((n + multiple - 1) // multiple) * multiple, minimum)


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else 1


class TTSServer:
    """Thread-safe dynamic-batching synthesis server on `device`.

    tts_checkpoint: a `.pt` (this package) or `.fjax` of the TTS model its
    config names (ForwardTacotron or FastPitch), or None for seeded random
    weights of the model `config` names (default: the built-in config).
    `compute_dtype` is the type of ForwardTacotron's recurrences and of
    the WaveRNN sampler; FastPitch infers in float32 (`tts_dtype`), its
    padded rows masked at their lengths. vocoder: 'griffinlim' |
    'wavernn' (voc_checkpoint `.fjax`, or None for seeded random weights)
    | 'hifigan' | 'melgan' (any file `load_gan_vocoder` takes). Futures
    resolve to int16 PCM at the config's sample rate.
    """

    def __init__(self, tts_checkpoint: Optional[str],
                 vocoder: str = 'griffinlim',
                 voc_checkpoint: Optional[str] = None,
                 max_batch: int = 8, max_wait_ms: float = 20.0,
                 text_bucket: int = 16, mel_bucket: int = 256,
                 fused: bool = False, fused_max_t: int = 1024,
                 max_queue: int = 64,
                 request_timeout_s: Optional[float] = 60.0, mesh=None,
                 device='cuda', config: Optional[Dict[str, Any]] = None,
                 seed: int = 0,
                 compute_dtype: torch.dtype = torch.bfloat16) -> None:
        if mesh is not None and not isinstance(mesh, Mesh):
            raise ValueError(f'TTSServer(mesh=...) takes a '
                             f'forwardtacotron_tpu_torch.parallel.Mesh, not '
                             f'{type(mesh).__name__}')
        self.mesh = mesh
        if vocoder not in VOCODERS:
            raise ValueError(f'unknown vocoder: {vocoder}')
        if fused and vocoder not in ('hifigan', 'melgan', 'wavernn'):
            raise ValueError('fused serving needs a neural vocoder '
                             '(hifigan/melgan/wavernn)')
        self.device = resolve_device(device)
        self.model, self.config, _ = load_tts(
            tts_checkpoint, config or default_config(), self.device, seed)
        self.dsp = DSP.from_config(self.config, self.device)
        self.cleaner = Cleaner.from_config(self.config)
        self.tokenizer = Tokenizer()
        self.vocoder = vocoder
        self.compute_dtype = compute_dtype
        self.tts_dtype = tts_dtype(self.model, compute_dtype)
        self.voc_model = None
        self._voc_mu_law = False
        if vocoder == 'wavernn':
            self.voc_model, voc_config = load_voc(
                voc_checkpoint, self.config, self.device, seed)
            self._voc_mu_law = bool(voc_config['dsp']['mu_law'])
        elif vocoder in ('hifigan', 'melgan'):
            if voc_checkpoint is None:
                raise ValueError(f'vocoder {vocoder!r} needs voc_checkpoint')
            # the loaded generator's type decides how it runs, whichever
            # of the two names was asked for
            self.voc_model = load_gan_vocoder(voc_checkpoint, vocoder,
                                              device=self.device)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.text_bucket = text_bucket
        self.mel_bucket = mel_bucket
        self.sample_rate = self.dsp.sample_rate
        self.max_queue = int(max_queue)
        self.request_timeout_s = request_timeout_s
        # observability: sizes of the formed batches, and kernel #1's
        # launches by path for each padded batch size (counted on the card)
        self.batch_sizes: 'deque[int]' = deque(maxlen=4096)
        self.birnn_paths: Dict[int, Dict[str, int]] = {}
        # the WaveRNN sampler's seed of each batch
        self._seeds = torch.Generator().manual_seed(seed)
        # fused=True: one program a (text bucket, batch, fused_max_t); on
        # the card a captured CUDA graph, its capture seconds kept
        self.fused = bool(fused)
        self.fused_max_t = int(fused_max_t)
        self._fused_programs: Dict[tuple, Any] = {}
        self._fused_lock = threading.Lock()   # warmup() and the batcher
        self.capture_seconds: Dict[tuple, float] = {}
        self._graph_pool = None
        # the fused program's tail, mel -> int16 PCM (the exported
        # program's), WaveRNN in the server's compute dtype
        self._pcm = PcmVocoder(self.voc_model, self._voc_mu_law,
                               compute_dtype) if self.fused else None
        self._q: 'queue.Queue[Optional[_Request]]' = queue.Queue()
        self._closed = False
        self._stats_lock = threading.Lock()
        self._started_at = time.monotonic()
        self._counters = {'submitted': 0, 'completed': 0, 'failed': 0,
                          'shed': 0, 'expired': 0, 'batches': 0}
        self._latency_window: 'deque' = deque(maxlen=1024)
        # serializes submit()'s closed-check-then-put against close(), so
        # no request lands behind the sentinel unanswered
        self._submit_lock = threading.Lock()
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # ---------------------------------------------------------------- API

    def submit(self, text: str, alpha: float = 1.0,
               pitch_scale: float = 1.0, energy_scale: float = 1.0,
               speaker: int = 0) -> Future:
        """Enqueue a request; the Future resolves to int16 PCM. Raises
        ValueError for a speaker outside [0, n_speakers) and
        ServerOverloaded when max_queue requests wait already."""
        error = check_speaker(self.model, speaker)
        if error:
            raise ValueError(error)
        with self._submit_lock:
            if self._closed:
                raise RuntimeError('server is closed')
            if self._q.qsize() >= self.max_queue:
                self._count('shed')
                raise ServerOverloaded(
                    f'request queue full ({self.max_queue})')
            now = time.monotonic()
            deadline = None if self.request_timeout_s is None \
                else now + self.request_timeout_s
            req = _Request(text, float(alpha), float(pitch_scale),
                           float(energy_scale), int(speaker),
                           deadline=deadline, enqueued=now)
            self._count('submitted')
            self._q.put(req)
        return req.future

    def synthesize(self, text: str, alpha: float = 1.0,
                   pitch_scale: float = 1.0, energy_scale: float = 1.0,
                   timeout: Optional[float] = None,
                   speaker: int = 0) -> np.ndarray:
        return self.submit(text, alpha, pitch_scale, energy_scale,
                           speaker).result(timeout)

    def synthesize_long(self, text: str, alpha: float = 1.0,
                        pitch_scale: float = 1.0, energy_scale: float = 1.0,
                        timeout: Optional[float] = None, speaker: int = 0,
                        gap_ms: float = 120.0) -> np.ndarray:
        """Article-length synthesis: the sentences batch together and are
        joined with `gap_ms` of silence."""
        out = list(self.synthesize_stream(
            text, alpha, pitch_scale, energy_scale, timeout=timeout,
            speaker=speaker, gap_ms=gap_ms, first_sentence_solo=False))
        return np.concatenate(out) if len(out) > 1 else out[0]

    def synthesize_stream(self, text: str, alpha: float = 1.0,
                          pitch_scale: float = 1.0,
                          energy_scale: float = 1.0,
                          timeout: Optional[float] = None, speaker: int = 0,
                          gap_ms: float = 120.0,
                          first_sentence_solo: bool = True):
        """Generator of int16 PCM chunks, one per sentence in text order
        with `gap_ms` of silence between them, each as soon as it is
        synthesized. Sentences are submitted without blocking so the
        batcher can pack them; with the queue full the generator waits on
        its own oldest sentence. `first_sentence_solo` holds the rest
        back for one batching window, so that sentence 1 runs in its own
        small batch and the first audio comes at one sentence's
        latency."""
        sentences = split_sentences(text)
        if not sentences:
            raise ValueError('no synthesizable text')
        gap = np.zeros(int(self.sample_rate * gap_ms / 1000.0), np.int16)
        pending: deque = deque()
        next_i = 0
        for emitted in range(len(sentences)):
            while next_i < len(sentences):
                if first_sentence_solo and next_i == 1:
                    time.sleep(1.5 * self.max_wait_s + 0.002)
                    first_sentence_solo = False
                try:
                    pending.append(self.submit(
                        sentences[next_i], alpha, pitch_scale,
                        energy_scale, speaker))
                    next_i += 1
                except ServerOverloaded:
                    if next_i == 0:
                        raise      # the queue is full of other callers'
                    if not pending:
                        time.sleep(self.max_wait_s or 0.05)
                        continue
                    break
            pcm = pending.popleft().result(timeout)
            if emitted:
                yield gap
            yield pcm

    def close(self) -> None:
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._worker.join(timeout=60)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --------------------------------------------------------- batch loop

    def _drain_closed(self) -> None:
        """Fail the requests still queued behind the close sentinel."""
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                return
            if req is not None:
                req.future.set_exception(RuntimeError('server closed'))

    def _loop(self) -> None:
        while True:
            req = self._q.get()
            if req is None:
                self._drain_closed()
                return
            batch = [req]
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._run_batch(batch)
                    self._drain_closed()
                    return
                batch.append(nxt)
            self._run_batch(batch)

    def _run_batch(self, reqs: List[_Request]) -> None:
        now = time.monotonic()
        live = []
        for r in reqs:
            if r.deadline is not None and now > r.deadline:
                self._count('expired')
                r.future.set_exception(TimeoutError(
                    'request deadline exceeded before synthesis started'))
            else:
                live.append(r)
        # tokenize per request, so that one bad input fails alone
        valid, ids = [], []
        for r in live:
            try:
                seq = self.tokenizer(self.cleaner(r.text))
                if not seq:
                    raise ValueError(f'empty token sequence for {r.text!r}')
            except Exception as e:      # the request's own failure
                self._count('failed')
                r.future.set_exception(e)
                continue
            valid.append(r)
            ids.append(seq)
        if not valid:
            return
        self._count('batches')
        try:
            wavs = self._synthesize_batch(valid, ids)
        except Exception as e:         # the batch fails, the server runs on
            self._count('failed', len(valid))
            for r in valid:
                r.future.set_exception(e)
            return
        done = time.monotonic()
        with self._stats_lock:
            self._counters['completed'] += len(valid)
            self._latency_window.extend(done - r.enqueued for r in valid)
        for r, wav in zip(valid, wavs):
            r.future.set_result(wav)

    def _count(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self._counters[key] += n

    def stats(self) -> Dict[str, Any]:
        """Counters, queue depth, mean batch size and end-to-end latency
        percentiles over the last 1024 requests (GET /stats)."""
        with self._stats_lock:
            out: Dict[str, Any] = dict(self._counters)
            lat = list(self._latency_window)
        out['queue_depth'] = self._q.qsize()
        out['uptime_s'] = round(time.monotonic() - self._started_at, 3)
        recent = list(self.batch_sizes)[-256:]
        out['mean_batch_size'] = (round(float(np.mean(recent)), 3)
                                  if recent else None)
        out['birnn_paths'] = {str(b): dict(p)
                              for b, p in sorted(self.birnn_paths.items())}
        if lat:
            p = np.percentile(lat, [50, 95, 99])
            out['latency_s'] = {'p50': round(float(p[0]), 4),
                                'p95': round(float(p[1]), 4),
                                'p99': round(float(p[2]), 4),
                                'max': round(float(max(lat)), 4),
                                'window': len(lat)}
        else:
            out['latency_s'] = None
        return out

    # ------------------------------------------------------------ stages

    def warmup(self, batch_sizes=None, text_lens=None, mel_caps=None,
               vocoder: bool = True) -> Dict[str, Any]:
        """Run each (batch, text bucket, mel bucket) once on dummy inputs
        before serving: the first call of a shape builds the kernels and
        fills the allocator's and cuDNN's caches (there is no program to
        compile). Defaults: batch 1 and the pow-2 max batch, one text
        bucket, one mel bucket. With `fused` each (batch, text bucket)
        program is made first (on the card captured into its CUDA graph),
        then the staged series and decode, for the overflow fallback; the
        staged vocoder is not run. Returns {'programs': shapes run,
        'seconds': wall}."""
        t0 = time.monotonic()
        if batch_sizes is None:
            batch_sizes = sorted({1, _pow2(self.max_batch)})
        text_lens = text_lens or (self.text_bucket,)
        mel_caps = mel_caps or (self.mel_bucket,)
        n_mels = int(self.config['dsp']['num_mels'])
        runs = 0
        with torch.no_grad():
            for B in batch_sizes:
                for tl in text_lens:
                    before = dict(recurrence.path_launches)
                    tx = _bucket(int(tl), self.text_bucket, self.text_bucket)
                    x = torch.ones((B, tx), dtype=torch.long,
                                   device=self.device)
                    xl = torch.full((B,), min(int(tl), tx),
                                    device=self.device)
                    spk = self._speakers(None, B)
                    if self.fused:
                        self._fused_program(tx, B, self.fused_max_t)
                        runs += 1
                    series = self._series(x, xl, spk)
                    for mt in mel_caps:
                        max_t = _bucket(int(mt), self.mel_bucket,
                                        self.mel_bucket)
                        self._decode(x, xl, series['dur'], series['pitch'],
                                     series['energy'], max_t, spk)
                        runs += 1
                    self._record_paths(B, before)
                if vocoder and not self.fused:
                    for mt in mel_caps:
                        max_t = _bucket(int(mt), self.mel_bucket,
                                        self.mel_bucket)
                        self._vocode([np.full((n_mels, max_t), PADDING_VALUE,
                                              np.float32)] * B)
                        runs += 1
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        return {'programs': runs, 'seconds': time.monotonic() - t0}

    def _speakers(self, reqs: Optional[List[_Request]], B: int
                  ) -> torch.Tensor:
        """(B,) speaker ids on the device, the rows past the requests (the
        power-of-two pad) speaker 0; a single-speaker model ignores
        them."""
        spk = np.zeros((B,), np.int64)
        if reqs is not None:
            spk[:len(reqs)] = [r.speaker for r in reqs]
        return torch.as_tensor(spk, device=self.device)

    def _series(self, x: torch.Tensor, xl: torch.Tensor,
                speaker: Optional[torch.Tensor] = None):
        return self.model.predict_series(x, x_len=xl,
                                         compute_dtype=self.tts_dtype,
                                         speaker=speaker)

    def _decode(self, x, xl, dur, pitch, energy, max_t: int,
                speaker: Optional[torch.Tensor] = None):
        return self.model.generate_from_series(
            x, torch.as_tensor(dur, device=self.device),
            torch.as_tensor(pitch, device=self.device),
            torch.as_tensor(energy, device=self.device), max_t, x_len=xl,
            compute_dtype=self.tts_dtype, speaker=speaker)

    def _record_paths(self, B: int, before: Dict[str, int]) -> None:
        """Kernel #1's launches by path since `before`, for batch B."""
        counted = {p: n - before[p]
                   for p, n in recurrence.path_launches.items()
                   if n > before[p]}
        if counted:
            self.birnn_paths[B] = counted

    @staticmethod
    def _padded_batch(reqs: List[_Request], ids: List[List[int]],
                      text_bucket: int):
        """(x (B, tx), x_lens (B,), scale (3, B): alpha, pitch_scale,
        energy_scale) of a group, padded to the power-of-two batch B (a
        few batch shapes serve every group size; pad rows 1 token long,
        knobs 1)."""
        B_real = len(ids)
        B = _pow2(B_real)
        x_lens = np.ones((B,), np.int64)
        x_lens[:B_real] = [len(i) for i in ids]
        tx = _bucket(int(x_lens.max()), text_bucket, text_bucket)
        x = np.zeros((B, tx), np.int64)
        for i, seq in enumerate(ids):
            x[i, :len(seq)] = seq
        scale = np.ones((3, B), np.float32)
        scale[:, :B_real] = [[r.alpha for r in reqs],
                             [r.pitch_scale for r in reqs],
                             [r.energy_scale for r in reqs]]
        return x, x_lens, scale

    @torch.no_grad()
    def _synthesize_batch(self, reqs: List[_Request],
                          ids: List[List[int]]) -> List[np.ndarray]:
        if self.fused:
            out = self._synthesize_batch_fused(reqs, ids)
            if out is not None:
                return out
        self.batch_sizes.append(len(reqs))
        B_real = len(ids)
        x, x_lens, scale = self._padded_batch(reqs, ids, self.text_bucket)
        B = len(x_lens)
        x = torch.as_tensor(x, device=self.device)
        xl = torch.as_tensor(x_lens, device=self.device)
        spk = self._speakers(reqs, B)
        before = dict(recurrence.path_launches)
        series = {k: v.float().cpu().numpy()
                  for k, v in self._series(x, xl, spk).items()}
        # per-request controls on the shared series pass
        dur = series['dur'] / scale[0][:, None]
        pitch = series['pitch'] * scale[1][:, None]
        energy = series['energy'] * scale[2][:, None]
        rounded = np.floor(np.maximum(dur, 0.0) + 0.5)
        total = max(int(rounded[i, :x_lens[i]].sum()) for i in range(B))
        max_t = _bucket(total + 1, self.mel_bucket, self.mel_bucket)
        gen = self._decode(x, xl, dur, pitch, energy, max_t, spk)
        self._record_paths(B, before)
        mel_lens = gen['mel_len'].cpu().numpy()
        mels = gen['mel_post'].float().cpu().numpy()   # (B, max_t, n_mels)
        return self._vocode([mels[i, :int(mel_lens[i])].T
                             for i in range(B_real)])

    # ------------------------------------------------------------ fused

    def _fused_forward(self, x, xl, alpha, pitch_scale, energy_scale, spk,
                       seed, max_t: int):
        """Tokens -> int16 PCM on the device, with no host copy in
        between (JAX `_fused_program`'s function): (pcm (B, total),
        mel_len (B,), wav_len (B,), mel_post (B, max_t, n_mels) float32;
        the mel stays on the device)."""
        series = self._series(x, xl, spk)
        gen = self.model.generate_from_series(
            x, series['dur'] / alpha[:, None],
            series['pitch'] * pitch_scale[:, None],
            series['energy'] * energy_scale[:, None], max_t, x_len=xl,
            compute_dtype=self.tts_dtype, speaker=spk)
        mel = gen['mel_post'].float()
        pcm, wav_len = self._pcm(mel, gen['mel_len'], seed)
        return pcm, gen['mel_len'], wav_len, mel

    def _fused_inputs(self, tx: int, B: int) -> List[torch.Tensor]:
        """Input buffers of a fused program: x, x_len, alpha,
        pitch_scale, energy_scale, speaker, seed."""
        dev = self.device
        return [torch.ones((B, tx), dtype=torch.long, device=dev),
                torch.full((B,), tx, dtype=torch.long, device=dev),
                *(torch.ones((B,), device=dev) for _ in range(3)),
                torch.zeros((B,), dtype=torch.long, device=dev),
                torch.zeros((), dtype=torch.long, device=dev)]

    @torch.no_grad()
    def _fused_program(self, tx: int, B: int, max_t: int):
        """The program of (tx, B, max_t): a function of the seven inputs
        (host arrays) -> [pcm, mel_len, wav_len] as numpy. On the card its
        graph is captured at first use, after one eager run on a side
        stream (kernel builds, library handles, the kernels' plan caches);
        a failed capture raises. The card's program keeps the graph, its
        input buffers and its outputs (the mel among them) as `graph`,
        `inputs` and `outputs`."""
        key = (tx, B, max_t)
        with self._fused_lock:
            program = self._fused_programs.get(key)
            if program is None:
                program = self._make_fused_program(tx, B, max_t)
                self._fused_programs[key] = program
        return program

    def _make_fused_program(self, tx: int, B: int, max_t: int):
        if self.device.type != 'cuda':
            def program(*inputs):
                outs = self._fused_forward(
                    *(torch.as_tensor(v) for v in inputs), max_t)
                return [o.numpy() for o in outs[:3]]
            return program
        dev = self.device
        static = self._fused_inputs(tx, B)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._fused_forward(*static, max_t)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # thread_local: only this thread's calls are checked during the
        # capture, so request threads and other servers on the card may
        # go on using it meanwhile
        with torch.cuda.graph(graph, pool=self._graph_pool,
                              capture_error_mode='thread_local'):
            outs = self._fused_forward(*static, max_t)
        torch.cuda.synchronize(dev)
        self.capture_seconds[(tx, B, max_t)] = time.perf_counter() - t0

        def program(*inputs):
            for buf, value in zip(static, inputs):
                buf.copy_(torch.as_tensor(value))
            graph.replay()
            host = [o.to('cpu', non_blocking=True) for o in outs[:3]]
            torch.cuda.current_stream(dev).synchronize()
            return [h.numpy() for h in host]
        program.graph, program.inputs, program.outputs = graph, static, outs
        return program

    def _synthesize_batch_fused(self, reqs: List[_Request],
                                ids: List[List[int]]
                                ) -> Optional[List[np.ndarray]]:
        """One fused program for the whole group. None when a mel
        reaches `fused_max_t` frames (the caller then reruns the group on
        the staged path)."""
        B_real = len(ids)
        x, x_lens, scale = self._padded_batch(reqs, ids, self.text_bucket)
        B, tx = x.shape
        spk = np.zeros((B,), np.int64)
        spk[:B_real] = [r.speaker for r in reqs]
        seed = np.asarray(int(torch.randint(2 ** 31 - 1, (),
                                            generator=self._seeds)))
        run = self._fused_program(tx, B, self.fused_max_t)
        pcm, mel_lens, wav_lens = run(x, x_lens, scale[0], scale[1],
                                      scale[2], spk, seed)
        if int(mel_lens[:B_real].max()) >= self.fused_max_t:
            return None                      # overflow: staged fallback
        self.batch_sizes.append(B_real)
        return [pcm[i, :int(wav_lens[i])] for i in range(B_real)]

    def _vocode(self, mels: List[np.ndarray]) -> List[np.ndarray]:
        if self.vocoder == 'wavernn':
            # the batch pow-2 padded too, so a few lane counts serve all
            n_real = len(mels)
            padded = mels + [mels[-1]] * (_pow2(n_real) - n_real)
            seed = int(torch.randint(2 ** 31 - 1, (), generator=self._seeds))
            wavs = vocode_batch(self.voc_model, padded,
                                mu_law=self._voc_mu_law, seed=seed,
                                pcm16=True,
                                compute_dtype=self.compute_dtype,
                                mesh=self.mesh)
            return wavs[:n_real]
        if self.vocoder in ('hifigan', 'melgan'):
            return [vocode_generator(self.voc_model, m, pcm16=True)
                    for m in mels]
        return [(np.clip(self.dsp.griffinlim(m), -1.0, 1.0)
                 * 32767.0).astype(np.int16) for m in mels]


def wav_bytes(pcm16: np.ndarray, sample_rate: int) -> bytes:
    """int16 PCM -> a complete RIFF/WAV file in memory."""
    import io
    import wave
    buf = io.BytesIO()
    with wave.open(buf, 'wb') as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(np.ascontiguousarray(pcm16, np.int16).tobytes())
    return buf.getvalue()


def wav_stream_header(sample_rate: int) -> bytes:
    """RIFF/WAV header of a live stream of unknown length: the RIFF and
    data sizes are 0xFFFFFFFF, which players read as 'until the
    connection closes'."""
    import struct
    channels, bits = 1, 16
    byte_rate = sample_rate * channels * bits // 8
    return (b'RIFF' + struct.pack('<I', 0xFFFFFFFF) + b'WAVEfmt '
            + struct.pack('<IHHIIHH', 16, 1, channels, sample_rate,
                          byte_rate, channels * bits // 8, bits)
            + b'data' + struct.pack('<I', 0xFFFFFFFF))


def make_http_server(server: TTSServer, host: str = '127.0.0.1',
                     port: int = 8000):
    """Stdlib HTTP front: POST /tts {"text", "alpha", "pitch_scale" |
    "amp", "energy_scale", "speaker", "split_sentences"} -> audio/wav;
    POST /tts_stream (same payload) -> chunked audio/wav, one chunk per
    sentence as it is synthesized; GET /healthz -> 200 ok; GET /stats ->
    JSON telemetry. Concurrent connections batch in the server."""
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        # the chunked /tts_stream response needs HTTP/1.1
        protocol_version = 'HTTP/1.1'

        def log_message(self, *args):
            pass

        def do_GET(self):
            if self.path == '/healthz':
                body, ctype = b'ok', 'text/plain'
            elif self.path == '/stats':
                body = json.dumps(server.stats()).encode('utf-8')
                ctype = 'application/json'
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path not in ('/tts', '/tts_stream'):
                self.send_error(404)
                return
            try:
                n = int(self.headers.get('Content-Length', 0))
                payload = json.loads(self.rfile.read(n) or b'{}')
                text = payload['text']
                # a little past the server's own deadline, so that a
                # stuck batch cannot hold the socket forever
                timeout = None if server.request_timeout_s is None \
                    else server.request_timeout_s + 10.0
                kwargs = dict(
                    alpha=float(payload.get('alpha', 1.0)),
                    pitch_scale=float(payload.get(
                        'pitch_scale', payload.get('amp', 1.0))),
                    energy_scale=float(payload.get('energy_scale', 1.0)),
                    speaker=int(payload.get('speaker', 0)),
                    timeout=timeout)
                if self.path == '/tts_stream':
                    self._stream_tts(text, kwargs)
                    return
                synth = (server.synthesize_long
                         if payload.get('split_sentences')
                         else server.synthesize)
                body = wav_bytes(synth(text, **kwargs), server.sample_rate)
                self.send_response(200)
                self.send_header('Content-Type', 'audio/wav')
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except KeyError:
                self.send_error(400, 'missing "text"')
            except ValueError as e:
                self.send_error(400, str(e))
            except ServerOverloaded:
                self.send_response(503, 'overloaded')
                self.send_header('Retry-After', '1')
                self.send_header('Content-Length', '0')
                self.end_headers()
            except TimeoutError:
                self.send_error(504, 'request deadline exceeded')
            except Exception as e:     # the connection's boundary
                self.send_error(500, f'{type(e).__name__}: {e}')

        def _stream_tts(self, text: str, kwargs: dict) -> None:
            """The first sentence is synthesized before the status line
            goes out (so overload and bad input still map to their
            codes); then each sentence is flushed as it is ready."""
            chunks = server.synthesize_stream(text, **kwargs)
            first = next(chunks)
            self.send_response(200)
            self.send_header('Content-Type', 'audio/wav')
            self.send_header('Transfer-Encoding', 'chunked')
            self.end_headers()

            def write_chunk(b: bytes) -> None:
                self.wfile.write(f'{len(b):X}\r\n'.encode('ascii'))
                self.wfile.write(b)
                self.wfile.write(b'\r\n')
                self.wfile.flush()

            try:
                write_chunk(wav_stream_header(server.sample_rate)
                            + np.ascontiguousarray(first, np.int16).tobytes())
                for pcm in chunks:
                    write_chunk(np.ascontiguousarray(pcm, np.int16)
                                .tobytes())
                self.wfile.write(b'0\r\n\r\n')
            except Exception:        # headers are out: abort the stream
                self.close_connection = True

    return ThreadingHTTPServer((host, port), Handler)
