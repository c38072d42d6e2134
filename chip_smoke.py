"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--only PHASE ...]

`--only` runs the build and the named phases (functions of this file,
e.g. `options_path`) and prints no result line: a quicker check of one
phase while it is developed. Phases (any failure makes the exit code nonzero, and the final line is
printed only when every phase passed):

1. device: CUDA must be available; prints the card's name and power
   limit from nvidia-smi;
2. build: compiles the CUDA kernels of `forwardtacotron_tpu_torch/csrc`
   with nvcc, all sources at once;
3. BiRNN kernel (#1) against its plain version on the card at the
   serving path's shapes (`SERVING_BIRNN_CASES`: decoder LSTM H=512 and
   postnet GRU H=256 at T=1024, prenet GRU H=256 and the 6-stream
   predictor GRU H=128 at T=160; B=1 and B=8, and the server's buckets
   B=2 and B=4 for the decoder and postnet in bfloat16; float32 at atol
   1e-4, bfloat16 at atol 2e-2) on the path `inference_plan` names and, at
   B=1, on the cooperative path too, with both paths' timings beside the
   plain version's, cuDNN's and the bound; and at the five shapes that
   `evaluate()` gives it on the training path (`EVAL_BIRNN_CASES`, B=32:
   decoder LSTM H=512 T=896 ragged, CBHG GRUs H=256 at T=896 and T=176,
   predictor GRUs H=128/64 T=176; float32 at atol 1e-4; the decoder on
   both paths, timed); and at the Tacotron teacher's alignment shapes
   (`TEACHER_BIRNN_CASES`, B=8 float32 at atol 1e-4: postnet GRU H=128
   T=1250 and encoder GRU H=128 T=200, ragged; timed beside cuDNN and the
   bound; and at the free-running synthesis's B=1 shapes,
   `TEACHER_GEN_BIRNN_CASES`: postnet T=1000 and encoder T=41); and at the
   vocoder trainer's evaluate() shape
   (`VOCODER_BIRNN_CASES`: WaveRNN's GRU H=512, one stream, T=1280, B=32,
   float32 at atol 1e-4; timed beside a one-way nn.GRU and the bound);
4. WaveRNN sampling kernel against its plain version, greedy, in both
   compute types (class agreement > 95%; MOL within 1e-3 on > 95%): RAW
   at 64 lanes x 3850 steps, float32 at 128 lanes x 600 steps, bfloat16 at
   72 lanes x 3850 steps (the 920-frame utterance's fold), MOL at 16 lanes
   x 1650 steps, float32 at VOC_GEN_LANES lanes x 12100 steps (the
   vocoder trainer's fold, target 11000 and overlap 550; bfloat16 there
   on > 90%: flips of near ties grow with the steps); RAW and MOL
   sampled, same seed same samples, lane groups; timed in bfloat16 at 1,
   8, 64 and 128 lanes x 3850 steps and at the trainer's fold;
5. the main path at the full width of config.yaml with random weights:
   `gen_forward.main` on three lines of sentences.txt (text -> ids ->
   generate -> vocode -> int16 wav), with the kernels' launch counts
   reset just before and read just after, every launch of kernel #1 on
   the stream-local path, which its plan names for every batch-1 bf16
   shape of the serving path; per-stage CUDA-event times;
   one utterance decoded at 8 frames per phoneme; a float32 check of the
   decoder against the CPU plain path;
6. the serving path at the full width of config.yaml, random weights
   (HiFi-GAN V1 written in the official layout, MelGAN in the hub's):
   `gen_forward.main` with griffinlim, hifigan, melgan, `wavernn --stream
   --stream_group 8` and `wavernn --batched_utterances` on three lines of
   sentences.txt, each run's launches of kernels #1 / #4 counted from 0;
   each vocoder's ms and RTF on the 920-frame utterance; `vocode_batch`
   greedy against per-utterance `vocode` (float32 the same class at every
   sample, bfloat16 on > 95%) and timed against three `vocode` calls and
   at 8 x 920 frames; Griffin-Lim on the card against the CPU plain path
   with the same draw, stage by stage (NNLS, one round, and the spectral
   convergence after 32 rounds, each within 1e-3); `TTSServer` with
   wavernn and with hifigan, warmed at buckets 1, 2, 4, 8 (kernel #1's
   path recorded for each), answering 8 concurrent requests of mixed
   alpha / pitch_scale twice (the first round meets the vocoders' shapes
   for the first time; int16 of the decoded lengths; wall time, audio
   seconds a second, latency percentiles, batch sizes), and
   `make_http_server` on
   127.0.0.1: /healthz, /tts, /tts_stream with the time to its first
   chunk;
7. BiRNN training kernels (forward with stash, BPTT) against their plain
   versions at the training path's shapes (B=32: decoder LSTM H=512
   T=1024 ragged, postnet GRU H=256 T=1024, prenet GRU H=256 T=192,
   predictor GRUs H=128/64 T=192; and the teacher's CBHG GRUs,
   `TEACHER_TRAIN_KERNEL_CASES`: postnet H=128 T=1250 at B=32 (r=5) and
   B=8 (r=1), encoder H=128 T=200 at B=32, ragged; and WaveRNN's GRU,
   `VOCODER_TRAIN_KERNEL_CASES`: H=512, one stream, T=1280, B=32, timed
   beside a one-way nn.GRU; float32 at atol 1e-4;
   bfloat16 at 2^-7
   of the largest plain value for the outputs stored in bfloat16 (stash,
   dgi, dgh), 2e-3 for y, and a relative L2 error of at most 2^-8), with
   each kernel's path (`train_forward_plan`, `train_backward_plan`;
   kernel #2's cluster path wherever planned, #3 over its stash), the
   cooperative paths forced, checked and timed on the same inputs where
   another is planned, timings beside cuDNN's nn.LSTM/nn.GRU in float32 and
   bfloat16 with each dtype's bound (`_train_kernel_bf16_times`); wherever
   the cluster forward is planned (grad_accum's micro-batches included) it
   must measure faster than the cooperative forward;
8. the training path at full width: `ForwardTrainer.train` for 6 steps at
   batch 32 on a synthetic LJSpeech-like dataset, counts reset just
   before and read just after (kernels #2/#3), then one `evaluate()`
   (kernel #1, every launch stream-local); each recurrence of every step
   on the paths its plans give (`_planned_launches`: the predictor BiGRUs
   batch-split, the prenet and postnet forwards on the cluster path, the
   decoder's cooperative; backward batch-split or cooperative); losses
   finite, every parameter
   moved, the checkpoint served by `gen_forward`; ms per step split into forward, backward and
   optimizer; float32 gradients on the card against the CPU plain path,
   the CPU replaying the card's ReLU and max-pool decisions;
9. the data path and the Tacotron teacher at the full width of
   config.yaml's `dsp` and `tacotron.model`, random weights (`teacher_path`
   lists its cuts): a seeded LJSpeech-layout corpus through
   `preprocess.main` (mel and F0 on the card; F0 against the CPU plain
   path and the known contour), `TacoTrainer.train` at r=5 batch 32 and
   r=1 batch 8 (two launches each of #2 and #3 a step, on their planned
   paths), `evaluate()` (#1), the step split into forward, backward and
   optimizer with peak memory and idle share, float32 teacher outputs and
   gradients against the CPU, `train_tacotron.main` with `--force_align`
   (#1 counted; every duration sum its mel_len; attention card vs CPU at
   atol 1e-4) and `--extract_pitch`, and `ForwardTrainer.train` for 2
   steps on what the port wrote;
10. the vocoder-training path at the full width of config.yaml's
   `vocoder` and `hifigan` sections, random weights (`vocoder_path` lists
   its cuts): `train_forward.main(['--force_gta'])` on a seeded student
   (utterances a second); `train_wavernn.main(['--gta'])` at batch 32,
   RAW, with two launches each of #2 and #3 a step on their planned
   paths, `evaluate()` through #1 and `generate_samples` through #4 (a
   finite mel L1), its checkpoint served by `gen_forward wavernn`; MOL
   steps; the step split into forward, backward and optimizer with peak
   memory and idle share; float32 gradients against the CPU with the
   ReLU decisions replayed; `train_hifigan.main(['--gta'])` for HiFi-GAN
   V1 and MelGAN at batch 16, seg_len 8192 (finite losses, every
   parameter moved, served by `gen_forward hifigan|melgan`), each step
   split into the discriminators' and the generator's halves. Every
   step timing (phases 8-10, `step_timing`) takes the device's busy time
   as the union of its kernel intervals (`profiled`);
11. the trainers' options at the full width of config.yaml, random
   weights (`options_path` lists its cuts): `ForwardTrainer.train` with
   bf16, grad_accum 2, remat and EMA together (counts zeroed just before
   and read just after; `evaluate()` with the EMA weights through #1; the
   background writer's latest_model.pt against a synchronous payload);
   the student's step at batch 32 on the 768-frame bucket in float32,
   bf16, grad_accum 2 and 4, remat and ema_decay 0.9995, the teacher's at
   r=5 B=32 and WaveRNN's in float32, bf16 and remat, HiFi-GAN V1 and
   MelGAN in float32 and bf16, each timed by `step_timing` with #2/#3
   counted by compute dtype (bf16 steps launch them in bf16 only, remat
   twice a recurrence forward, grad_accum k times k, each on the paths its
   plans give at the micro-batch); `VocTrainer.train`
   in bf16 with remat (#4 in generate_samples); on the card, the
   student's remat gradients against no remat (running statistics equal,
   phase 8's limits) and its bf16 gradients against float32 (relative L2
   <= BF16_GRAD_L2_LIMIT);
12. FastPitch, the teacher's free-running synthesis and the objective
   evaluation at the full width of config.yaml's `fast_pitch`,
   `tacotron` and `vocoder` sections, random weights
   (`fast_pitch_and_teacher_path` lists its cuts): `ForwardTrainer.train`
   with tts_model fast_pitch for 5 steps at batch 32 on phase 8's dataset
   (no kernel launched, counted from 0; losses finite, every parameter
   moved), its step split by `step_timing` in float32 and bf16, float32
   gradients against the CPU with conv1's ReLU decisions replayed; its
   checkpoint served by `gen_forward` griffinlim and wavernn (#4 > 0, #1
   0) and by `TTSServer` with wavernn at 8 concurrent requests; the
   920-frame utterance into series, decode and vocode by CUDA events, the
   float32 mel card vs CPU at atol 1e-4; `gen_tacotron.main` with
   griffinlim and wavernn on one line (#1 counted on its planned path, #4
   in the wavernn run), ms a decoder step, `Tacotron.generate` card vs CPU
   over 16 steps at atol 1e-4 with an equal n_valid; `eval_tts.main` with
   the DSP and F0 on the card, a corpus against itself (MCD 0) and against
   a copy 100 cents higher (F0 RMSE near 100 cents), both against the
   CPU's numbers; kernel #1 at the teacher's free-running shapes (B=1,
   H=128, float32: `TEACHER_GEN_BIRNN_CASES`) runs in phase 3;
13. multi-speaker training and synthesis, the teacher-free aligner and
   the DeepMind WaveRNN at the full width of config.yaml, random weights
   (`speakers_and_aligner_path` lists its cuts): a seeded corpus of 8
   speakers in `id|speaker|text` layout through `preprocess.main(...,
   '--metadata_format', 'multispeaker')` (speaker_dict.pkl checked);
   `TacoTrainer.train` with 8 speakers at r=5 batch 32 (#2/#3 on their
   planned paths), its step by `step_timing`, `train_tacotron
   --force_align` (#1 two a batch; utterances a second); `train_aligner`
   at batch 32 and `--force_align` (no kernel launched, counted from 0;
   every parameter moved, durations summing to mel_len, utterances a
   second), its step with the dynamic program's share, on one batch card
   against CPU (Viterbi durations equal, loss and gradients within 1e-4);
   `ForwardTrainer.train` with 8 speakers for 3 steps on the aligner's
   durations (#2/#3 planned), its step, eval outputs card vs CPU;
   `gen_forward wavernn --speaker 0 / 5` (#1 and #4; the voices differ),
   `gen_tacotron --speaker 3`; `TTSServer` answering 8 concurrent
   requests of the 8 voices (wall time, audio seconds a second) and, in
   float32, each voice's mel in the batch equal to its solo run at
   1e-4; FastPitch with 8 speakers, generate card vs CPU; the DeepMind
   WaveRNN's step card vs CPU at 1e-5 and 1000 generate steps timed;
14. the fused server and the export at the full width of config.yaml,
   random weights (`export_and_fused_path` lists its cuts):
   `TTSServer(fused=True)` (each key one captured CUDA graph) and the
   staged server with HiFi-GAN V1 and with WaveRNN (bf16) answering two
   rounds of 8 concurrent requests (wall time, audio seconds a second,
   batch sizes, the capture seconds of each key, the graph pool's
   memory), the 920-frame utterance staged against one fused replay (CUDA
   events and host clock); the replay against the same function run
   eagerly, bit for bit, with #1 and #4 counted by kernel name in a
   profiled replay and held to the eager run's counts; WaveRNN replays
   with another seed differ; the float32 fused mel against the CPU at
   atol 1e-4; a mel past fused_max_t served by the staged path;
   `export_forward --device cuda` with WaveRNN and with HiFi-GAN (export
   seconds, file size), the artifact's synthesize repeatable at a fixed
   seed with #1 and #4 counted, its generate against the live model (mel
   L1 < 1e-3);
15. native I/O and the batch loader at the full width of config.yaml,
   random weights (`native_io_path` lists its cuts): the host library
   built by g++ from `forwardtacotron_tpu_torch/native/` (the seconds of
   each source); a seeded corpus at 44.1 kHz 16-bit, 48 kHz 24-bit stereo
   and 22.05 kHz float32 through `preprocess.main` (audio seconds a
   second), `DSP.load_wav` against numpy within one ulp and a `save_wav`
   round trip; `ForwardTrainer.train` (3 steps, batch 32) with
   `evaluate()` and `VocTrainer.train` (3 RAW steps at seq_len 1280, its
   evaluate() and one generate_samples) fed by the native loader, #1-#4
   counted from 0 just before and read just after, every batch native and
   equal to the numpy collation of its plan bit for bit; batch assembly
   ms native against numpy; each step by `step_timing`;
16. data parallelism at the full width of config.yaml, random weights
   (`parallel_path` lists its cuts): `vocode_batch` over a mesh of
   [cuda:0, cuda:0] with 3 and 8 mels (greedy float32 bit-equal to the
   unsharded call, one #4 launch a shard; sampled shard i equal to
   `vocode_batch` of its mels at seed + i * 7919) and `TTSServer(wavernn,
   mesh=)` at 8 concurrent requests; two spawned gloo ranks sharing the
   card, 16 rows each of one global batch of 32 (mixed lengths), one
   student and one WaveRNN step against one process at 32 (loss within rel
   1e-5, reduced gradients within 1e-4 where |g| > 1e-4, both ranks
   bit-identical, #2/#3 counted a rank), and the checkpoint directory
   they write round-tripped; `python -m torch.distributed.run
   --standalone --nproc_per_node 1 -m
   forwardtacotron_tpu_torch.train_forward --config cli.json` (NCCL) for 2
   steps, its checkpoint loaded; `ForwardTrainer.train` and
   `VocTrainer.train` (3 steps each at batch 32) under a one-rank NCCL mesh
   against no group (within 1e-6), each step by `step_timing` with and
   without the mesh and the gradient all-reduce alone;
17. the trainers' plots and the mesh's 'model' axis at the full width of
   config.yaml, random weights (`logging_and_model_axis_path` lists its
   cuts): `ForwardTrainer.train` and `TacoTrainer.train` (r=5), 2 steps
   each at batch 32 with `plot_every` 1 and a recording writer (three
   finite wavs a plot, the teacher-forced ones of the target's length;
   without matplotlib the figures skipped with the note), one more
   `generate_plots` each timed by CUDA events with its #1 launches held
   to those of its passes called directly; two spawned gloo ranks sharing
   the card as data 1 x model 2, one student and one WaveRNN step on the
   whole batch of 32 against one process (loss within rel 1e-5, gradient
   shards within 1e-4 where |g| > 1e-4, the peers' gathered weights
   bit-identical, #2/#3 counted a rank, each rank's resident parameters
   and Adam state within 2% of the share `param_spec` predicts, by the
   caching allocator's requested bytes, `torch.cuda.memory_allocated`
   with the allocator's block slack reported beside);
18. a {"kernels": [...]} JSON line (launches of the main paths, of the
   teacher phase in `launches_teacher`, of the vocoder phase in
   `launches_vocoder`, of the options phase in `launches_options`, of
   phase 12's FastPitch paths in `launches_fast_pitch` and of its
   gen_tacotron runs in `launches_gen_tacotron`, of phase 13's
   multi-speaker paths in `launches_multispeaker` and of its aligner runs
   in `launches_aligner`, of phase 14's fused replays in `launches_fused`
   and of its exported artifacts in `launches_export`, of phase 15 in
   `launches_native_io`, of phase 16 in `launches_parallel`, of phase 17
   in `launches_logging_model_axis`, each kernel's time at the vocoder path's shape in `vocoder_*` and #2/#3
   in bf16 in `bf16_*`; #2's cluster path with the cooperative path's
   times on the same inputs in `*cooperative_ms`), the nvidia-smi line,
   and last
   {"ok": true, "device": {...}}.

Each phase's wall seconds go to `phase_seconds`, and the details to
chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import contextlib
import copy
import json
import math
import shutil
import subprocess
import sys
import time
import traceback
import types
import warnings
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
OUT_DIR = Path('chiprun_out')
TRAIN_DIR = Path('smoke_train')     # synthetic dataset and checkpoints
FAILURES = []
DETAILS = {}


def log(*a):
    print(*a, flush=True)


def check(ok: bool, what: str) -> None:
    log(('  ok   ' if ok else '  FAIL ') + what)
    if not ok:
        FAILURES.append(what)


def phase(name):
    def wrap(fn):
        def run(*args, **kw):
            log(f'\n== {name}')
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            except Exception:
                FAILURES.append(f'{name}: {traceback.format_exc()}')
                log(traceback.format_exc())
                return None
            finally:
                seconds = time.perf_counter() - t0
                DETAILS.setdefault('phase_seconds', {})[name] = seconds
                log(f'   ({name}: {seconds:.1f} s)')
        return run
    return wrap


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, flops: float, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def profiled(prof, wall_ms: float, top: int = 12) -> dict:
    """What one profiled run shows of the device: its busy time as the
    union of the kernel intervals (kernels that overlap, as on cuDNN's side
    streams, count once; a sum of their self times would count them
    twice), the idle share against the wall time, the self times summed,
    and the `top` kernels by self time."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if str(e.device_type).endswith('CUDA'))
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    busy /= 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if str(e.device_type).endswith('CUDA')
                      and e.self_device_time_total > 0),
                     key=lambda k: -k[1])
    return {'wall_ms': wall_ms, 'device_busy_ms': busy,
            'kernel_ms_summed': sum(k[1] for k in kernels),
            'idle_share': 1.0 - busy / wall_ms if spans else 'not measured',
            'top': [{'kernel': k[:90], 'ms': t, 'count': c}
                    for k, t, c in kernels[:top]]}


def train_parts(model, optimizer, micro_loss, batch, train_cfg, ema=None,
                prepare=None) -> list:
    """One training step as the trainers run it (`train/common.py`:
    `accumulate` of the trainer's own `micro_loss` builder on `batch`,
    made ready by `prepare` where given, then `apply_update`), as
    `step_timing`'s parts: forward with the loss, backward and the clip +
    optimizer (+ EMA); with grad_accum k > 1 forward and backward
    alternate by micro-batch and are timed together."""
    from forwardtacotron_tpu_torch.train import common as tc
    k = tc.grad_accum(train_cfg)
    held = {}

    def optimize():
        tc.apply_update(model, optimizer, {}, train_cfg['clip_grad_norm'],
                        ema)

    def ready():
        model.train()
        optimizer.zero_grad(set_to_none=True)
        return batch if prepare is None else prepare(batch)

    if k > 1:
        return [('forward_backward_ms',
                 lambda: tc.accumulate(micro_loss, ready(), k, model)),
                ('optimizer_ms', optimize)]

    def forward():
        held['loss'] = micro_loss(ready())[0]
    return [('forward_ms', forward),
            ('backward_ms', lambda: held.pop('loss').backward()),
            ('optimizer_ms', optimize)]


def step_timing(parts, what: str, smi: str, warmup: int = 2,
                reps: int = 3) -> dict:
    """ms per step of `parts`, (name, closure) pairs run in order and
    split by CUDA events (median of `reps` after `warmup` steps); the peak
    memory of a step; one more step under the profiler (`profiled`)."""
    from torch.profiler import ProfilerActivity, profile
    rows = []
    torch.cuda.reset_peak_memory_stats()
    for rep in range(warmup + reps):
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(parts) + 1)]
        ev[0].record()
        for e, (_, fn) in zip(ev[1:], parts):
            fn()
            e.record()
        ev[-1].synchronize()
        if rep >= warmup:
            rows.append([ev[i].elapsed_time(ev[i + 1])
                         for i in range(len(parts))])
    out = {name: float(np.median([r[i] for r in rows]))
           for i, (name, _) in enumerate(parts)}
    out['step_ms'] = sum(out.values())
    out['peak_memory_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _, fn in parts:
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out['profiled'] = prof_out = profiled(prof, wall_ms)
    split = ' + '.join(f'{name[:-3]} {out[name]:.2f}' for name, _ in parts)
    log(f'  {what}: {split} = {out["step_ms"]:.2f} ms, peak memory '
        f'{out["peak_memory_gib"]:.2f} GiB; profiled wall {wall_ms:.1f} ms, '
        f'device busy {prof_out["device_busy_ms"]:.1f} ms (kernel times '
        f'summed {prof_out["kernel_ms_summed"]:.1f}), idle share '
        f'{prof_out["idle_share"]} | {smi}')
    for row in prof_out['top'][:8]:
        log(f'    {row["ms"]:8.2f} ms  x{row["count"]:<4} {row["kernel"]}')
    return out


def nvidia_smi_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ build

@phase('build')
def build_kernels():
    from forwardtacotron_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    reports = _build.build(['birnn', 'birnn_train', 'wavernn_sample'])
    DETAILS['build_s'] = time.perf_counter() - t0
    DETAILS['ptxas'] = reports
    for name, rep in reports.items():
        for line in rep.splitlines():
            if 'registers' in line or 'spill' in line:
                log(f'  {name}: {line.strip()}')
    log(f'  built {sorted(reports)} in {DETAILS["build_s"]:.1f} s')


# ------------------------------------------------------------------ BiRNN

def _birnn_inputs(cell, T, B, S, H, dtype, seed, lens):
    g = torch.Generator().manual_seed(seed)
    ng = 4 if cell == 'lstm' else 3
    bound = 1.0 / math.sqrt(H)
    gi = (torch.randn((T, B, S, ng * H), generator=g) * 0.5).to(dtype)
    w = ((torch.rand((S, ng * H, H), generator=g) * 2 - 1) * bound).to(dtype)
    if cell == 'lstm':
        b = torch.zeros((S, ng * H))
    else:
        b = (torch.rand((S, ng * H), generator=g) * 2 - 1) * bound
    lengths = torch.tensor(lens, dtype=torch.int32)
    return [t.cuda().contiguous() for t in (gi, w, b, lengths)]


# kernel #1 at the serving path's shapes, batch 1, as (name, cell, S, T, H):
# the 920-frame utterance's mel bucket (1024) and text bucket (160); the
# predictors are the six streams of the fused series predictors (H=64
# padded to 128). Also timed by tools/torch_kernel_probe.py --only birnn.
SERVING_BIRNN_CASES = (
    ('decoder', 'lstm', 2, 1024, 512),
    ('postnet', 'gru', 2, 1024, 256),
    ('prenet', 'gru', 2, 160, 256),
    ('predictors', 'gru', 6, 160, 128))

# kernel #1 at the shapes that evaluate() gives it on the training path, as
# (name, cell, T, H, lengths): batch 32, two streams, the 896-frame bucket
# and its text pad of 176, float32. Also timed by
# tools/torch_kernel_probe.py --only birnn_eval.
EVAL_BIRNN_CASES = (
    ('decoder', 'lstm', 896, 512, tuple(870 - 11 * i for i in range(32))),
    ('postnet', 'gru', 896, 256, (896,) * 32),
    ('prenet', 'gru', 176, 256, (176,) * 32),
    ('pitch', 'gru', 176, 128, (176,) * 32),
    ('dur/energy', 'gru', 176, 64, (176,) * 32))


# kernel #1 at the Tacotron teacher's alignment shapes (create_align_features
# and evaluate(): batch 8, two streams, float32), as (name, cell, T, H,
# lengths): the postnet CBHG BiGRU over up to max_mel_len = 1250 frames and
# the encoder's over ~200 phonemes
TEACHER_BIRNN_CASES = (
    ('teacher postnet', 'gru', 1250, 128, tuple(1250 - 37 * i
                                                for i in range(8))),
    ('teacher encoder', 'gru', 200, 128, tuple(200 - 9 * i
                                               for i in range(8))))


# kernel #1 at the teacher's free-running shapes (gen_tacotron, batch 1,
# float32), as (name, cell, T, H, lengths): the postnet CBHG BiGRU over the
# whole 1000-step buffer and the encoder's over the 41 ids of the first
# line of sentences.txt
TEACHER_GEN_BIRNN_CASES = (
    ('teacher synthesis postnet', 'gru', 1000, 128, (1000,)),
    ('teacher synthesis encoder', 'gru', 41, 128, (41,)))


# kernel #1 at the shape evaluate() gives it on the vocoder-training path,
# as (name, cell, T, H, lengths): WaveRNN's two unidirectional GRUs (one
# stream each) over seq_len 1280 at batch 32, float32
VOCODER_BIRNN_CASES = (
    ('wavernn GRU', 'gru', 1280, 512, (1280,) * 32),)


def _birnn_bound(cell, gi, w, b, ln, H):
    """bound_ms of kernel #1 on these inputs: the gate inputs of the
    active steps (those inside each lane's sequence, all the function
    reads of gi), W_hh, b_hh and the lengths read once, all of y written
    once; the products of the active steps."""
    T, B, S, GH = gi.shape
    active = sum(min(max(int(n), 0), T) for n in ln.tolist()) * S
    n_bytes = (active * GH + w.numel()) * gi.element_size() \
        + b.numel() * 4 + ln.numel() * 4 + T * B * S * H * 4
    flops = 2.0 * active * (4 if cell == 'lstm' else 3) * H * H
    return bound_ms(n_bytes, flops, gi.dtype)


@phase('BiRNN kernel vs plain')
def birnn_cases():
    from forwardtacotron_tpu_torch.kernels import birnn as kb
    from forwardtacotron_tpu_torch.ops.rnn import birnn_recurrence
    props = torch.cuda.get_device_properties(0)
    smem, n_sms = props.shared_memory_per_block_optin, \
        props.multi_processor_count
    rows = []
    for what, cell, S, T, H in SERVING_BIRNN_CASES:
        # the server's pow-2 buckets 2 and 4 too, for the decode's
        # recurrences in the serving path's compute type
        batches = (1, 8) + ((2, 4) if what in ('decoder', 'postnet') else ())
        for B in batches:
            lens = [T - 100] if B == 1 else [T - 13 * i for i in range(B)]
            dtypes = ((torch.float32, 1e-4), (torch.bfloat16, 2e-2))
            for dtype, tol in dtypes[1:] if B in (2, 4) else dtypes:
                gi, w, b, ln = _birnn_inputs(cell, T, B, S, H, dtype,
                                             seed=T + H + B, lens=lens)
                plan = kb.inference_plan(cell, S, B, H, dtype, smem, n_sms)
                # at batch 1 the stream-local and cooperative paths both
                # run on the same inputs
                paths = [plan['path']]
                if B == 1 and plan['path'] == 'stream_local':
                    paths.append('cooperative')
                outs = {p: kb.recurrence(cell, gi, w, b, ln, dtype, path=p)
                        for p in paths}
                torch.cuda.synchronize()
                ref = birnn_recurrence(cell, gi, w, b, ln, dtype)
                name = (f'{what} {cell} T={T} H={H} S={S} B={B} '
                        f'{str(dtype)[6:]}')
                row = {'case': name, 'path': plan['path'],
                       'cluster': plan.get('cluster'), 'tol': tol,
                       'max_abs_err': {}}
                for p, y in outs.items():
                    err = float((y - ref).abs().max())
                    check(err <= tol and bool(torch.isfinite(y).all()),
                          f'BiRNN {name} {p}: max|kernel-plain| {err:.3g} '
                          f'<= {tol}')
                    row['max_abs_err'][p] = err
                if B == 1 and (dtype == torch.bfloat16 or cell == 'lstm'):
                    for p in paths:
                        row[f'ms_{p}'] = cuda_ms(lambda: kb.recurrence(
                            cell, gi, w, b, ln, dtype, path=p), reps=5)
                    row['plain_ms'] = cuda_ms(lambda: birnn_recurrence(
                        cell, gi, w, b, ln, dtype), reps=1, warmup=0)
                    row['bound_ms'], row['bound_by'] = _birnn_bound(
                        cell, gi, w, b, ln, H)
                    row['library_ms'] = _cudnn_ms(cell, T, H, S, B, dtype)
                    if plan['path'] == 'stream_local':
                        row['resident_clusters'] = kb.sl_size_on_card(
                            cell, H, dtype, plan['cluster'],
                            plan['splits'])[2]
                    times = ', '.join(f'{p} {row[f"ms_{p}"]:.3f} ms'
                                      for p in paths)
                    log(f'  {name}: {times} (planned {plan["path"]}, '
                        f'cluster {plan.get("cluster")}, resident '
                        f'{row.get("resident_clusters")}), plain '
                        f'{row["plain_ms"]:.1f} ms, bound '
                        f'{row["bound_ms"]:.4f} ms ({row["bound_by"]}), '
                        f'library {row["library_ms"]}')
                rows.append(row)
    f32 = torch.float32
    for what, cell, T, H, lens, B, S in (
            [c + (32, 2) for c in EVAL_BIRNN_CASES]
            + [c + (8, 2) for c in TEACHER_BIRNN_CASES]
            + [c + (1, 2) for c in TEACHER_GEN_BIRNN_CASES]
            + [c + (32, 1) for c in VOCODER_BIRNN_CASES]):
        gi, w, b, ln = _birnn_inputs(cell, T, B, S, H, f32, seed=T + H,
                                     lens=lens)
        plan = kb.inference_plan(cell, S, B, H, f32, smem, n_sms)
        # the decoder on the cooperative path too, on the same inputs
        paths = [plan['path']]
        if what == 'decoder' and plan['path'] == 'stream_local':
            paths.append('cooperative')
        outs = {p: kb.recurrence(cell, gi, w, b, ln, f32, path=p)
                for p in paths}
        torch.cuda.synchronize()
        ref = birnn_recurrence(cell, gi, w, b, ln, f32)
        name = (f'{what}: {cell} T={T} H={H} S={S} B={B} float32'
                if what.startswith('teacher') else
                f'evaluate() {what}: {cell} T={T} H={H} S={S} B={B} '
                'float32')
        row = {'case': name, 'path': plan['path'],
               'cluster': plan.get('cluster'), 'waves': plan.get('waves'),
               'max_abs_err': {}, 'tol': 1e-4}
        for p, y in outs.items():
            err = float((y - ref).abs().max())
            check(err <= 1e-4 and bool(torch.isfinite(y).all()),
                  f'BiRNN {name} {p}: max|kernel-plain| {err:.3g} <= 0.0001')
            row['max_abs_err'][p] = err
        if what in ('decoder', 'wavernn GRU') or what.startswith('teacher'):
            for p in paths:
                row[f'ms_{p}'] = cuda_ms(lambda: kb.recurrence(
                    cell, gi, w, b, ln, f32, path=p), reps=3)
            row['plain_ms'] = cuda_ms(lambda: birnn_recurrence(
                cell, gi, w, b, ln, f32), reps=1, warmup=0)
            row['bound_ms'], row['bound_by'] = _birnn_bound(cell, gi, w, b,
                                                            ln, H)
            row['library_ms'] = _cudnn_ms(cell, T, H, S, B, f32)
            times = ', '.join(f'{p} {row[f"ms_{p}"]:.3f} ms' for p in paths)
            log(f'  {name}: {times} (planned {plan["path"]}, cluster '
                f'{plan.get("cluster")}, {plan.get("waves")} waves), plain '
                f'{row["plain_ms"]:.1f} ms, bound {row["bound_ms"]:.4f} ms '
                f'({row["bound_by"]}), library {row["library_ms"]:.3f} ms')
        rows.append(row)
    DETAILS['birnn'] = rows
    return rows


def _cudnn_ms(cell, T, H, S, B, dtype):
    """One cuDNN nn.LSTM/nn.GRU call over (B, T, H) inputs (input
    projection included), bidirectional for two streams and one-way for
    one, as a yardstick; None for grouped streams, which no single library
    call computes."""
    if S not in (1, 2):
        return None
    mod = (torch.nn.LSTM if cell == 'lstm' else torch.nn.GRU)(
        H, H, batch_first=True, bidirectional=S == 2).cuda().to(dtype)
    mod.flatten_parameters()
    x = torch.randn((B, T, H), device='cuda', dtype=dtype)
    with torch.no_grad():
        return cuda_ms(lambda: mod(x), reps=5)


# ---------------------------------------------------------------- WaveRNN

def _wavernn_inputs(mode, lanes, steps, seed):
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.models.wavernn import (WaveRNN,
                                                          fold_with_overlap)
    cfg = default_config()
    cfg['vocoder']['model']['mode'] = mode
    torch.manual_seed(seed)
    model = WaveRNN.from_config(cfg).cuda().eval()
    hop, overlap = cfg['dsp']['hop_length'], 550
    target = steps - 2 * overlap
    n_frames = (lanes * (target + overlap) + overlap) // hop + 1
    g = torch.Generator().manual_seed(seed)
    mel = (torch.randn((1, n_frames + 2 * model.pad, 80), generator=g)
           * 0.5 - 2.0).cuda()
    mels_up, aux = model.upsample_cond(mel)
    mels_f = fold_with_overlap(mels_up, target, overlap)[:lanes]
    aux_f = fold_with_overlap(aux, target, overlap)[:lanes]
    return model, mels_f.contiguous(), aux_f.contiguous()


@phase('WaveRNN kernel vs plain')
def wavernn_cases():
    from forwardtacotron_tpu_torch.kernels import wavernn_sample as ws
    out = {}
    f32, bf16 = torch.float32, torch.bfloat16
    # the sampler reads its seed from an int64 on the card
    seeds = {n: ws.seed_tensor(n, 'cuda') for n in (0, 3, 5, 7, 8, 9)}
    # RAW greedy float32 at 64 lanes x 3850 steps
    model, mels, aux = _wavernn_inputs('RAW', 64, 3850, seed=1)
    w32 = ws.pack_weights(model, f32)
    cond32 = ws.compact_cond(mels, aux, f32)
    k = ws.sample(cond32, w32, seeds[0], 0, True, f32)
    torch.cuda.synchronize()
    p = ws.sample_plain(cond32, w32, 0, 0, True, f32)
    agree = float(((k - p).abs() < 1e-6).float().mean())
    check(agree > 0.95, f'RAW greedy f32 64x3850: class agreement '
                        f'{agree:.4f} > 0.95')
    out['raw_greedy_f32_agreement'] = agree
    out['raw_greedy_f32_max_abs_err'] = float((k - p).abs().max())

    # RAW sampled bfloat16 (the main path's mode): timing and checks
    wbf = ws.pack_weights(model, bf16)
    condbf = ws.compact_cond(mels, aux, bf16)
    a = ws.sample(condbf, wbf, seeds[7], 0, False, bf16)
    b = ws.sample(condbf, wbf, seeds[7], 0, False, bf16)
    c = ws.sample(condbf, wbf, seeds[8], 0, False, bf16)
    torch.cuda.synchronize()
    check(bool((a.abs() <= 1).all()) and float(a.std()) > 0,
          f'RAW sampled bf16: in [-1, 1], std {float(a.std()):.3f} > 0')
    check(torch.equal(a, b), 'RAW sampled: same seed, same output')
    check(not torch.equal(a, c), 'RAW sampled: other seed, other output')
    ps = ws.sample_plain(condbf, wbf, 7, 0, False, bf16)
    out['raw_sampled_bf16_agreement'] = float(
        ((a - ps).abs() < 1e-6).float().mean())
    out['raw_sampled_bf16_max_abs_err'] = float((a - ps).abs().max())
    log(f'  RAW sampled bf16 kernel/plain agreement '
        f'{out["raw_sampled_bf16_agreement"]:.4f}')
    # the main path's compute type, greedy: the same class on > 95% of the
    # samples (products sum in another order than the plain version's, so
    # a near tie may flip, and the trajectory then differs for a while)
    gk = ws.sample(condbf, wbf, seeds[0], 0, True, bf16)
    gp = ws.sample_plain(condbf, wbf, 0, 0, True, bf16)
    agree = float(((gk - gp).abs() < 1e-6).float().mean())
    check(agree > 0.95, f'RAW greedy bf16 64x3850: class agreement '
                        f'{agree:.4f} > 0.95')
    out['raw_greedy_bf16_agreement'] = agree
    out['raw_greedy_bf16_max_abs_err'] = float((gk - gp).abs().max())
    T, L, C = condbf.shape
    out['ms'] = cuda_ms(lambda: ws.sample(condbf, wbf, seeds[7], 0, False,
                                          bf16), reps=2)
    out['plain_ms'] = cuda_ms(lambda: ws.sample_plain(
        condbf, wbf, 7, 0, False, bf16), reps=1, warmup=0)
    H, F, NC = model.rnn_dims, model.fc_dims, model.n_classes
    d = model.aux_dims
    macs = (3 * H * H * 4 + H * F + F * F + F * NC
            + H * (80 + d) + 3 * H * d + 2 * F * d)
    n_bytes = condbf.numel() * 2 + sum(
        t.numel() * t.element_size() for t in wbf.values()) + T * L * 4
    out['bound_ms'], out['bound_by'] = bound_ms(n_bytes, 2.0 * macs * T * L,
                                                bf16)
    out['shape'] = f'RAW sampled bf16 {L} lanes x {T} steps'
    log(f'  {out["shape"]}: kernel {out["ms"]:.1f} ms, plain '
        f'{out["plain_ms"]:.1f} ms, bound {out["bound_ms"]:.3f} ms '
        f'({out["bound_by"]})')
    out['agreement'] = out['raw_greedy_bf16_agreement']
    out['max_abs_err'] = out['raw_greedy_bf16_max_abs_err']

    # 128 lanes (MAX_LANES) x 600 steps: greedy float32 against the plain
    # version, and same seed, same samples in bf16
    model128, mels128, aux128 = _wavernn_inputs('RAW', 128, 600, seed=4)
    w32 = ws.pack_weights(model128, f32)
    cond128 = ws.compact_cond(mels128, aux128, f32)
    k = ws.sample(cond128, w32, seeds[0], 0, True, f32)
    p = ws.sample_plain(cond128, w32, 0, 0, True, f32)
    agree = float(((k - p).abs() < 1e-6).float().mean())
    check(agree > 0.95, f'RAW greedy f32 128x600: class agreement '
                        f'{agree:.4f} > 0.95')
    out['raw_greedy_f32_128_agreement'] = agree
    cbf = ws.compact_cond(mels128, aux128, bf16)
    w128 = ws.pack_weights(model128, bf16)
    check(torch.equal(ws.sample(cbf, w128, seeds[9], 0, False, bf16),
                      ws.sample(cbf, w128, seeds[9], 0, False, bf16)),
          'RAW sampled bf16 128x600: same seed, same output')

    # 72 lanes x 3850 steps, the fold of the 920-frame utterance (a lane
    # tile and grid that no other case here takes): greedy bf16
    model72, mels72, aux72 = _wavernn_inputs('RAW', 72, 3850, seed=6)
    w72 = ws.pack_weights(model72, bf16)
    cond72 = ws.compact_cond(mels72, aux72, bf16)
    k = ws.sample(cond72, w72, seeds[0], 0, True, bf16)
    p = ws.sample_plain(cond72, w72, 0, 0, True, bf16)
    agree = float(((k - p).abs() < 1e-6).float().mean())
    check(agree > 0.95, f'RAW greedy bf16 72x3850: class agreement '
                        f'{agree:.4f} > 0.95')
    out['raw_greedy_bf16_72_agreement'] = agree

    # the vocoder trainer's fold (config.yaml vocoder.training: target
    # 11000, overlap 550, so 12100 steps a lane) at the lanes of one of
    # phase 10's validation mels: greedy float32 against the plain
    # version (the same class on > 95% of the samples, as at 64 x 3850);
    # greedy bf16, the trainer's compute type, on > 90%: over 12100 steps
    # a lane the near ties that bf16 products decide otherwise than the
    # plain version's are three times as many as over 3850, and each
    # flip sends a lane's trajectory its own way for a while (0.9437 of
    # the classes agreed on an H100 at 700 W, where a wrong kernel agrees
    # on a few per cent); timed sampled in bf16 beside its bound
    lanes, steps = VOC_GEN_LANES, 11_000 + 2 * 550
    model_g, mels_g, aux_g = _wavernn_inputs('RAW', lanes, steps, seed=8)
    fold = {}
    for dtype in (f32, bf16):
        w_g = ws.pack_weights(model_g, dtype)
        cond_g = ws.compact_cond(mels_g, aux_g, dtype)
        k = ws.sample(cond_g, w_g, seeds[0], 0, True, dtype)
        t0 = time.perf_counter()
        p = ws.sample_plain(cond_g, w_g, 0, 0, True, dtype)
        torch.cuda.synchronize()
        fold[dtype] = ((time.perf_counter() - t0) * 1e3,
                       float(((k - p).abs() < 1e-6).float().mean()),
                       float((k - p).abs().max()))
    agree = fold[f32][1]
    check(agree > 0.95, f'RAW greedy f32 {lanes}x{steps} (the trainer\'s '
                        f'fold): class agreement {agree:.4f} > 0.95')
    check(fold[bf16][1] > 0.90, f'RAW greedy bf16 {lanes}x{steps} (the '
                                f'trainer\'s fold): class agreement '
                                f'{fold[bf16][1]:.4f} > 0.90')
    n_bytes = cond_g.numel() * 2 + sum(
        t.numel() * t.element_size() for t in w_g.values()) + steps * lanes * 4
    gen_bound = bound_ms(n_bytes, 2.0 * macs * steps * lanes, bf16)
    out['trainer_fold'] = {
        'shape': f'RAW sampled bf16 {lanes} lanes x {steps} steps',
        'agreement': agree, 'max_abs_err': fold[f32][2],
        'bf16_greedy_agreement': fold[bf16][1],
        'ms': cuda_ms(lambda: ws.sample(cond_g, w_g, seeds[7], 0, False, bf16),
                      reps=2),
        'plain_ms': fold[bf16][0], 'bound_ms': gen_bound[0],
        'bound_by': gen_bound[1]}
    log(f'  trainer fold {out["trainer_fold"]}')

    # bf16 RAW sampled at 1, 8, 64 and 128 lanes x 3850 steps (random
    # conditioning of the model's width)
    g = torch.Generator(device='cuda').manual_seed(5)
    out['lanes_ms'] = {}
    for lanes in (1, 8, 64, 128):
        cond_l = (torch.randn((3850, lanes, C), device='cuda', generator=g)
                  * 0.5).to(bf16)
        out['lanes_ms'][lanes] = cuda_ms(
            lambda: ws.sample(cond_l, wbf, seeds[7], 0, False, bf16), reps=2)
    log(f'  RAW sampled bf16 x 3850 steps, ms by lanes: {out["lanes_ms"]}')

    # lane groups: 64 lanes as groups of 16 == one launch (greedy)
    one = ws.sample_conditioned(model, mels, aux, seeds[0], True, bf16)
    saved = ws.MAX_LANES
    ws.MAX_LANES = 16
    try:
        grouped = ws.sample_conditioned(model, mels, aux, seeds[0], True,
                                        bf16)
    finally:
        ws.MAX_LANES = saved
    check(torch.equal(one, grouped), 'lane groups of 16 == one launch')

    # MOL greedy float32 and MOL sampled
    model, mels, aux = _wavernn_inputs('MOL', 16, 1650, seed=2)
    w32 = ws.pack_weights(model, f32)
    cond32 = ws.compact_cond(mels, aux, f32)
    k = ws.sample(cond32, w32, seeds[0], 10, True, f32)
    p = ws.sample_plain(cond32, w32, 0, 10, True, f32)
    agree = float(((k - p).abs() < 1e-3).float().mean())
    check(agree > 0.95, f'MOL greedy f32 16x1650: agreement {agree:.4f} '
                        '> 0.95 at |d| < 1e-3')
    out['mol_greedy_f32_agreement'] = agree
    condbf, wbf = ws.compact_cond(mels, aux, bf16), ws.pack_weights(model,
                                                                    bf16)
    k = ws.sample(condbf, wbf, seeds[0], 10, True, bf16)
    p = ws.sample_plain(condbf, wbf, 0, 10, True, bf16)
    agree = float(((k - p).abs() < 1e-3).float().mean())
    check(agree > 0.95, f'MOL greedy bf16 16x1650: agreement {agree:.4f} '
                        '> 0.95 at |d| < 1e-3')
    out['mol_greedy_bf16_agreement'] = agree
    s = ws.sample(condbf, wbf, seeds[3], 10, False, bf16)
    torch.cuda.synchronize()
    check(bool((s.abs() <= 1).all()) and float(s.std()) > 0,
          'MOL sampled bf16: in [-1, 1], std > 0')
    DETAILS['wavernn'] = out
    return out


# -------------------------------------------------------------- main path

@phase('main path (full width)')
def main_path():
    from scipy.io import wavfile
    from forwardtacotron_tpu_torch import gen_forward
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.kernels import birnn as kb
    from forwardtacotron_tpu_torch.kernels.birnn import recurrence
    from forwardtacotron_tpu_torch.kernels.wavernn_sample import sample
    from forwardtacotron_tpu_torch.models.wavernn import vocode
    lines = [s for s in Path('sentences.txt').read_text().splitlines()
             if s.strip()][:3]

    recurrence.launches = 0
    recurrence.path_launches = dict.fromkeys(recurrence.path_launches, 0)
    sample.launches = 0
    t0 = time.perf_counter()
    paths = []
    for k, text in enumerate(lines):
        for path in gen_forward.main(['-i', text, '--seed', '0', 'wavernn']):
            paths.append(path.rename(path.with_name(f'smoke{k}_{path.name}')))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {'birnn': recurrence.launches,
                'wavernn_sample': sample.launches,
                **{f'birnn_{k}': v for k, v in
                   recurrence.path_launches.items()}}
    log(f'  main path: 3 utterances in {wall:.2f} s (host clock, first call '
        f'included), launches {launches}')
    check(launches['birnn'] > 0 and launches['wavernn_sample'] > 0,
          f'main path launched every kernel: {launches}')
    # the serving path runs kernel #1 at batch 1 in bf16, where the plan
    # names the stream-local path for each of its shapes; every launch
    # took it
    props = torch.cuda.get_device_properties(0)
    planned = {what: kb.inference_plan(
        cell, S, 1, H, torch.bfloat16, props.shared_memory_per_block_optin,
        props.multi_processor_count)['path']
        for what, cell, S, _, H in SERVING_BIRNN_CASES}
    check(set(planned.values()) == {'stream_local'}
          and launches['birnn_stream_local'] == launches['birnn'],
          f'kernel #1 on the serving path: {launches["birnn"]} launches, '
          f'{launches["birnn_stream_local"]} stream-local; planned at B=1 '
          f'bf16: {planned}')
    for path in paths:
        sr, wav = wavfile.read(path)
        rms = float(np.sqrt(np.mean(wav.astype(np.float64) ** 2)))
        check(wav.dtype == np.int16 and len(wav) > 0 and rms > 0,
              f'{path}: int16, {len(wav)} samples, rms {rms:.1f}')

    # stage times with CUDA events (same models and inputs)
    cfg = default_config()
    model, cfg, _ = gen_forward.load_tts(None, cfg, 'cuda', 0)
    voc, voc_cfg = gen_forward.load_voc(None, cfg, 'cuda', 0)
    hop = voc_cfg['dsp']['hop_length']
    stages = []
    for text in lines:
        ids = gen_forward.text_to_ids(text, cfg)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        mel = gen_forward.synthesize(model, ids)
        ev[1].record()
        wav = vocode(voc, mel, pcm16=True)
        ev[2].record()
        ev[2].synchronize()
        check(bool(np.isfinite(mel).all()) and len(wav) == (
            mel.shape[1] - 1) * hop and float(np.abs(wav).mean()) > 0,
            f'"{text[:24]}...": {len(ids)} ids, {mel.shape[1]} frames, '
            f'{len(wav)} samples')
        stages.append({'ids': len(ids), 'frames': mel.shape[1],
                       'samples': len(wav),
                       'mel_ms': ev[0].elapsed_time(ev[1]),
                       'vocode_ms': ev[1].elapsed_time(ev[2])})
        log(f'  stages: {stages[-1]}')
    DETAILS['main_path'] = {'launches': launches, 'wall_s': wall,
                            'stages': stages}
    long_text = [s for s in Path('sentences.txt').read_text().splitlines()
                 if s.strip()][-1]
    long_utterance(model, voc, cfg, long_text, hop)
    return launches


def long_utterance(model, voc, cfg, text, hop):
    """A decoder run at a realistic length: 8 frames per phoneme."""
    from forwardtacotron_tpu_torch import gen_forward
    from forwardtacotron_tpu_torch.models.wavernn import vocode
    ids = gen_forward.text_to_ids(text, cfg)
    x = torch.tensor([ids], device='cuda')
    xl = torch.tensor([len(ids)], device='cuda')
    max_t = ((8 * len(ids) + 1 + 255) // 256) * 256
    for _ in range(2):          # the first pass warms up cuDNN and caches
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        series = model.predict_series(x, x_len=xl)
        ev[1].record()
        dur = torch.full_like(series['dur'], 8.0)
        gen = model.generate_from_series(x, dur, series['pitch'],
                                         series['energy'], max_t, x_len=xl)
        ev[2].record()
        n = int(gen['mel_len'][0])
        mel = gen['mel_post'][0, :n].T.float().cpu().numpy()
        wav = vocode(voc, mel, pcm16=True)
        ev[3].record()
        ev[3].synchronize()
    rms = float(np.sqrt(np.mean(wav.astype(np.float64) ** 2)))
    check(bool(np.isfinite(mel).all()) and len(wav) == (n - 1) * hop
          and rms > 0, f'8 frames/phoneme: {len(ids)} ids, {n} frames '
                       f'(bucket {max_t}), {len(wav)} samples, rms {rms:.1f}')
    row = {'ids': len(ids), 'frames': n, 'bucket': max_t,
           'samples': len(wav),
           'series_ms': ev[0].elapsed_time(ev[1]),
           'decode_ms': ev[1].elapsed_time(ev[2]),
           'vocode_ms': ev[2].elapsed_time(ev[3]),
           'audio_s': len(wav) / cfg['dsp']['sample_rate']}
    log(f'  8 frames/phoneme stages: {row}')
    DETAILS['long_utterance'] = row

    # reference on a small input: float32 decode on the card (kernels)
    # against the CPU plain path, same weights, 4 frames per phoneme
    ids = ids[:24]
    x = torch.tensor([ids])
    d4 = torch.full((1, len(ids)), 4.0)
    zeros = torch.zeros((1, len(ids)))
    ref = model.cpu().generate_from_series(x, d4, zeros, zeros, 128,
                                           compute_dtype=torch.float32)
    model.cuda()
    got = model.generate_from_series(x.cuda(), d4.cuda(), zeros.cuda(),
                                     zeros.cuda(), 128,
                                     compute_dtype=torch.float32)
    err = float((got['mel_post'].cpu() - ref['mel_post'])[0, :96].abs().max())
    check(err < 1e-3, f'float32 decode, card vs CPU plain: max err '
                      f'{err:.2e} < 1e-3')
    DETAILS['decode_f32_vs_cpu_max_abs_err'] = err


# ----------------------------------------------------------- serving path

SERVING_DIR = Path('model_outputs/smoke_serving')   # random vocoder files
DEVICE = 'cuda'        # the device of the serving and the teacher phases


def _launch_counts():
    from forwardtacotron_tpu_torch.kernels.birnn import recurrence
    from forwardtacotron_tpu_torch.kernels.wavernn_sample import sample
    return {'birnn': recurrence.launches, 'wavernn_sample': sample.launches}


def _reset_counts():
    from forwardtacotron_tpu_torch.kernels.birnn import recurrence
    from forwardtacotron_tpu_torch.kernels.wavernn_sample import sample
    recurrence.launches = 0
    recurrence.path_launches = dict.fromkeys(recurrence.path_launches, 0)
    sample.launches = 0


def _gan_files(cfg, directory=None):
    """Seeded random generators at config.yaml's widths, written in the
    layouts users bring into `directory` (SERVING_DIR where None):
    HiFi-GAN V1 as the official {'generator': sd} with weight_g /
    weight_v and a config.json beside it, MelGAN as the hub's
    {'model_g': sd} (base width 512, rates 8, 8, 2, 2)."""
    from forwardtacotron_tpu_torch.models.hifigan import (
        HiFiGANGenerator, weight_norm_state_dict)
    from forwardtacotron_tpu_torch.models.melgan import MelGANGenerator
    directory = SERVING_DIR if directory is None else directory
    directory.mkdir(parents=True, exist_ok=True)
    model_cfg = cfg['hifigan']['model']
    n_mels = cfg['dsp']['num_mels']
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(11)
        hifi = HiFiGANGenerator.from_config(model_cfg, n_mels=n_mels)
        melgan = MelGANGenerator(n_mels=n_mels, base_channels=512)
    hifi_path = directory / 'g_00000000'
    torch.save({'generator': weight_norm_state_dict(hifi)}, hifi_path)
    (directory / 'config.json').write_text(json.dumps(
        {k: v for k, v in model_cfg.items() if k != 'generator_type'}))
    melgan_path = directory / 'melgan.pt'
    torch.save({'model_g': weight_norm_state_dict(melgan)}, melgan_path)
    return hifi_path.resolve(), melgan_path.resolve()


@contextlib.contextmanager
def _cwd(path):
    import os
    old = Path.cwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _cli_runs(lines, hifi_path, melgan_path, hop):
    """gen_forward.main with every vocoder on the three lines (a
    sentences.txt of its own in SERVING_DIR), each run's kernel launches
    counted from 0; the wavs' lengths checked."""
    from scipy.io import wavfile
    from forwardtacotron_tpu_torch import gen_forward
    (SERVING_DIR / 'sentences.txt').write_text('\n'.join(lines) + '\n')
    runs = {
        'griffinlim': (['griffinlim'], {'birnn'}),
        'hifigan': (['hifigan', '--voc_checkpoint', str(hifi_path)],
                    {'birnn'}),
        'melgan': (['melgan', '--voc_checkpoint', str(melgan_path)],
                   {'birnn'}),
        'wavernn --stream --stream_group 8': (
            ['wavernn', '--stream', '--stream_group', '8'],
            {'birnn', 'wavernn_sample'}),
        'wavernn --batched_utterances': (
            ['wavernn', '--batched_utterances'],
            {'birnn', 'wavernn_sample'}),
    }
    out = {}
    for name, (argv, kernels) in runs.items():
        with _cwd(SERVING_DIR):
            _reset_counts()
            t0 = time.perf_counter()
            paths = gen_forward.main(['--seed', '0', '--device', DEVICE]
                                     + argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _launch_counts()
            wavs = [wavfile.read(p)[1] for p in paths]
        ok = len(wavs) == len(lines) and all(
            w.dtype == np.int16 and len(w) > 0 and len(w) % hop == 0
            and np.abs(w).max() > 0 for w in wavs)
        check(ok and all(counts[k] > 0 for k in kernels),
              f'gen_forward {name}: {len(wavs)} int16 wavs '
              f'{[len(w) for w in wavs]} in {wall:.2f} s, launches {counts}')
        out[name] = {'wall_s': wall, 'launches': counts,
                     'samples': [len(w) for w in wavs]}
    return out


def _utterance_mel(model, cfg, text):
    """The 920-frame utterance of phase 5: 8 frames a phoneme."""
    from forwardtacotron_tpu_torch import gen_forward
    ids = gen_forward.text_to_ids(text, cfg)
    x = torch.tensor([ids], device=DEVICE)
    xl = torch.tensor([len(ids)], device=DEVICE)
    series = model.predict_series(x, x_len=xl)
    max_t = ((8 * len(ids) + 1 + 255) // 256) * 256
    gen = model.generate_from_series(x, torch.full_like(series['dur'], 8.0),
                                     series['pitch'], series['energy'],
                                     max_t, x_len=xl)
    n = int(gen['mel_len'][0])
    return gen['mel_post'][0, :n].T.float().cpu().numpy()


def _events_ms(fn, reps=2):
    fn()                                   # builds, allocator, cuDNN
    torch.cuda.synchronize()
    return cuda_ms(fn, reps=reps, warmup=0)


def _vocoder_latency(mel, dsp, voc, hifi, melgan, sr):
    """Each vocoder on the 920-frame utterance: ms (CUDA events around the
    call, host copy of the audio included) and RTF."""
    from forwardtacotron_tpu_torch.models.hifigan import vocode_hifigan
    from forwardtacotron_tpu_torch.models.melgan import vocode_melgan
    from forwardtacotron_tpu_torch.models.wavernn import vocode
    audio_s = (mel.shape[1] - 1) * dsp.hop_length / sr
    calls = {'griffinlim': lambda: dsp.griffinlim(mel),
             'hifigan_v1': lambda: vocode_hifigan(hifi, mel, pcm16=True),
             'melgan': lambda: vocode_melgan(melgan, mel, pcm16=True),
             'wavernn': lambda: vocode(voc, mel, pcm16=True)}
    rows = {}
    for name, fn in calls.items():
        ms = _events_ms(fn)
        rows[name] = {'ms': ms, 'rtf': ms / 1e3 / audio_s}
    log(f'  920-frame utterance ({mel.shape[1]} frames, {audio_s:.2f} s of '
        f'audio), vocode ms / RTF: ' + ', '.join(
            f'{k} {v["ms"]:.1f} / {v["rtf"]:.4f}' for k, v in rows.items()))
    return {'frames': mel.shape[1], 'audio_s': audio_s, **rows}


def _vocode_batch_checks(voc, mels):
    """vocode_batch greedy against per-utterance vocode on the three
    lines: float32 the same class at every sample (|d| < 1e-6: the
    crossfade and fade are the same arithmetic), bfloat16 the same class
    on > 95% (the existing greedy gate); then bf16 sampled timing, one
    batch against three calls, and 8 utterances of 920 frames."""
    from forwardtacotron_tpu_torch.kernels.wavernn_sample import sample
    from forwardtacotron_tpu_torch.models.wavernn import vocode, vocode_batch
    out = {}
    for dtype, name in ((torch.float32, 'f32'), (torch.bfloat16, 'bf16')):
        kw = dict(greedy=True, compute_dtype=dtype)
        before = sample.launches
        batch = vocode_batch(voc, mels, **kw)
        lanes_launches = sample.launches - before
        alone = [vocode(voc, m, **kw) for m in mels]
        agree = float(np.mean(np.concatenate(
            [np.abs(a - b) < 1e-6 for a, b in zip(batch, alone)])))
        ok = agree == 1.0 if dtype == torch.float32 else agree > 0.95
        check(ok and all(len(a) == len(b) for a, b in zip(batch, alone)),
              f'vocode_batch greedy {name} vs per-utterance vocode '
              f'({len(mels)} utterances, {lanes_launches} launches): '
              f'sample agreement {agree:.5f} '
              f'{"== 1" if dtype == torch.float32 else "> 0.95"}')
        out[f'greedy_{name}_agreement'] = agree
    out['batch_ms'] = _events_ms(lambda: vocode_batch(voc, mels, pcm16=True))
    out['per_utterance_ms'] = _events_ms(lambda: [
        vocode(voc, m, pcm16=True) for m in mels])
    log(f'  vocode_batch of the three lines: {out["batch_ms"]:.1f} ms, '
        f'three vocode calls {out["per_utterance_ms"]:.1f} ms')
    return out


def _griffinlim_vs_cpu(cfg, mel):
    """Griffin-Lim on the card against the CPU plain path, stage by stage,
    the same initial-phase draw. 32 momentum rounds on an NNLS magnitude
    (no consistent phase exists) amplify float32 rounding: on the CPU alone
    float32 and float64 end 2% of the peak apart on such a mel, and a
    1e-6 change of the input moves the float32 waveform as far. So the
    checks are: NNLS within 1e-3 of its largest value; one Griffin-Lim
    round from the same magnitude within 1e-3 of the peak; and after all
    32 rounds the objective they minimise, the spectral convergence
    || |STFT(y)| - S || / ||S||, within 1e-3 of the CPU's (relative;
    float32 rounding moved it by <= 2e-4 on the CPU). The waveforms'
    distance after 32 rounds is reported beside the CPU's own float32 /
    float64 distance."""
    from forwardtacotron_tpu_torch.dsp import griffinlim as gl
    from forwardtacotron_tpu_torch.dsp.audio import DSP
    from forwardtacotron_tpu_torch.dsp.stft import magnitude_stft
    dsp = DSP.from_config(cfg, 'cpu')
    n_fft, hop, win = dsp.n_fft, dsp.hop_length, dsp.win_length
    basis = torch.as_tensor(dsp.mel_basis)
    m = torch.as_tensor(mel.T.copy())
    lin = gl.nnls_mel_inverse(basis, torch.exp(m))
    lin_card = gl.nnls_mel_inverse(basis.to(DEVICE),
                                   torch.exp(m.to(DEVICE))).cpu()
    nnls_err = float((lin_card - lin).abs().max() / lin.abs().max())
    u = gl.initial_phase(lin.shape, 0)
    one = gl.griffinlim(lin, n_fft, hop, win, n_iter=1, uniform=u)
    one_card = gl.griffinlim(lin.to(DEVICE), n_fft, hop, win, n_iter=1,
                             uniform=u).cpu()
    one_err = float((one_card - one).abs().max() / one.abs().max())
    card = DSP.from_config(cfg, DEVICE).griffinlim(mel, seed=0)
    cpu = dsp.griffinlim(mel, seed=0)
    cpu64 = gl.mel_to_wav(m.double(), basis.double(), n_fft, hop, win,
                          uniform=u.double()).numpy()

    def spectral_convergence(y):
        mag = magnitude_stft(torch.as_tensor(y, dtype=torch.float32),
                             n_fft, hop, win)
        return float(torch.linalg.norm(mag - lin) / torch.linalg.norm(lin))
    sc_card, sc_cpu = spectral_convergence(card), spectral_convergence(cpu)
    out = {'nnls_rel_err': nnls_err, 'one_round_rel_err': one_err,
           'sc_card': sc_card, 'sc_cpu': sc_cpu,
           'max_abs_err_32': float(np.abs(card - cpu).max()),
           'cpu_f32_vs_f64_32': float(np.abs(cpu - cpu64).max()),
           'peak': float(np.abs(cpu).max())}
    check(card.shape == cpu.shape and bool(np.isfinite(card).all())
          and nnls_err <= 1e-3 and one_err <= 1e-3
          and abs(sc_card - sc_cpu) <= 1e-3 * sc_cpu,
          f'Griffin-Lim card vs CPU, same draw: NNLS {nnls_err:.2e} <= 1e-3, '
          f'one round {one_err:.2e} <= 1e-3 of the peak, spectral '
          f'convergence after 32 {sc_card:.5f} vs {sc_cpu:.5f} (<= 1e-3 '
          f'apart); waveforms {out["max_abs_err_32"]:.3g} apart at peak '
          f'{out["peak"]:.3g} (CPU float32 vs float64: '
          f'{out["cpu_f32_vs_f64_32"]:.3g})')
    return out


def _serve(srv, lines, hop, offset):
    """8 concurrent requests from threads, mixed alpha / pitch_scale: every
    future int16, finite, and as long as its decoded mel says (recorded
    around the server's vocoder call)."""
    import threading
    frames, lock = {}, threading.Lock()
    vocode_fn = srv._vocode

    def recording(mels):
        wavs = vocode_fn(mels)
        with lock:
            for m, w in zip(mels, wavs):
                frames[id(w)] = m.shape[1]
        return wavs
    srv._vocode = recording
    srv.batch_sizes.clear()
    results = [None] * 8
    alphas = (1.0, 1.2, 0.9, 1.1, 1.0, 0.8, 1.3, 1.0)
    pitches = (1.0, 0.9, 1.1, 1.0, 1.2, 1.0, 0.8, 1.05)

    def client(i):
        results[i] = srv.synthesize(lines[i % len(lines)], alpha=alphas[i],
                                    pitch_scale=pitches[i], timeout=300)
    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    srv._vocode = vocode_fn
    ok = all(r is not None and r.dtype == np.int16 and len(r) > 0
             and len(r) == (frames[id(r)] - offset) * hop for r in results)
    audio_s = sum(len(r) for r in results if r is not None) / srv.sample_rate
    return ok, wall, audio_s


def _http_round_trip(srv, text):
    """/healthz, /tts and /tts_stream on 127.0.0.1 (a free port); the time
    to the first streamed chunk (status line and header chunk, sent after
    the first sentence is synthesized)."""
    import http.client
    import threading
    from forwardtacotron_tpu_torch.serving import make_http_server
    httpd = make_http_server(srv, '127.0.0.1', 0)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    out = {}
    try:
        conn = http.client.HTTPConnection('127.0.0.1', port, timeout=300)
        conn.request('GET', '/healthz')
        r = conn.getresponse()
        healthz = (r.status, r.read())
        conn.request('POST', '/tts', body=json.dumps({'text': text}))
        r = conn.getresponse()
        body = r.read()
        tts_ok = r.status == 200 and body[:4] == b'RIFF' and len(body) > 44
        conn.close()
        conn = http.client.HTTPConnection('127.0.0.1', port, timeout=300)
        t0 = time.perf_counter()
        conn.request('POST', '/tts_stream', body=json.dumps(
            {'text': text + ' ' + text}))
        r = conn.getresponse()
        first = r.read(44)
        out['first_chunk_ms'] = (time.perf_counter() - t0) * 1e3
        rest = r.read()
        out['stream_ms'] = (time.perf_counter() - t0) * 1e3
        stream_ok = (r.status == 200 and first[:4] == b'RIFF'
                     and r.headers.get('Transfer-Encoding') == 'chunked'
                     and len(rest) > 0)
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    check(healthz == (200, b'ok') and tts_ok and stream_ok,
          f'HTTP: /healthz {healthz}, /tts RIFF {tts_ok} ({len(body)} B), '
          f'/tts_stream chunked {stream_ok}, first chunk '
          f'{out["first_chunk_ms"]:.1f} ms, whole stream '
          f'{out["stream_ms"]:.1f} ms')
    return out


def _server_runs(lines, hifi_path, hop):
    """TTSServer on the card with WaveRNN and with HiFi-GAN: warm-up of
    the batch buckets 1, 2, 4, 8 (kernel #1's path recorded for each),
    two rounds of 8 concurrent requests (the first meets the vocoders'
    frame buckets for the first time), the second round's stats; the
    HTTP front on the HiFi-GAN one."""
    from forwardtacotron_tpu_torch.serving import TTSServer
    out = {}
    for vocoder, voc_ckpt, offset in (('wavernn', None, 1),
                                      ('hifigan', str(hifi_path), 0)):
        with TTSServer(None, vocoder=vocoder, voc_checkpoint=voc_ckpt,
                       max_batch=8, max_wait_ms=20.0,
                       device=DEVICE) as srv:
            warm = srv.warmup(batch_sizes=[1, 2, 4, 8])
            row = {'warmup_s': warm['seconds']}
            for rnd in ('first', 'second'):
                _reset_counts()
                before = srv.stats()['completed']
                with srv._stats_lock:           # this round's latencies
                    srv._latency_window.clear()
                ok, wall, audio_s = _serve(srv, lines, hop, offset)
                counts = _launch_counts()
                stats = srv.stats()
                need = {'birnn', 'wavernn_sample'} \
                    if vocoder == 'wavernn' else {'birnn'}
                check(ok and stats['completed'] - before == 8
                      and all(counts[k] > 0 for k in need),
                      f'TTSServer {vocoder}, {rnd} round: 8 concurrent '
                      f'requests, int16 of the decoded lengths, in '
                      f'{wall:.3f} s ({audio_s:.2f} s of audio), batches '
                      f'{list(srv.batch_sizes)}, launches {counts}')
                row[rnd] = {'wall_s': wall, 'audio_s': audio_s,
                            'audio_s_per_s': audio_s / wall,
                            'batch_sizes': list(srv.batch_sizes),
                            'latency_s': stats['latency_s'],
                            'launches': counts}
                log(f'  TTSServer {vocoder} {rnd}: {row[rnd]}')
            row['birnn_paths'] = srv.stats()['birnn_paths']
            if vocoder == 'hifigan':
                row['http'] = _http_round_trip(srv, lines[0])
            out[vocoder] = row
    paths = out['wavernn']['birnn_paths']
    check(sorted(paths) == ['1', '2', '4', '8'],
          f'kernel #1 at every batch bucket, by path: {paths}')
    return out


@phase('serving path (full width)')
def serving_path():
    from forwardtacotron_tpu_torch import gen_forward
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.dsp.audio import DSP
    from forwardtacotron_tpu_torch.models.hifigan import load_hifigan
    from forwardtacotron_tpu_torch.models.melgan import load_melgan
    from forwardtacotron_tpu_torch.models.wavernn import vocode_batch
    all_lines = [s for s in Path('sentences.txt').read_text().splitlines()
                 if s.strip()]
    lines = all_lines[:3]
    cfg = default_config()
    hop = cfg['dsp']['hop_length']
    shutil.rmtree(SERVING_DIR, ignore_errors=True)
    try:
        hifi_path, melgan_path = _gan_files(cfg)
        out = {'cli': _cli_runs(lines, hifi_path, melgan_path, hop)}
        model, cfg, _ = gen_forward.load_tts(None, cfg, DEVICE, 0)
        voc, _ = gen_forward.load_voc(None, cfg, DEVICE, 0)
        dsp = DSP.from_config(cfg, DEVICE)
        hifi = load_hifigan(hifi_path, device=DEVICE)
        melgan = load_melgan(melgan_path, device=DEVICE)
        long_mel = _utterance_mel(model, cfg, all_lines[-1])
        out['utterance'] = _vocoder_latency(long_mel, dsp, voc, hifi, melgan,
                                            cfg['dsp']['sample_rate'])
        mels = [gen_forward.synthesize(model, gen_forward.text_to_ids(t, cfg))
                for t in lines]
        out['vocode_batch'] = _vocode_batch_checks(voc, mels)
        out['vocode_batch']['8x920_ms'] = _events_ms(
            lambda: vocode_batch(voc, [long_mel] * 8, pcm16=True), reps=1)
        log(f'  vocode_batch of 8 x {long_mel.shape[1]} frames: '
            f'{out["vocode_batch"]["8x920_ms"]:.1f} ms')
        out['griffinlim_vs_cpu'] = _griffinlim_vs_cpu(cfg, mels[0])
        out['server'] = _server_runs(all_lines, hifi_path, hop)
    finally:
        shutil.rmtree(SERVING_DIR, ignore_errors=True)
    DETAILS['serving_path'] = out
    return out


# -------------------------------------------------------- BiRNN training

# The training step's six BiRNNs at batch 32, as (name, cell, T, H, lengths):
# the decoder LSTM and postnet GRU at the 1024-frame bucket, the prenet and
# predictor GRUs at 192 phonemes (ragged but for the postnet); also timed
# by tools/torch_kernel_probe.py
TRAIN_KERNEL_CASES = (
    ('decoder', 'lstm', 1024, 512, [1024 - 21 * i for i in range(32)]),
    ('postnet', 'gru', 1024, 256, [1024] * 32),
    ('prenet', 'gru', 192, 256, [192 - 5 * i for i in range(32)]),
    ('pitch', 'gru', 192, 128, [192 - 5 * i for i in range(32)]),
    ('dur/energy', 'gru', 192, 64, [192 - 5 * i for i in range(32)]))


# the Tacotron teacher's CBHG BiGRUs in training (H=128, two streams), as
# (name, cell, T, H, B, lengths): the postnet over up to max_mel_len = 1250
# frames at r=5 (batch 32) and at r=1 (batch 8), the encoder over ~200
# phonemes at batch 32
TEACHER_TRAIN_KERNEL_CASES = (
    ('teacher postnet r=5', 'gru', 1250, 128, 32,
     [1250 - 13 * i for i in range(32)]),
    ('teacher postnet r=1', 'gru', 1250, 128, 8,
     [1250 - 37 * i for i in range(8)]),
    ('teacher encoder', 'gru', 200, 128, 32, [200 - 3 * i for i in range(32)]))


# WaveRNN's two GRUs in training, one stream each, as (name, cell, T, H,
# B, lengths): seq_len 1280 at batch 32 (config.yaml vocoder.training)
VOCODER_TRAIN_KERNEL_CASES = (
    ('wavernn GRU', 'gru', 1280, 512, 32, [1280] * 32),)


def _train_inputs(cell, T, B, H, lens, seed, S=2):
    g = torch.Generator().manual_seed(seed)
    ng = 4 if cell == 'lstm' else 3
    bound = 1.0 / math.sqrt(H)
    gi = torch.randn((T, B, S, ng * H), generator=g) * 0.5
    w = (torch.rand((S, ng * H, H), generator=g) * 2 - 1) * bound
    b = torch.zeros((S, ng * H)) if cell == 'lstm' else \
        (torch.rand((S, ng * H), generator=g) * 2 - 1) * bound
    dy = torch.randn((T, B, S, H), generator=g)
    lengths = torch.tensor(lens, dtype=torch.int32)
    return [t.cuda().contiguous() for t in (gi, w, b, lengths, dy)]


def _cudnn_train_ms(cell, T, H, B, S=2, dtype=torch.float32):
    """cuDNN nn.LSTM/nn.GRU over (B, T, H) inputs in `dtype`,
    bidirectional for two streams and one-way for one, forward with grad
    and backward timed apart (input projection included): a yardstick
    only, never called by the port."""
    mod = (torch.nn.LSTM if cell == 'lstm' else torch.nn.GRU)(
        H, H, batch_first=True, bidirectional=S == 2).cuda().to(dtype)
    mod.flatten_parameters()
    x = torch.randn((B, T, H), device='cuda', dtype=dtype,
                    requires_grad=True)
    fwd = cuda_ms(lambda: mod(x), reps=5)
    y = mod(x)[0]
    dy = torch.randn_like(y)
    bwd = cuda_ms(lambda: torch.autograd.grad(
        y, [x] + list(mod.parameters()), dy, retain_graph=True), reps=5)
    return fwd, bwd


def _train_kernel_row(cell, T, H, B, lens, S, name):
    """Kernels #2 and #3 against their plain versions on the inputs of
    `_train_inputs`, in float32 and bfloat16, on the planned paths (#3
    over the planned forward's stash), and on the cooperative paths forced
    on the same inputs where another is planned: the row with its paths,
    errors and inputs."""
    from forwardtacotron_tpu_torch.kernels import birnn_train as bt
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        train_backward, train_forward)
    from forwardtacotron_tpu_torch.ops.rnn import (birnn_train_backward,
                                                   birnn_train_forward)
    f32, bf16 = torch.float32, torch.bfloat16
    props = torch.cuda.get_device_properties(0)
    # bfloat16 limits. The stash, dgi and dgh are stored in bfloat16, so
    # kernel and plain may round an element one ulp apart: at most 2^-7
    # of the largest plain value; y is stored in float32: 2e-3 of the
    # largest. Both bf16 and y: relative L2 error at most 2^-8 (below a
    # one-ulp flip of every element).
    bf16_rel = {'y': 2e-3, 'stash': 2.0 ** -7, 'dgi': 2.0 ** -7,
                'dgh': 2.0 ** -7}
    gi, w, b, ln, dy = _train_inputs(cell, T, B, H, lens, seed=H + T, S=S)
    row = {'case': f'{name} {cell} H={H} T={T} B={B}'
                   + (f' S={S}' if S != 2 else ''), 'errors': {}}
    for dtype in (f32, bf16):
        key = str(dtype)[6:]
        for sfx, plan in (('', bt.train_forward_plan),
                          ('bwd_', bt.train_backward_plan)):
            row[f'{sfx}path' + ('' if dtype == f32 else f'_{key}')] = plan(
                cell, S, B, H, dtype, props.shared_memory_per_block_optin,
                props.multi_processor_count)['path']
        gi_d, w_d = gi.to(dtype), w.to(dtype)
        y, st = train_forward(cell, gi_d, w_d, b, ln, dtype)
        dgi, dgh = train_backward(cell, st, dy, w_d, ln, dtype)
        # (label, output, tensor); where the batch-split backward is
        # planned, the cooperative one forced on the same stash too
        outs = [(k, k, v) for k, v in (('y', y), ('stash', st),
                                       ('dgi', dgi), ('dgh', dgh))]
        if row['path' + ('' if dtype == f32 else f'_{key}')] \
                != 'cooperative':
            y_c, st_c = train_forward(cell, gi_d, w_d, b, ln, dtype,
                                      path='cooperative')
            outs += [('y cooperative', 'y', y_c),
                     ('stash cooperative', 'stash', st_c)]
        if row['bwd_path' + ('' if dtype == f32 else f'_{key}')] \
                != 'cooperative':
            dgi_c, dgh_c = train_backward(cell, st, dy, w_d, ln, dtype,
                                          path='cooperative')
            outs += [('dgi cooperative', 'dgi', dgi_c),
                     ('dgh cooperative', 'dgh', dgh_c)]
        torch.cuda.synchronize()
        y_p, st_p = birnn_train_forward(cell, gi_d, w_d, b, ln, dtype)
        dgi_p, dgh_p = birnn_train_backward(cell, st, dy, w_d, ln, dtype)
        ref_of = {'y': y_p, 'stash': st_p, 'dgi': dgi_p, 'dgh': dgh_p}
        for what, kind, got in outs:
            ref = ref_of[kind]
            diff = got.float() - ref.float()
            err = float(diff.abs().max())
            rel_l2 = float(diff.norm() / ref.float().norm())
            if dtype == f32:
                limit, l2_limit = 1e-4, math.inf
            else:
                limit = bf16_rel[kind] * float(ref.float().abs().max())
                l2_limit = 2.0 ** -8
            ok = err <= limit and rel_l2 <= l2_limit \
                and bool(torch.isfinite(got).all())
            check(ok, f'{row["case"]} {key} {what}: max|kernel-plain| '
                      f'{err:.3g} <= {limit:.3g}, relative L2 '
                      f'{rel_l2:.3g} <= {l2_limit:.3g}')
            row['errors'][f'{key} {what}'] = err
            row['errors'][f'{key} {what} rel_l2'] = rel_l2
    return row, (gi, w, b, ln, dy)


# the micro-batches that grad_accum k gives kernels #2/#3, checked against
# the plain versions in float32 and bfloat16 as (name, cell, T, H, B,
# lengths): the student's five at k = 2 and 4 (B = 16, 8) and the teacher's
# r=1 postnet at k = 2 (B = 4), each the batch's last micro-batch (its
# shortest lanes; no lane reaches T)
MICRO_TRAIN_KERNEL_CASES = tuple(
    (f'{n} grad_accum {k}', c, T, H, 32 // k, ln[-(32 // k):])
    for n, c, T, H, ln in TRAIN_KERNEL_CASES for k in (2, 4)) + tuple(
    (f'{n} grad_accum 2', c, T, H, B // 2, ln[-(B // 2):])
    for n, c, T, H, B, ln in TEACHER_TRAIN_KERNEL_CASES if B == 8)


def _faster_than_cooperative(row, sfx=''):
    """Where the cluster forward is planned, it measured faster than the
    cooperative forward forced on the same inputs (the plan takes it only
    there)."""
    if row['path' + sfx] == 'cluster':
        ms, coop = row['ms_fwd' + sfx], row['ms_fwd_cooperative' + sfx]
        check(ms < coop, f'{row["case"]}{sfx.replace("_", " ")}: the '
                         f'planned cluster forward {ms:.3f} ms < the '
                         f'cooperative forward {coop:.3f} ms')


@phase('BiRNN training kernels vs plain')
def train_kernel_cases():
    """Kernels #2 and #3 against their plain versions (`_train_kernel_row`)
    at the training paths' shapes, timed beside their plain versions, their
    float32 bound and cuDNN, and in bfloat16 (`_train_kernel_bf16_times`);
    and at grad_accum's micro-batches (MICRO_TRAIN_KERNEL_CASES), checked,
    and timed where the cluster forward is planned. Wherever it is planned,
    it must have measured faster than the cooperative forward."""
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        train_backward, train_forward)
    from forwardtacotron_tpu_torch.ops.rnn import (birnn_train_backward,
                                                   birnn_train_forward)
    f32 = torch.float32
    rows = []
    for name, cell, T, H, B, lens, S in (
            [(n, c, T, H, 32, ln, 2) for n, c, T, H, ln in
             TRAIN_KERNEL_CASES]
            + [c + (2,) for c in TEACHER_TRAIN_KERNEL_CASES]
            + [c + (1,) for c in VOCODER_TRAIN_KERNEL_CASES]):
        row, (gi, w, b, ln, dy) = _train_kernel_row(cell, T, H, B, lens, S,
                                                    name)
        for sfx, parts in (('fwd', ('y', 'stash')), ('bwd', ('dgi', 'dgh'))):
            row[f'max_abs_err_{sfx}'] = max(row['errors'][f'float32 {p}']
                                            for p in parts)
        if row['path'] != 'cooperative':
            row['max_abs_err_fwd_cooperative'] = max(
                row['errors'][f'float32 {p} cooperative']
                for p in ('y', 'stash'))
        if row['bwd_path'] != 'cooperative':
            row['max_abs_err_bwd_cooperative'] = max(
                row['errors'][f'float32 {p} cooperative']
                for p in ('dgi', 'dgh'))
        st32 = train_forward(cell, gi, w, b, ln, f32)[1]
        row['ms_fwd'] = cuda_ms(lambda: train_forward(cell, gi, w, b, ln, f32),
                                reps=5)
        if row['path'] != 'cooperative':
            row['ms_fwd_cooperative'] = cuda_ms(lambda: train_forward(
                cell, gi, w, b, ln, f32, path='cooperative'), reps=5)
        _faster_than_cooperative(row)
        row['ms_bwd'] = cuda_ms(lambda: train_backward(cell, st32, dy, w, ln,
                                                       f32), reps=5)
        if row['bwd_path'] != 'cooperative':
            row['ms_bwd_cooperative'] = cuda_ms(lambda: train_backward(
                cell, st32, dy, w, ln, f32, path='cooperative'), reps=5)
        row['plain_ms_fwd'] = cuda_ms(lambda: birnn_train_forward(
            cell, gi, w, b, ln, f32), reps=1, warmup=0)
        row['plain_ms_bwd'] = cuda_ms(lambda: birnn_train_backward(
            cell, st32, dy, w, ln, f32), reps=1, warmup=0)
        ng = 4 if cell == 'lstm' else 3
        active = S * sum(min(n, T) for n in lens)
        flops = 2.0 * active * ng * H * H
        small = (w.numel() + b.numel() + ln.numel()) * 4
        fwd_bytes = (gi.numel() + B * T * S * H * (1 + 5)) * 4 + small
        bwd_bytes = (st32.numel() + dy.numel()
                     + (1 if cell == 'lstm' else 2) * gi.numel()) * 4 + small
        row['bound_ms_fwd'], row['bound_by_fwd'] = bound_ms(fwd_bytes, flops,
                                                            f32)
        row['bound_ms_bwd'], row['bound_by_bwd'] = bound_ms(bwd_bytes, flops,
                                                            f32)
        row['library_ms_fwd'], row['library_ms_bwd'] = _cudnn_train_ms(
            cell, T, H, B, S)
        log(f'  {row["case"]} float32: fwd {row["ms_fwd"]:.3f} ms on the '
            f'{row["path"]} path (cooperative path '
            f'{row.get("ms_fwd_cooperative", row["ms_fwd"]):.3f}; plain '
            f'{row["plain_ms_fwd"]:.0f}, bound {row["bound_ms_fwd"]:.4f} '
            f'{row["bound_by_fwd"]}, cuDNN {row["library_ms_fwd"]:.3f}); '
            f'bwd {row["ms_bwd"]:.3f} ms on the {row["bwd_path"]} path '
            f'(cooperative path '
            f'{row.get("ms_bwd_cooperative", row["ms_bwd"]):.3f}; plain '
            f'{row["plain_ms_bwd"]:.0f}, bound {row["bound_ms_bwd"]:.4f} '
            f'{row["bound_by_bwd"]}, cuDNN {row["library_ms_bwd"]:.3f})')
        rows.append(row)
    DETAILS['birnn_train'] = rows
    bf16_rows = _train_kernel_bf16_times(nvidia_smi_line())
    DETAILS['birnn_train_bf16'] = bf16_rows
    micro = []
    for name, cell, T, H, B, lens in MICRO_TRAIN_KERNEL_CASES:
        row = _train_kernel_row(cell, T, H, B, lens, 2, name)[0]
        for dtype in (f32, torch.bfloat16):
            sfx = '' if dtype == f32 else '_bfloat16'
            if row['path' + sfx] != 'cluster':
                continue
            gi, w, b, ln, _ = _train_inputs(cell, T, B, H, lens, H + T)
            gi, w = gi.to(dtype), w.to(dtype)
            for key, path in (('ms_fwd', None),
                              ('ms_fwd_cooperative', 'cooperative')):
                row[key + sfx] = cuda_ms(lambda: train_forward(
                    cell, gi, w, b, ln, dtype, path=path), reps=3)
            _faster_than_cooperative(row, sfx)
        log(f'  {row["case"]}: checked in float32 and bfloat16, fwd on the '
            f'{row["path"]} / {row["path_bfloat16"]} path, bwd on the '
            f'{row["bwd_path"]} / {row["bwd_path_bfloat16"]} path'
            + ''.join(f'; {k} {v:.3f}' for k, v in row.items()
                      if k.startswith('ms_fwd')))
        micro.append(row)
    DETAILS['birnn_train_micro'] = micro
    return rows, bf16_rows


def _write_dataset(data, n_train=96, n_val=32, seed=0):
    """LJSpeech-like synthetic items: 60-170 phonemes, 520-870 mel frames
    (buckets 640/768/896), durations of at least one frame summing to the
    mel length; written with the port's tokenizer alphabet and pickle."""
    from forwardtacotron_tpu_torch.text.symbols import phonemes
    from forwardtacotron_tpu_torch.utils.files import pickle_binary
    rng = np.random.RandomState(seed)
    for d in ('mel', 'alg', 'phon_pitch', 'phon_energy'):
        (data / d).mkdir(parents=True, exist_ok=True)
    index, text_dict = [], {}
    for i in range(n_train + n_val):
        n = int(rng.randint(60, 171))
        frames = int(rng.randint(520, 871))
        dur = rng.multinomial(frames - n, np.full(n, 1.0 / n)) + 1
        item = f'smoke_{i:03d}'
        np.save(data / 'mel' / f'{item}.npy',
                (rng.randn(80, frames) * 2 - 5).astype(np.float32))
        np.save(data / 'alg' / f'{item}.npy', dur.astype(np.int32))
        np.save(data / 'phon_pitch' / f'{item}.npy',
                rng.randn(n).astype(np.float32))
        np.save(data / 'phon_energy' / f'{item}.npy',
                rng.randn(n).astype(np.float32))
        text_dict[item] = ''.join(rng.choice(phonemes[1:], n))
        index.append((item, frames))
    pickle_binary(text_dict, data / 'text_dict.pkl')
    pickle_binary(index[:n_train], data / 'train_dataset.pkl')
    pickle_binary(index[n_train:], data / 'val_dataset.pkl')
    pickle_binary({k: (1.0, 1.0) for k, _ in index},
                  data / 'att_score_dict.pkl')


class _Scalars:
    """The trainer's optional writer: keeps every scalar."""

    def __init__(self):
        self.values = []

    def add_scalar(self, tag, value, step):
        self.values.append((tag, float(value), int(step)))


@phase('training path (full width)')
def training_path():
    from forwardtacotron_tpu_torch import gen_forward
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.data.dataset import get_tts_datasets
    from forwardtacotron_tpu_torch.kernels.birnn import recurrence
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        train_backward, train_forward)
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.forward_trainer import (
        ForwardTrainer)
    from forwardtacotron_tpu_torch.utils.paths import Paths
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    try:
        cfg = default_config()
        cfg['data_path'] = str(TRAIN_DIR / 'data')
        _write_dataset(TRAIN_DIR / 'data')
        paths = Paths(cfg['data_path'], 'smoke_tts', base=TRAIN_DIR)
        writer = _Scalars()
        trainer = ForwardTrainer(paths, cfg, 'cuda', writer=writer)
        torch.manual_seed(0)
        model = ForwardTacotron.from_config(cfg).cuda()
        optimizer = tc.make_optimizer(model)
        before = copy.deepcopy(model.state_dict())

        recurrence.launches = 0
        train_forward.launches = 0
        train_forward.path_launches = dict.fromkeys(
            train_forward.path_launches, 0)
        train_backward.launches = 0
        train_backward.path_launches = dict.fromkeys(
            train_backward.path_launches, 0)
        t0 = time.perf_counter()
        step = trainer.train(model, optimizer, max_steps_override=6)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {'birnn': recurrence.launches,
                    'birnn_train_fwd': train_forward.launches,
                    'birnn_train_bwd': train_backward.launches,
                    **{f'birnn_train_fwd_{k}': v for k, v in
                       train_forward.path_launches.items()},
                    **{f'birnn_train_bwd_{k}': v for k, v in
                       train_backward.path_launches.items()}}
        log(f'  6 steps at batch 32 in {wall:.1f} s (host clock, first '
            f'steps included), launches {launches}')
        check(step == 6, f'trainer reached step {step} == 6')
        check(launches['birnn_train_fwd'] > 0
              and launches['birnn_train_bwd'] > 0,
              f'training launched kernels #2 and #3: {launches}')
        # per step each of the six recurrences on its planned paths (float32,
        # batch 32): the predictor BiGRUs batch-split, the prenet and
        # postnet GRUs on the cluster forward, the decoder LSTM cooperative
        want = _planned_launches(_student_shapes(cfg), 32, torch.float32,
                                 step, step)
        got = {k: launches[k] for k in want}
        check(got == want and want['birnn_train_fwd_cluster'] > 0,
              f'kernels #2/#3 by path in {step} steps: {got} == planned '
              f'{want}')
        losses = [v for tag, v, _ in writer.values if 'Loss' in tag]
        check(len(losses) > 0 and all(math.isfinite(v) for v in losses),
              f'{len(losses)} loss scalars, all finite')
        moved = [k for k, p in model.named_parameters()
                 if not torch.equal(p.detach(), before[k])]
        n_params = len(list(model.parameters()))
        check(len(moved) == n_params,
              f'{len(moved)} of {n_params} parameters moved')

        _, val_set = get_tts_datasets(cfg['data_path'], 32, 1, None)
        recurrence.launches = 0
        recurrence.path_launches = dict.fromkeys(recurrence.path_launches,
                                                 0)
        n_train = (train_forward.launches, train_backward.launches)
        val = trainer.evaluate(model, val_set)
        check(recurrence.launches > 0 and n_train == (
            train_forward.launches, train_backward.launches)
            and all(math.isfinite(v) for v in val.values()),
            f'evaluate(): {val}, kernel #1 launches {recurrence.launches}')
        launches['evaluate_birnn'] = recurrence.launches
        for k, v in recurrence.path_launches.items():
            launches[f'evaluate_birnn_{k}'] = v
        # batch 32, float32: every recurrence on the stream-local path,
        # the decoder's and CBHG's 64 clusters in waves
        check(recurrence.path_launches['stream_local']
              == recurrence.launches > 0,
              f'evaluate(): kernel #1 by path {recurrence.path_launches}')

        latest = paths.forward_checkpoints / 'latest_model.pt'
        served, _, served_step = gen_forward.load_tts(str(latest), cfg,
                                                      'cuda')
        mel = gen_forward.synthesize(served, gen_forward.text_to_ids(
            'Training on the card works.', cfg))
        check(served_step == 6 and bool(np.isfinite(mel).all())
              and mel.shape[0] == 80,
              f'gen_forward served latest_model.pt (step {served_step}): '
              f'mel {mel.shape}')

        timing = _student_step_timing(model, optimizer, trainer,
                                      val_set, nvidia_smi_line())
        grads = _grads_vs_cpu(model)
        DETAILS['training'] = {'launches': launches, 'wall_s': wall,
                               'val': val, 'step_ms': timing,
                               'grads_vs_cpu': grads}
        return launches
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)


def _student_parts(model, optimizer, batch, train_cfg, ema=None):
    """`train_parts` of `train/common.py:train_step`: the zoned-out batch
    (from a generator seeded 0) and the student's micro-batch loss."""
    from forwardtacotron_tpu_torch.train import common as tc
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    return train_parts(
        model, optimizer, tc.forward_micro_loss(model, train_cfg, gen),
        batch,
        train_cfg, ema,
        prepare=lambda b: tc.forward_step_batch(b, gen, train_cfg))


def _student_step_timing(model, optimizer, trainer, val_set, smi):
    """The student's step at batch 32 on one batch of the 768-frame
    bucket (`step_timing`)."""
    from forwardtacotron_tpu_torch.train.forward_trainer import (
        batch_to_device)
    cfg = trainer.train_cfg
    batch = next(b for b in val_set if b['mel'].shape[1] == 768)
    batch = batch_to_device(batch, 'cuda')
    out = step_timing(_student_parts(model, optimizer, batch, cfg),
                      'student step at batch 32, 768 frames', smi)
    out['batch'] = list(batch['mel'].shape)
    return out


def _grads_batch(seed=3):
    """Two short teacher-forced items (24 and 17 phonemes, 100 and 70
    frames) made from `seed`."""
    rng = np.random.RandomState(seed)
    x_len, frames = np.array([24, 17]), np.array([100, 70])
    x = np.zeros((2, 24), np.int64)
    dur = np.zeros((2, 24), np.float32)
    for i in range(2):
        x[i, :x_len[i]] = rng.randint(1, 60, x_len[i])
        dur[i, :x_len[i]] = rng.multinomial(frames[i] - x_len[i],
                                            np.full(x_len[i], 1 / x_len[i])) + 1
    mel = (rng.randn(2, 104, 80) * 2 - 5).astype(np.float32)
    return {'x': x, 'x_len': x_len, 'mel': mel, 'mel_len': frames,
            'dur': dur, 'pitch': rng.randn(2, 24).astype(np.float32),
            'energy': rng.randn(2, 24).astype(np.float32)}


class _Decisions:
    """A stand-in for `torch.nn.functional` inside models/layers.py that
    records the discrete decisions of a pass, or replays recorded ones:
    the sign mask of every `F.relu` (BatchNormConv, HighwayNetwork) and the
    argmax indices of every `F.max_pool1d` (CBHG), in call order.
    Recording returns what the functions return; replaying computes
    relu(x) as where(mask, x, 0) and the max-pool as a gather by index, so
    both passes take the same branches and their gradients flow through
    the same elements, and counts the decisions the replaying pass would
    have taken otherwise (`differ` of `total`). Every other name is
    torch.nn.functional's."""

    def __init__(self, recorded=None):
        self.replay = recorded is not None
        self.recorded = [] if recorded is None else recorded
        self.calls = self.differ = self.total = 0

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    def _take(self, own):
        """The recorded decision in place of `own` (replay), or `own`."""
        if not self.replay:
            self.recorded.append(own.cpu())
            return own
        saved = self.recorded[self.calls].to(own.device)
        self.calls += 1
        self.differ += int((saved != own).sum())
        self.total += own.numel()
        return saved

    def relu(self, x):
        mask = self._take(x > 0)
        if not self.replay:
            return torch.nn.functional.relu(x)
        return torch.where(mask, x, torch.zeros_like(x))

    def max_pool1d(self, x, kernel_size, stride=None, padding=0):
        y, idx = torch.nn.functional.max_pool1d(
            x, kernel_size, stride=stride, padding=padding,
            return_indices=True)
        idx = self._take(idx)
        return y if not self.replay else x.gather(-1, idx)


@contextlib.contextmanager
def _layer_decisions(decisions):
    """models/layers.py's, models/tacotron.py's and models/fast_pitch.py's
    `F` is `decisions` inside the block (nothing outside those modules sees
    it)."""
    from forwardtacotron_tpu_torch.models import fast_pitch, layers, tacotron
    saved = layers.F, tacotron.F, fast_pitch.F
    layers.F = tacotron.F = fast_pitch.F = decisions
    try:
        yield decisions
    finally:
        layers.F, tacotron.F, fast_pitch.F = saved


def _model_grads(model, batch, device, decisions=None):
    """{parameter: float32 gradient on the CPU} of the training loss of a
    copy of `model` on `device` (train mode, dropout 0); with
    `decisions` (a _Decisions), models/layers.py records or replays its
    ReLU and max-pool decisions through it."""
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.train import common as tc
    cfg = default_config()['forward_tacotron']['training']
    m = copy.deepcopy(model).to(device).train()
    for mod in m.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0
    b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    with (_layer_decisions(decisions) if decisions is not None
          else contextlib.nullcontext()):
        loss, _ = tc.forward_loss(m(b), b, b['pitch'], b['energy'], cfg)
    loss.backward()
    return {k: p.grad.detach().cpu() for k, p in m.named_parameters()}


def _grad_errors(got, ref):
    """Per parameter: ||got - ref|| / ||ref|| and max |got - ref| /
    max |ref|."""
    l2 = {k: float((got[k] - g).norm()) / max(float(g.norm()), 1e-12)
          for k, g in ref.items()}
    peak = {k: float((got[k] - g).abs().max()) / max(
        float(g.abs().max()), 1e-12) for k, g in ref.items()}
    return l2, peak


GRAD_L2_LIMIT, GRAD_MAX_LIMIT = 1e-3, 5e-3


def _worst_grad_errors(got, ref):
    l2, peak = _grad_errors(got, ref)
    k2, kp = max(l2, key=l2.get), max(peak, key=peak.get)
    return {'worst_rel_l2': l2[k2], 'param_l2': k2,
            'worst_rel_max': peak[kp], 'param_max': kp,
            'ok': l2[k2] <= GRAD_L2_LIMIT and peak[kp] <= GRAD_MAX_LIMIT}


def _card_cpu_grads(model, batch, model_grads=None):
    """The card's gradients (kernels #2/#3), recording the model's
    decisions, against the CPU's (plain versions) with those decisions
    replayed and with its own: {'replay': errors, 'own': errors,
    'differ': decisions the CPU takes otherwise, 'decisions': their
    count}. `model_grads` (default `_model_grads`, the student's) takes
    (model, batch, device, decisions)."""
    model_grads = model_grads or _model_grads
    card = _Decisions()
    grads = model_grads(model, batch, 'cuda', card)
    replayed = _Decisions(card.recorded)
    cpu_replay = model_grads(model, batch, 'cpu', replayed)
    if replayed.calls != len(card.recorded):
        raise RuntimeError(f'the CPU pass took {replayed.calls} decisions '
                           f'of the {len(card.recorded)} recorded')
    cpu_own = model_grads(model, batch, 'cpu')
    return {'replay': _worst_grad_errors(grads, cpu_replay),
            'own': _worst_grad_errors(grads, cpu_own),
            'differ': replayed.differ, 'decisions': replayed.total}


def _grads_vs_cpu(model, model_grads=None, what='student'):
    """Float32 gradients of one teacher-forced loss at full width on two
    short items (dropout 0, TF32 off): kernels #2/#3 on the card against
    the plain path on the CPU, the CPU pass replaying the card's ReLU and
    max-pool decisions (`_Decisions`). Tolerance, per parameter:
    ||g_card - g_cpu|| <= 1e-3 ||g_cpu|| and max |g_card - g_cpu| <= 5e-3
    max |g_cpu|. Sums run in other orders on the two devices, and batch
    statistics over 2 items amplify rounding where a channel's variance is
    small (runs on the card have shown element-wise relative errors up to
    4.8e-4). Without the replay a pre-activation within rounding of zero
    can fall on the other side of a ReLU or max-pool on the CPU and move a
    gradient by a whole term, whichever implementation runs; the check
    reports how many decisions the CPU would have taken otherwise, and the
    errors without the replay, which it does not hold to the limits.
    `model_grads` as `_card_cpu_grads` takes it (FastPitch's:
    `_fp_model_grads`)."""
    out = _card_cpu_grads(model, _grads_batch(), model_grads)
    rep, own = out['replay'], out['own']
    check(rep['ok'],
          f'{what} float32 gradients, card vs CPU plain (CPU replaying the '
          f'card\'s {out["decisions"]} ReLU/max-pool decisions; '
          f'{out["differ"]} differ on its own): worst relative L2 error '
          f'{rep["worst_rel_l2"]:.2e} ({rep["param_l2"]}) <= '
          f'{GRAD_L2_LIMIT:g}, worst max-element error '
          f'{rep["worst_rel_max"]:.2e} of the largest ({rep["param_max"]}) '
          f'<= {GRAD_MAX_LIMIT:g}')
    log(f'  without the replay: relative L2 {own["worst_rel_l2"]:.2e}, max '
        f'element {own["worst_rel_max"]:.2e} (not checked)')
    return out


# ------------------------------------------------ data and teacher path

TEACHER_DIR = Path('smoke_teacher')   # corpus, data and checkpoints
# config.yaml's reduction factors, learning rates and batch sizes of the
# first and the last session, cut to 3 + 2 steps
TEACHER_SCHEDULE = ['5, 1e-3, 3, 32', '1, 1e-4, 5, 8']
TEACHER_N_VAL = 8
TEACHER_N_UTTERANCES = 40
TEACHER_SECONDS = (2.0, 8.0)          # the utterances' lengths


def _true_f0(t):
    """The corpus's F0 contour (Hz) at t seconds from a wav's start."""
    return 140.0 + 40.0 * np.sin(2 * np.pi * 0.8 * t) \
        + 15.0 * np.sin(2 * np.pi * 3.1 * t)


def _write_corpus(root, sr, n_items=TEACHER_N_UTTERANCES, seed=0,
                  contour=_true_f0):
    """A seeded LJSpeech-layout corpus under `root`: metadata.csv
    (id|text|text, the text a few lines of sentences.txt cut to ~15
    characters a second) and 16-bit wavs of 2-8 s. Each wav: 0.3 s of
    faint noise, then voiced segments of 0.4-1.2 s (five harmonics whose
    F0 follows `contour`, by default `_true_f0`) with pauses of 0.12 s,
    then 0.3 s of noise.
    Returns {item: (samples, [(start, end) of each voiced segment])}."""
    from scipy.io import wavfile
    rng = np.random.RandomState(seed)
    lines = [s.strip() for s in Path('sentences.txt').read_text().splitlines()
             if s.strip()]
    (root / 'wavs').mkdir(parents=True)
    meta, items = [], {}
    for i in range(n_items):
        seconds, y, segments = _utterance(rng, sr, contour)
        item = f'LJ{i:03d}'
        wavfile.write(str(root / 'wavs' / f'{item}.wav'), sr,
                      np.clip(np.round(y * 32767), -32768,
                              32767).astype(np.int16))
        text = ' '.join(rng.choice(lines, 3))[:int(15 * seconds)]
        meta.append(f'{item}|{text}|{text}')
        items[item] = (len(y), segments)
    (root / 'metadata.csv').write_text('\n'.join(meta) + '\n')
    return items


def _utterance(rng, sr, contour=_true_f0):
    """One utterance of `_write_corpus`: (seconds, samples, voiced
    segments)."""
    seconds = rng.uniform(*TEACHER_SECONDS)
    n = int(seconds * sr)
    lead = int(0.3 * sr)
    voiced = np.zeros(n, bool)
    segments, pos = [], lead
    while pos < n - lead - int(0.4 * sr):
        end = min(pos + int(rng.uniform(0.4, 1.2) * sr), n - lead)
        segments.append((pos, end))
        voiced[pos:end] = True
        pos = end + int(0.12 * sr)
    t = np.arange(n) / sr
    phase = 2 * np.pi * np.cumsum(contour(t)) / sr
    y = sum(0.3 / k * np.sin(k * phase) for k in range(1, 6)) * voiced
    return seconds, y + 1e-4 * rng.randn(n), segments


@contextlib.contextmanager
def _patched(d, **updates):
    """`d` (a dict or os.environ) updated for the block, restored after
    it (keys it did not have removed)."""
    saved = {k: d[k] for k in updates if k in d}
    d.update(updates)
    try:
        yield d
    finally:
        for k in updates:
            if k in saved:
                d[k] = saved[k]
            else:
                d.pop(k, None)


@contextlib.contextmanager
def _teacher_env(base):
    """Inside `base`, with $FTT_BASE = base (checkpoints) and the
    built-in config's n_val cut to TEACHER_N_VAL in memory (the card has
    no pyyaml for a config file)."""
    import os
    from forwardtacotron_tpu_torch import config
    with _patched(os.environ, FTT_BASE=str(base)), _cwd(base), _patched(
            config.PREPROCESSING, n_val=TEACHER_N_VAL):
        yield


def _train_counts(reset=False):
    """Launch counts of kernels #1, #2 and #3 by path (zeroed first with
    `reset`)."""
    from forwardtacotron_tpu_torch.kernels.birnn import recurrence
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        train_backward, train_forward)
    out = {}
    for name, fn in (('birnn', recurrence), ('birnn_train_fwd',
                                             train_forward),
                     ('birnn_train_bwd', train_backward)):
        if reset:
            fn.launches = 0
            fn.path_launches = dict.fromkeys(fn.path_launches, 0)
        out[name] = fn.launches
        out.update({f'{name}_{k}': v for k, v in fn.path_launches.items()})
    return out


def _student_shapes(cfg):
    """(cell, streams, H) of the student's six recurrences in training:
    the three predictor BiGRUs, the prenet CBHG's BiGRU, the decoder
    BiLSTM and the postnet CBHG's BiGRU."""
    m = cfg['forward_tacotron']['model']
    return [('gru', 2, m['durpred_rnn_dims']), ('gru', 2, m['pitch_rnn_dims']),
            ('gru', 2, m['energy_rnn_dims']), ('gru', 2, m['prenet_dims']),
            ('lstm', 2, m['rnn_dims']), ('gru', 2, m['postnet_dims'])]


def _teacher_shapes(cfg):
    """(cell, streams, H) of the teacher's two recurrences in training:
    the encoder CBHG's and the postnet CBHG's BiGRUs."""
    m = cfg['tacotron']['model']
    return [('gru', 2, m['encoder_dims']), ('gru', 2, m['postnet_dims'])]


def _wavernn_shapes(cfg):
    """(cell, streams, H) of WaveRNN's two GRUs (one stream each)."""
    return [('gru', 1, cfg['vocoder']['model']['rnn_dims'])] * 2


def _planned_launches(shapes, batch, dtype, fwd_passes, bwd_passes):
    """{'birnn_train_fwd_<path>': n, 'birnn_train_bwd_<path>': n}: the
    launches by path of `fwd_passes` forwards and `bwd_passes` backwards
    of each recurrence in `shapes` ((cell, streams, H)) at `batch` lanes
    in `dtype`, on the paths `train_forward_plan` and
    `train_backward_plan` give on this card."""
    from forwardtacotron_tpu_torch.kernels import birnn_train as bt
    props = torch.cuda.get_device_properties(0)
    want = {}
    for kind, plan, paths, passes in (
            ('fwd', bt.train_forward_plan, bt.PATHS, fwd_passes),
            ('bwd', bt.train_backward_plan, bt.BWD_PATHS, bwd_passes)):
        want.update({f'birnn_train_{kind}_{p}': 0 for p in paths})
        for cell, S, H in shapes:
            path = plan(cell, S, batch, H, dtype,
                        props.shared_memory_per_block_optin,
                        props.multi_processor_count)['path']
            want[f'birnn_train_{kind}_{path}'] += passes
    return want


def _f0_checks(cfg, items, smi):
    """The F0 that preprocess wrote on the card for one file against the
    CPU plain path on the same trimmed wav, and the card's F0 of the raw
    wav against the known contour at tests/test_dsp_golden.py's bounds."""
    from forwardtacotron_tpu_torch.dsp.audio import DSP
    from forwardtacotron_tpu_torch.dsp.pitch import (extract_pitch,
                                                     extract_pitch_bucketed)
    from forwardtacotron_tpu_torch.preprocess import load_trimmed
    item, (n, segments) = next(iter(items.items()))
    sr, hop = cfg['dsp']['sample_rate'], cfg['dsp']['hop_length']
    dsp = DSP.from_config(cfg, device='cpu')
    wav = Path('corpus') / 'wavs' / f'{item}.wav'
    card = np.load(Path(cfg['data_path']) / 'raw_pitch' / f'{item}.npy')
    cpu = extract_pitch_bucketed(load_trimmed(dsp, wav), sr, hop,
                                 device='cpu')
    same_voicing = float(np.mean((card > 0) == (cpu > 0)))
    both = (card > 0) & (cpu > 0)
    rel = float(np.max(np.abs(card[both] - cpu[both]) / cpu[both])) \
        if both.any() else 0.0
    check(card.shape == cpu.shape and same_voicing >= 0.99 and rel <= 1e-3,
          f'F0 of {item} written by preprocess (card) vs CPU plain: same '
          f'voicing on {same_voicing:.4f} >= 0.99 of {len(cpu)} frames, '
          f'voiced F0 within {rel:.2e} <= 1e-3 relative')

    f0 = extract_pitch(dsp.load_wav(wav), sr, hop, device=DEVICE)
    frames = np.arange(len(f0)) * hop
    voiced = np.zeros(len(f0), bool)
    for a, b in segments:
        voiced |= (frames >= a) & (frames < b)
    true = np.where(voiced, _true_f0(frames / sr), 0.0)
    interior = voiced.copy()
    for k in (1, 2):
        interior &= np.roll(voiced, k) & np.roll(voiced, -k)
    est = f0[interior] > 0
    err = np.abs(f0[interior][est] - true[interior][est]) / true[interior][est]
    far = ~voiced
    for k in (1, 2):
        far &= ~np.roll(voiced, k) & ~np.roll(voiced, -k)
    out = {'item': item, 'same_voicing_card_cpu': same_voicing,
           'max_rel_err_card_cpu': rel, 'voiced_recall': float(est.mean()),
           'median_rel_err': float(np.median(err)),
           'share_within_5pct': float(np.mean(err < 0.05)),
           'hallucinated': float((f0[far] > 0).mean())}
    check(out['voiced_recall'] > 0.9 and out['median_rel_err'] < 0.01
          and out['share_within_5pct'] > 0.95 and out['hallucinated'] < 0.1,
          f'card F0 vs the known contour: {out} (golden bounds: recall > '
          f'0.9, median < 0.01, share within 5% > 0.95, unvoiced pitched '
          f'< 0.1) | {smi}')
    return out


def _teacher_step_timing(model, optimizer, paths, cfg, smi):
    """The teacher's step on the longest bucket at r=5 batch 32 and at r=1
    batch 8 (config.yaml's first and last sessions; `step_timing`)."""
    from forwardtacotron_tpu_torch.data.dataset import get_tts_datasets
    from forwardtacotron_tpu_torch.train.taco_trainer import (
        taco_batch_to_device, taco_micro_loss)
    train_cfg = cfg['tacotron']['training']
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    out = {}
    for r, bs in ((5, 32), (1, 8)):
        train_set, _ = get_tts_datasets(
            paths.data, bs, r, max_mel_len=train_cfg['max_mel_len'],
            filter_attention=False, model_type='tacotron')
        batch = taco_batch_to_device(max(
            train_set.batches(0), key=lambda b: b['mel'].shape[1]), DEVICE)
        row = step_timing(
            train_parts(model, optimizer,
                        taco_micro_loss(model, r, gen, train_cfg), batch,
                        train_cfg),
            f'teacher step r={r} B={bs} {list(batch["mel"].shape)}', smi)
        row.update(batch=list(batch['mel'].shape),
                   text=list(batch['x'].shape))
        out[f'r{r}_b{bs}'] = row
    return out


def _grads_teacher_batch(seed=5):
    """Two short teacher-forced items (40 and 29 phonemes, 160 and 121
    frames, padded as collate_tts pads them) made from `seed`."""
    rng = np.random.RandomState(seed)
    x = np.zeros((2, 40), np.int64)
    x[0] = rng.randint(1, 60, 40)
    x[1, :29] = rng.randint(1, 60, 29)
    mel = (rng.randn(2, 160, 80) * 2 - 5).astype(np.float32)
    mel[1, 121:] = -11.5129
    return x, mel


def _taco_pass(model, x, mel, device, decisions=None):
    """(outputs, {parameter: gradient}) of the teacher's loss on `device`,
    float32 on the CPU, for a copy of `model` in train mode with every
    dropout and zoneout rate 0 (so nothing is drawn); with `decisions`,
    the ReLU and max-pool decisions recorded or replayed."""
    from forwardtacotron_tpu_torch.train.taco_trainer import taco_loss
    m = copy.deepcopy(model).to(device).train()
    for mod in m.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0
    m.encoder.pre_net.p = m.decoder.prenet.p = m.decoder.zoneout = 0.0
    xt, mt = torch.from_numpy(x).to(device), torch.from_numpy(mel).to(device)
    with (_layer_decisions(decisions) if decisions is not None
          else contextlib.nullcontext()):
        out = m(xt, mt, 1, torch.Generator(device=device))
    taco_loss(out[0], out[1], mt)[0].backward()
    return ([o.detach().cpu() for o in out],
            {k: p.grad.detach().cpu() for k, p in m.named_parameters()})


def _teacher_grads_vs_cpu(model):
    """The teacher-forced forward (train mode, rates 0, TF32 off) and its
    gradients on two short items: kernels #2/#3 on the card against the
    plain path on the CPU. Outputs at atol 1e-4; gradients at
    `_grads_vs_cpu`'s limits, the CPU replaying the card's ReLU and
    max-pool decisions (CBHGs and prenets)."""
    x, mel = _grads_teacher_batch()
    card = _Decisions()
    out, grads = _taco_pass(model, x, mel, DEVICE, card)
    replayed = _Decisions(card.recorded)
    _, cpu_replay = _taco_pass(model, x, mel, 'cpu', replayed)
    if replayed.calls != len(card.recorded):
        raise RuntimeError(f'the CPU pass took {replayed.calls} decisions '
                           f'of the {len(card.recorded)} recorded')
    cpu_out, cpu_own = _taco_pass(model, x, mel, 'cpu')
    errs = {k: float((a - b).abs().max()) for k, a, b in
            zip(('mel', 'linear', 'attention'), out, cpu_out)}
    check(all(e <= 1e-4 for e in errs.values()),
          f'teacher-forced forward (train mode, 160 frames), card vs CPU '
          f'plain: max abs errors {errs} <= 1e-4')
    rep = _worst_grad_errors(grads, cpu_replay)
    own = _worst_grad_errors(grads, cpu_own)
    check(rep['ok'], f'teacher float32 gradients, card vs CPU plain (CPU '
          f'replaying the card\'s {replayed.total} decisions; '
          f'{replayed.differ} differ on its own): worst relative L2 '
          f'{rep["worst_rel_l2"]:.2e} ({rep["param_l2"]}) <= '
          f'{GRAD_L2_LIMIT:g}, worst max-element {rep["worst_rel_max"]:.2e} '
          f'({rep["param_max"]}) <= {GRAD_MAX_LIMIT:g}')
    log(f'  without the replay: relative L2 {own["worst_rel_l2"]:.2e}, max '
        f'element {own["worst_rel_max"]:.2e} (not checked)')
    return {'outputs_max_abs_err': errs, 'replay': rep, 'own': own,
            'differ': replayed.differ, 'decisions': replayed.total}


def _teacher_align(cfg, paths, smi):
    """`train_tacotron --force_align` and `--extract_pitch` through `main`
    (the trained teacher restored from latest_model.pt), kernel #1's
    launches counted; every duration sum against its mel_len; the card's
    attention against the CPU's on one batch (atol 1e-4) and the
    utterances whose durations then differ."""
    from forwardtacotron_tpu_torch import train_tacotron
    from forwardtacotron_tpu_torch.align.duration import (
        extract_durations_with_dp)
    from forwardtacotron_tpu_torch.data.dataset import get_tts_datasets
    from forwardtacotron_tpu_torch.kernels import birnn as kb
    from forwardtacotron_tpu_torch.models.tacotron import Tacotron
    from forwardtacotron_tpu_torch.utils.checkpoints import (load_checkpoint,
                                                             restore)
    from forwardtacotron_tpu_torch.utils.files import unpickle_binary
    train_set, val_set = get_tts_datasets(paths.data, 8, 1, None,
                                          filter_attention=False,
                                          model_type='tacotron')
    n_batches = len(train_set) + len(val_set)
    items = dict(unpickle_binary(paths.data / 'train_dataset.pkl')
                 + unpickle_binary(paths.data / 'val_dataset.pkl'))
    _train_counts(reset=True)
    t0 = time.perf_counter()
    train_tacotron.main(['--force_align', '--device', DEVICE])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _train_counts()
    props = torch.cuda.get_device_properties(0)
    plan = kb.inference_plan('gru', 2, 8, 128, torch.float32,
                             props.shared_memory_per_block_optin,
                             props.multi_processor_count)
    check(launches['birnn'] == 2 * n_batches
          and launches[f'birnn_{plan["path"]}'] == launches['birnn']
          and launches['birnn_train_fwd'] == 0,
          f'--force_align: kernel #1 launched {launches["birnn"]} times for '
          f'{n_batches} batches (encoder + postnet BiGRU each), on the '
          f'planned {plan["path"]} path: {launches}')
    bad = [i for i, n in items.items()
           if int(np.load(paths.alg / f'{i}.npy').sum()) != n]
    check(not bad and len(unpickle_binary(paths.data / 'att_score_dict.pkl'))
          == len(items), f'durations of all {len(items)} utterances sum to '
                         f'their mel_len (off: {bad})')
    out = {'launches': launches, 'plan': plan, 'wall_s': wall,
           'utterances': len(items), 'batches': n_batches,
           'utterances_per_s': len(items) / wall}
    log(f'  alignment: {len(items)} utterances in {wall:.2f} s '
        f'({out["utterances_per_s"]:.2f} a second, host clock) | {smi}')

    # one batch on the card and on the CPU
    model = Tacotron.from_config(cfg)
    restore(model, None, load_checkpoint(paths.taco_checkpoints
                                         / 'latest_model.pt'))
    model.eval()
    # the shortest of the batches with the most real utterances
    batch = min(train_set.batches(0), key=lambda b: (-b['n_real'],
                                                     b['mel'].shape[1]))
    x, mel = torch.from_numpy(batch['x']), torch.from_numpy(batch['mel'])
    with torch.no_grad():
        att_cpu = model(x, mel, 1)[2]
        att_card = model.to(DEVICE)(x.to(DEVICE), mel.to(DEVICE), 1)[2].cpu()
    err = float((att_card - att_cpu).abs().max())
    check(err <= 1e-4, f'attention on a batch of {tuple(mel.shape)}, card '
                       f'vs CPU plain: max abs error {err:.2e} <= 1e-4')
    differ = 0
    for j in range(batch['n_real']):
        item, x_len = batch['item_id'][j], int(batch['x_len'][j])
        durs = extract_durations_with_dp(
            x_len, att_cpu[j, :, :x_len].numpy(), int(batch['mel_len'][j]))
        differ += int(not np.array_equal(durs, np.load(
            paths.alg / f'{item}.npy')))
    log(f'  durations from the CPU attention differ from the card\'s for '
        f'{differ} of {batch["n_real"]} utterances')
    out.update(attention_max_abs_err=err, durations_differ=differ,
               durations_compared=int(batch['n_real']))

    train_tacotron.main(['--extract_pitch', '--device', DEVICE])
    check(all((paths.phon_pitch / f'{i}.npy').is_file()
              and (paths.phon_energy / f'{i}.npy').is_file() for i in items),
          f'--extract_pitch wrote pitch and energy for {len(items)} items')
    return out


@phase('data preparation and teacher path (full width)')
def teacher_path():
    """The data path of the port at config.yaml's `dsp` and
    `tacotron.model` widths, random weights from a seed, in TEACHER_DIR.
    Cuts: a corpus of TEACHER_N_UTTERANCES utterances of 2-8 s (LJSpeech:
    13,100 of 1-10 s), n_val TEACHER_N_VAL (200), the teacher's schedule
    TEACHER_SCHEDULE (3 steps at r=5 batch 32, 2 at r=1 batch 8, against
    10k-40k steps), the student 2 steps without the attention filter (an
    untrained teacher's attention passes no filter).

    1. write the corpus (`_write_corpus`) and run `preprocess.main`, mel
       and F0 on the card; its throughput in audio seconds a second;
       F0 checks (`_f0_checks`);
    2. `TacoTrainer.train` on the schedule, kernels #2/#3 counted (two
       of each a step: the encoder's and the postnet's BiGRU), then
       `evaluate()` at r=1 (kernel #1, two a batch);
    3. the step timing (`_teacher_step_timing`) and the gradients
       against the CPU (`_teacher_grads_vs_cpu`);
    4. alignment through `train_tacotron.main` (`_teacher_align`);
    5. `ForwardTrainer.train` for 2 steps on what the port wrote."""
    from forwardtacotron_tpu_torch import preprocess
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.data.dataset import get_tts_datasets
    from forwardtacotron_tpu_torch.kernels import birnn_train as bt
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.models.tacotron import Tacotron
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.forward_trainer import (
        ForwardTrainer)
    from forwardtacotron_tpu_torch.train.taco_trainer import TacoTrainer
    from forwardtacotron_tpu_torch.utils.paths import Paths
    smi = nvidia_smi_line()
    shutil.rmtree(TEACHER_DIR, ignore_errors=True)
    TEACHER_DIR.mkdir(parents=True)
    base = TEACHER_DIR.resolve()
    (base / 'sentences.txt').write_text(Path('sentences.txt').read_text())
    out = {}
    try:
        with _teacher_env(base):
            cfg = default_config()
            sr = cfg['dsp']['sample_rate']
            items = _write_corpus(Path('corpus'), sr)
            audio_s = sum(n for n, _ in items.values()) / sr
            t0 = time.perf_counter()
            train, val = preprocess.main(['--path', 'corpus',
                                          '--num_workers', '4',
                                          '--device', DEVICE])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out['preprocess'] = {'files': len(items), 'audio_s': audio_s,
                                 'wall_s': wall,
                                 'audio_s_per_s': audio_s / wall}
            log(f'  preprocess: {len(items)} files, {audio_s:.1f} s of audio '
                f'in {wall:.2f} s ({audio_s / wall:.1f} audio seconds a '
                f'second, host clock, first calls included) | {smi}')
            check(len(train) == len(items) - TEACHER_N_VAL
                  and len(val) == TEACHER_N_VAL,
                  f'preprocess split {len(train)} train / {len(val)} val')
            out['f0'] = _f0_checks(cfg, items, smi)

            cfg['tacotron']['training']['schedule'] = TEACHER_SCHEDULE
            paths = Paths(cfg['data_path'], cfg['tts_model_id'])
            writer = _Scalars()
            trainer = TacoTrainer(paths, cfg, DEVICE, writer=writer)
            torch.manual_seed(0)
            model = Tacotron.from_config(cfg).to(DEVICE)
            optimizer = tc.make_optimizer(model)
            before = copy.deepcopy(model.state_dict())
            _train_counts(reset=True)
            t0 = time.perf_counter()
            step = trainer.train(model, optimizer)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _train_counts()
            props = torch.cuda.get_device_properties(0)
            plans = {f'B={b}': {k: fn('gru', 2, b, 128, torch.float32,
                                      props.shared_memory_per_block_optin,
                                      props.multi_processor_count)['path']
                                for k, fn in (('fwd', bt.train_forward_plan),
                                              ('bwd', bt.train_backward_plan))}
                     for b in (32, 8)}
            log(f'  teacher: {step} steps in {wall:.1f} s (host clock, first '
                f'steps included), launches {launches}, planned paths '
                f'{plans}')
            check(step == 5, f'teacher trainer reached step {step} == 5')
            check(launches['birnn_train_fwd'] == 2 * step
                  and launches['birnn_train_bwd'] == 2 * step
                  and launches['birnn'] == 0,
                  f'teacher training: kernel #2 {launches["birnn_train_fwd"]}'
                  f' and #3 {launches["birnn_train_bwd"]} launches == 2 a '
                  f'step (encoder and postnet BiGRU) in {step} steps')
            for kind in ('fwd', 'bwd'):
                want = {}
                for b, n in ((32, 3), (8, 2)):
                    p = plans[f'B={b}'][kind]
                    want[p] = want.get(p, 0) + 2 * n
                names = bt.PATHS if kind == 'fwd' else bt.BWD_PATHS
                got = {p: launches[f'birnn_train_{kind}_{p}'] for p in names}
                check(all(got[p] == want.get(p, 0) for p in names),
                      f'teacher kernel #{2 if kind == "fwd" else 3} by path '
                      f'{got} == planned {want}')
            losses = [v for tag, v, _ in writer.values if tag == 'Loss/train']
            check(len(losses) == step and all(map(math.isfinite, losses)),
                  f'teacher losses {losses}, all finite')
            moved = [k for k, p in model.named_parameters()
                     if not torch.equal(p.detach(), before[k])]
            n_params = len(list(model.parameters()))
            check(len(moved) == n_params,
                  f'{len(moved)} of {n_params} teacher parameters moved')
            _, val_set = get_tts_datasets(paths.data, 8, 1, None,
                                          filter_attention=False,
                                          model_type='tacotron')
            _train_counts(reset=True)
            val_loss, val_att = trainer.evaluate(model, val_set, 1)
            ev = _train_counts()
            check(ev['birnn'] == 2 * len(val_set) and ev['birnn_train_fwd']
                  == 0 and math.isfinite(val_loss) and math.isfinite(val_att),
                  f'teacher evaluate(): loss {val_loss:.4f}, attention score '
                  f'{val_att:.4f}, kernel #1 {ev["birnn"]} launches for '
                  f'{len(val_set)} batches: {ev}')
            out['training'] = {'steps': step, 'wall_s': wall,
                               'launches': launches, 'plans': plans,
                               'losses': losses, 'evaluate_launches': ev}
            out['step_ms'] = _teacher_step_timing(model, optimizer, paths,
                                                  cfg, smi)
            out['grads_vs_cpu'] = _teacher_grads_vs_cpu(model)
            out['align'] = _teacher_align(cfg, paths, smi)

            cfg['forward_tacotron']['training']['filter_attention'] = False
            fwd_writer = _Scalars()
            student = ForwardTrainer(paths, cfg, DEVICE, writer=fwd_writer)
            torch.manual_seed(0)
            fmodel = ForwardTacotron.from_config(cfg).to(DEVICE)
            fstep = student.train(fmodel, max_steps_override=2)
            flosses = [v for tag, v, _ in fwd_writer.values
                       if tag == 'Mel_Loss/train']
            check(fstep == 2 and len(flosses) == 2
                  and all(map(math.isfinite, flosses)),
                  f'ForwardTrainer on the port\'s own durations, pitch and '
                  f'energy: step {fstep}, mel losses {flosses}')
            out['student'] = {'steps': fstep, 'mel_losses': flosses}
    finally:
        shutil.rmtree(TEACHER_DIR, ignore_errors=True)
    out['launches'] = {'train': out['training']['launches'],
                       'evaluate': out['training']['evaluate_launches'],
                       'align': out['align']['launches']}
    DETAILS['teacher_path'] = out
    return out['launches']


# ----------------------------------------------- vocoder training path

VOCODER_DIR = Path('smoke_vocoder')   # dataset, GTA mels and checkpoints
# the cuts of phase 10: 64 + 32 synthetic items of 400-600 frames
# (LJSpeech: 13,100 utterances); WaveRNN 4 RAW steps at batch 32 and 3 MOL
# steps (config.yaml: 600k), HiFi-GAN / MelGAN 3 steps each at batch 16
# (800k); one generate_samples call each
VOC_N_TRAIN, VOC_N_VAL = 64, 32
VOC_FRAMES = (400, 601)
VOC_PHONEMES = (60, 121)
VOC_STEPS, MOL_STEPS, GAN_STEPS = 4, 3, 3
VOC_BATCH, GAN_BATCH = 32, 16      # config.yaml's batch sizes
VOC_GEN_LANES = 12     # folds of a 500-frame mel at the trainer's target


@contextlib.contextmanager
def _voc_env(base):
    """Inside `base`, with $FTT_BASE = base, and the built-in config's
    vocoder schedules cut in memory (the card has no pyyaml)."""
    import os
    from forwardtacotron_tpu_torch import config
    with _patched(os.environ, FTT_BASE=str(base)), _cwd(base), _patched(
            config.VOCODER_TRAINING,
            schedule=[f'1e-4, {VOC_STEPS}, {VOC_BATCH}'],
            checkpoint_every=2, gen_samples_every=VOC_STEPS), _patched(
            config.HIFIGAN_TRAINING,
            schedule=[f'2e-4, {GAN_STEPS}, {GAN_BATCH}'],
            checkpoint_every=GAN_STEPS, gen_samples_every=GAN_STEPS,
            num_gen_samples=1):
        yield


def _write_voc_dataset(data, cfg, seed=1, quant_dtype=np.int16):
    """Phase 8's synthetic items (60-120 phonemes, 400-600 frames) with
    9-bit labels of frames x hop samples in quant/ (int16; the native
    loader reads windows of preprocess's int64 only, so int16 labels take
    the numpy path), so one dataset serves the student, WaveRNN and the
    GAN vocoders."""
    from forwardtacotron_tpu_torch.text.symbols import phonemes
    from forwardtacotron_tpu_torch.utils.files import pickle_binary
    rng = np.random.RandomState(seed)
    hop, bits = cfg['dsp']['hop_length'], cfg['dsp']['bits']
    for d in ('mel', 'quant', 'alg', 'phon_pitch', 'phon_energy'):
        (data / d).mkdir(parents=True, exist_ok=True)
    index, text_dict = [], {}
    for i in range(VOC_N_TRAIN + VOC_N_VAL):
        n = int(rng.randint(*VOC_PHONEMES))
        frames = int(rng.randint(*VOC_FRAMES))
        dur = rng.multinomial(frames - n, np.full(n, 1.0 / n)) + 1
        item = f'voc_{i:03d}'
        np.save(data / 'mel' / f'{item}.npy',
                (rng.randn(80, frames) * 2 - 5).astype(np.float32))
        np.save(data / 'quant' / f'{item}.npy',
                rng.randint(0, 2 ** bits, frames * hop).astype(quant_dtype))
        np.save(data / 'alg' / f'{item}.npy', dur.astype(np.int32))
        np.save(data / 'phon_pitch' / f'{item}.npy',
                rng.randn(n).astype(np.float32))
        np.save(data / 'phon_energy' / f'{item}.npy',
                rng.randn(n).astype(np.float32))
        text_dict[item] = ''.join(rng.choice(phonemes[1:], n))
        index.append((item, frames))
    pickle_binary(text_dict, data / 'text_dict.pkl')
    pickle_binary(index[:VOC_N_TRAIN], data / 'train_dataset.pkl')
    pickle_binary(index[VOC_N_TRAIN:], data / 'val_dataset.pkl')
    pickle_binary({k: (1.0, 1.0) for k, _ in index},
                  data / 'att_score_dict.pkl')
    return index


def _voc_gta(cfg, paths, index, smi):
    """`train_forward.main(['--force_gta'])` on a seeded student
    checkpoint: a GTA mel of each item's shape, through kernel #1 (the
    student in eval mode); utterances a second on the host clock."""
    from forwardtacotron_tpu_torch import train_forward
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.utils.checkpoints import save_checkpoint
    torch.manual_seed(0)
    save_checkpoint(ForwardTacotron.from_config(cfg), None, cfg,
                    paths.forward_checkpoints / 'latest_model.pt', step=1)
    _train_counts(reset=True)
    t0 = time.perf_counter()
    step = train_forward.main(['--force_gta', '--device', DEVICE])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _train_counts()
    shapes_ok = all(np.load(paths.gta / f'{k}.npy').shape == (80, n)
                    and np.isfinite(np.load(paths.gta / f'{k}.npy')).all()
                    for k, n in index)
    check(step == 1 and shapes_ok and launches['birnn'] > 0
          and launches['birnn_train_fwd'] == 0,
          f'train_forward --force_gta: {len(index)} GTA mels of their '
          f'items\' shapes, all finite; kernel #1 {launches["birnn"]} '
          'launches')
    out = {'utterances': len(index), 'wall_s': wall,
           'utterances_per_s': len(index) / wall, 'launches': launches}
    log(f'  --force_gta: {len(index)} utterances in {wall:.2f} s '
        f'({len(index) / wall:.1f} a second, host clock, first calls '
        f'included) | {smi}')
    return out


def _voc_step_timing(model, optimizer, batch, train_cfg, smi):
    """The WaveRNN step at batch 32, seq_len 1280, RAW (`step_timing`)."""
    from forwardtacotron_tpu_torch.train.voc_trainer import voc_micro_loss
    out = step_timing(train_parts(
        model, optimizer, voc_micro_loss(model, 'RAW'), batch, train_cfg),
        f'WaveRNN step {list(batch["x"].shape)}', smi)
    out['batch'] = list(batch['x'].shape)
    return out


@contextlib.contextmanager
def _wavernn_decisions(decisions):
    """models/wavernn.py's `F` is `decisions` inside the block."""
    from forwardtacotron_tpu_torch.models import wavernn
    saved = wavernn.F
    wavernn.F = decisions
    try:
        yield decisions
    finally:
        wavernn.F = saved


def _voc_model_grads(model, batch, device, decisions=None):
    """{parameter: float32 gradient on the CPU} of WaveRNN's RAW loss on
    `batch` for a copy of `model` on `device` in train mode; with
    `decisions`, its ReLU decisions recorded or replayed."""
    from forwardtacotron_tpu_torch.train.voc_trainer import voc_loss
    m = copy.deepcopy(model).to(device).train()
    b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    with (_wavernn_decisions(decisions) if decisions is not None
          else contextlib.nullcontext()):
        loss = voc_loss(m(b['x'], b['mel']), b['y'], 'RAW')
    loss.backward()
    return {k: p.grad.detach().cpu() for k, p in m.named_parameters()}


def _voc_grads_vs_cpu(model):
    """Float32 gradients of WaveRNN's RAW loss at full width on four
    windows of seq_len 1280 (seeded): kernels #2/#3 at S=1 on the card
    against the plain path on the CPU, the CPU replaying the card's ReLU
    decisions, held to phase 8's limits (`_grads_vs_cpu`)."""
    rng = np.random.RandomState(9)
    batch = {'x': rng.uniform(-1, 1, (4, 1280)).astype(np.float32),
             'mel': (rng.randn(4, 1280 // 256 + 4, 80) * 2 - 5).astype(
                 np.float32),
             'y': rng.randint(0, 512, (4, 1280))}
    out = _card_cpu_grads(model, batch, _voc_model_grads)
    rep, own = out['replay'], out['own']
    check(rep['ok'],
          f'WaveRNN float32 gradients, card vs CPU plain (CPU replaying '
          f'the card\'s {out["decisions"]} ReLU decisions; {out["differ"]} '
          f'differ on its own): worst relative L2 error '
          f'{rep["worst_rel_l2"]:.2e} ({rep["param_l2"]}) <= '
          f'{GRAD_L2_LIMIT:g}, worst max-element error '
          f'{rep["worst_rel_max"]:.2e} ({rep["param_max"]}) <= '
          f'{GRAD_MAX_LIMIT:g}')
    log(f'  without the replay: relative L2 {own["worst_rel_l2"]:.2e}, max '
        f'element {own["worst_rel_max"]:.2e} (not checked)')
    return out


def _voc_mol_steps(cfg, index, smi):
    """MOL_STEPS steps of `voc_train_step` at full width, batch 32,
    seq_len 1280, on 16-bit labels made from a seed for the train items'
    mels: finite losses, two launches each of #2 and #3 a step."""
    from forwardtacotron_tpu_torch.data.dataset import VocCollator
    from forwardtacotron_tpu_torch.models.wavernn import WaveRNN
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.voc_trainer import (
        batch_to_device, voc_train_step)
    mcfg = copy.deepcopy(cfg)
    mcfg['vocoder']['model']['mode'] = 'MOL'
    torch.manual_seed(1)
    model = WaveRNN.from_config(mcfg).to(DEVICE)
    optimizer = tc.make_optimizer(model)
    rng = np.random.RandomState(2)
    hop = cfg['dsp']['hop_length']
    items = [{'mel': np.load(Path(cfg['data_path']) / 'gta' / f'{k}.npy'),
              'x': rng.randint(0, 2 ** 16, n * hop)}
             for k, n in index[:VOC_BATCH]]
    collator = VocCollator(hop, model.pad,
                           cfg['vocoder']['training']['seq_len'], 'MOL',
                           cfg['dsp']['bits'])
    _train_counts(reset=True)
    losses = []
    for s in range(MOL_STEPS):
        collator.rng = np.random.RandomState(s)
        metrics = voc_train_step(model, optimizer, batch_to_device(
            collator(items), DEVICE), 'MOL', 4.0)
        losses.append(float(metrics['loss']))
    launches = _train_counts()
    check(all(map(math.isfinite, losses))
          and launches['birnn_train_fwd'] == 2 * MOL_STEPS
          and launches['birnn_train_bwd'] == 2 * MOL_STEPS,
          f'WaveRNN MOL: {MOL_STEPS} steps at batch {VOC_BATCH}, losses '
          f'{losses}, '
          f'kernels #2/#3 {launches["birnn_train_fwd"]}/'
          f'{launches["birnn_train_bwd"]} launches')
    return {'losses': losses, 'launches': launches}


def _voc_generate_timing(cfg, paths, model, samples, smi):
    """One more `VocTrainer.generate_samples` call on the trained model
    (its samples through kernel #4 at the trainer's fold, then the mel L1
    of each resynthesis): host ms of the call and #4's launches."""
    from forwardtacotron_tpu_torch.dsp.audio import DSP
    from forwardtacotron_tpu_torch.kernels.wavernn_sample import sample
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.voc_trainer import VocTrainer
    trainer = VocTrainer(paths, DSP.from_config(cfg, DEVICE), cfg, DEVICE)
    session = tc.VocSession(1, 1e-4, 1, VOC_BATCH, None, [], samples)
    sample.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mel_l1 = trainer.generate_samples(model, session, 0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    frames = [s['mel'].shape[-1] for s in samples]
    out = {'ms': ms, 'launches': sample.launches, 'mel_l1': mel_l1,
           'frames': frames}
    log(f'  generate_samples: {len(samples)} samples of {frames} frames in '
        f'{ms:.1f} ms (host clock), kernel #4 launches {sample.launches}, '
        f'mel L1 {mel_l1} | {smi}')
    check(sample.launches >= len(samples) and math.isfinite(mel_l1),
          f'generate_samples again: #4 launches {sample.launches}, mel L1 '
          f'{mel_l1}')
    return out


def _voc_wavernn(cfg, paths, index, student, smi):
    """`train_wavernn.main(['--gta'])`: VOC_STEPS steps at batch 32, RAW,
    seq_len 1280, full width; kernel launches counted from 0 (#2 and #3,
    two a step on their planned paths; #1 in `evaluate()`; #4 in
    `generate_samples`); losses finite, every parameter moved, the
    checkpoints written and served by `gen_forward wavernn`; then the MOL
    steps, the step timing and the gradients against the CPU."""
    from forwardtacotron_tpu_torch import gen_forward, train_wavernn
    from forwardtacotron_tpu_torch.data.dataset import get_vocoder_datasets
    from forwardtacotron_tpu_torch.kernels import birnn_train as bt
    from forwardtacotron_tpu_torch.kernels.wavernn_sample import sample
    from forwardtacotron_tpu_torch.models.wavernn import WaveRNN
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.voc_trainer import batch_to_device
    from forwardtacotron_tpu_torch.utils.checkpoints import load_checkpoint
    from forwardtacotron_tpu_torch.utils.files import unpickle_binary
    torch.manual_seed(train_wavernn.SEED)
    model = WaveRNN.from_config(cfg)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    writer = _Scalars()
    _train_counts(reset=True)
    sample.launches = 0
    t0 = time.perf_counter()
    step = train_wavernn.main(['--gta', '--device', DEVICE],
                              writer=writer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**_train_counts(), 'wavernn_sample': sample.launches}
    props = torch.cuda.get_device_properties(0)
    plans = {k: fn('gru', 1, VOC_BATCH, model.rnn_dims, torch.float32,
                   props.shared_memory_per_block_optin,
                   props.multi_processor_count)['path']
             for k, fn in (('fwd', bt.train_forward_plan),
                           ('bwd', bt.train_backward_plan))}
    log(f'  train_wavernn --gta: {step} steps in {wall:.1f} s (host clock, '
        f'first steps, evaluate() and generate_samples included), launches '
        f'{launches}, planned paths {plans}')
    check(step == VOC_STEPS, f'WaveRNN trainer reached step {step} == '
                             f'{VOC_STEPS}')
    for kind, names in (('fwd', bt.PATHS), ('bwd', bt.BWD_PATHS)):
        got = {p: launches[f'birnn_train_{kind}_{p}'] for p in names}
        check(got == {p: 2 * step * (p == plans[kind]) for p in names},
              f'WaveRNN kernel #{2 if kind == "fwd" else 3} by path {got}: '
              f'2 a step on the planned {plans[kind]} path')
    val = [v for t, v, _ in writer.values if t == 'Loss/val']
    check(launches['birnn'] == 2 == launches['birnn_stream_local']
          and len(val) == 1 and math.isfinite(val[0]),
          f'WaveRNN evaluate(): loss {val}, kernel #1 launches '
          f'{launches["birnn"]} (two GRUs, one val batch, stream-local)')
    gen_l1 = [v for t, v, _ in writer.values
              if t == 'Loss/generated_mel_l1']
    check(len(gen_l1) == 1 and math.isfinite(gen_l1[0])
          and launches['wavernn_sample'] > 0,
          f'WaveRNN generate_samples: mel L1 {gen_l1}, kernel #4 launches '
          f'{launches["wavernn_sample"]}')
    losses = [v for t, v, _ in writer.values if t == 'Loss/train']
    check(len(losses) == step and all(map(math.isfinite, losses)),
          f'WaveRNN losses {losses}, all finite')
    latest = paths.voc_checkpoints / 'latest_model.pt'
    payload = load_checkpoint(latest)
    moved = [k for k, v in before.items()
             if not torch.equal(payload['model'][k], v)]
    top_k = unpickle_binary(paths.voc_top_k / 'top_k.pkl')
    check(len(moved) == len(before) and payload['step'] == step
          and len(top_k) == 1
          and (paths.voc_top_k / top_k[0][2]).is_file(),
          f'{len(moved)} of {len(before)} WaveRNN parameters moved; '
          f'latest_model.pt at step {payload["step"]}; top-k {top_k}')

    sample.launches = 0
    for wav in Path('model_outputs').glob('*.wav'):
        wav.unlink()
    gen_forward.main(['--checkpoint', str(student), '--device', DEVICE,
                      'wavernn', '--voc_checkpoint', str(latest)])
    wavs = list(Path('model_outputs').glob('*wavernn*.wav'))
    check(len(wavs) > 0 and sample.launches > 0,
          f'gen_forward wavernn served latest_model.pt: {len(wavs)} wavs, '
          f'kernel #4 launches {sample.launches}')

    out = {'steps': step, 'wall_s': wall, 'launches': launches,
           'plans': plans, 'losses': losses, 'val_loss': val,
           'generated_mel_l1': gen_l1}
    out['mol'] = _voc_mol_steps(cfg, index, smi)
    voc_cfg = cfg['vocoder']['training']
    train_set, _, samples = get_vocoder_datasets(
        paths.data, VOC_BATCH, True, 20000, cfg['dsp']['hop_length'],
        model.pad, voc_cfg['seq_len'], 'RAW', cfg['dsp']['bits'],
        voc_cfg['num_gen_samples'])
    batch = batch_to_device(next(iter(train_set)), DEVICE)
    model.load_state_dict(payload['model'])
    model.to(DEVICE)
    out['generate_samples'] = _voc_generate_timing(
        cfg, paths, model, samples, smi)
    out['step_ms'] = _voc_step_timing(model, tc.make_optimizer(model), batch,
                                      voc_cfg, smi)
    out['grads_vs_cpu'] = _voc_grads_vs_cpu(model)
    return out


def _gan_step_timing(gen, disc, batch, wav_to_mel, smi, what):
    """The GAN step at batch 16, seg_len 8192, split into the
    discriminators' half and the generator's (`step_timing`)."""
    from forwardtacotron_tpu_torch.train.hifigan_trainer import (
        disc_step, gen_step, make_gan_optimizer)
    gopt, dopt = make_gan_optimizer(gen), make_gan_optimizer(disc)
    mel, y = batch['mel'].transpose(1, 2), batch['audio']
    out = step_timing(
        [('disc_ms', lambda: disc_step(gen, disc, dopt, mel, y)),
         ('gen_ms', lambda: gen_step(gen, disc, gopt, mel, y, wav_to_mel))],
        f'{what} step {list(y.shape)}', smi)
    out['batch'] = list(y.shape)
    return out


def _voc_gan(kind, paths, student, smi):
    """`train_hifigan.main(['--gta'])` with `generator_type` `kind` at
    config.yaml's
    widths (HiFi-GAN V1; the hub MelGAN, base 512): GAN_STEPS steps at
    batch 16, seg_len 8192; losses finite, every parameter of both nets
    moved, one finite sample mel L1, the latest generator served by
    `gen_forward <kind> --voc_checkpoint`; then the step timing."""
    from forwardtacotron_tpu_torch import config, gen_forward, train_hifigan
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.data.dataset import (
        get_gan_vocoder_datasets)
    from forwardtacotron_tpu_torch.dsp.audio import DSP
    from forwardtacotron_tpu_torch.models.gan_discriminators import (
        HiFiGANDiscriminators)
    from forwardtacotron_tpu_torch.models.hifigan import (fold_weight_norm,
                                                          make_generator)
    from forwardtacotron_tpu_torch.train.voc_trainer import batch_to_device
    from forwardtacotron_tpu_torch.utils.checkpoints import load_checkpoint
    shutil.rmtree(paths.hifigan_checkpoints, ignore_errors=True)
    with _patched(config.HIFIGAN_MODEL, generator_type=kind):
        cfg = default_config()
        torch.manual_seed(train_hifigan.SEED)
        gen, disc = make_generator(cfg), HiFiGANDiscriminators()
        before = {'generator': copy.deepcopy(gen.state_dict()),
                  'discriminator': copy.deepcopy(disc.state_dict())}
        writer = _Scalars()
        t0 = time.perf_counter()
        step = train_hifigan.main(['--gta', '--device', DEVICE],
                                  writer=writer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    latest = paths.hifigan_checkpoints / 'latest_model.pt'
    payload = load_checkpoint(latest)
    after = {'generator': fold_weight_norm(payload['generator']),
             'discriminator': payload['discriminator']}
    moved = {part: sum(not torch.equal(after[part][k], v)
                       for k, v in before[part].items())
             for part in before}
    losses = {tag: [v for t, v, _ in writer.values if t == f'Loss/{tag}']
              for tag in ('disc_loss', 'gen_loss', 'gen_adv', 'gen_fm',
                          'gen_mel')}
    gen_l1 = [v for t, v, _ in writer.values
              if t == 'Loss/generated_mel_l1']
    log(f'  train_hifigan ({kind}): {step} steps in {wall:.1f} s (host '
        f'clock, first steps included), losses {losses}, sample mel L1 '
        f'{gen_l1}')
    check(step == GAN_STEPS and all(
        len(v) == step and all(map(math.isfinite, v))
        for v in losses.values()) and len(gen_l1) == 1
        and math.isfinite(gen_l1[0]),
        f'{kind}: {step} steps, every loss finite, one finite sample mel L1')
    check(all(moved[p] == len(before[p]) for p in before),
          f'{kind}: parameters moved {moved} of '
          f'{ {p: len(v) for p, v in before.items()} }')
    for wav in Path('model_outputs').glob('*.wav'):
        wav.unlink()
    gen_forward.main(['--checkpoint', str(student), '--device', DEVICE,
                      kind, '--voc_checkpoint', str(latest)])
    wavs = list(Path('model_outputs').glob(f'*{kind}*.wav'))
    check(len(wavs) > 0, f'gen_forward {kind} served latest_model.pt: '
                         f'{len(wavs)} wavs')
    with _patched(config.HIFIGAN_MODEL, generator_type=kind):
        cfg = default_config()
        train_set, _, _ = get_gan_vocoder_datasets(
            paths.data, GAN_BATCH, True, 20000, cfg['dsp']['hop_length'],
            cfg['hifigan']['training']['seg_len'], 'RAW',
            cfg['dsp']['bits'], True, 0)
        batch = batch_to_device(next(iter(train_set)), DEVICE)
        torch.manual_seed(3)
        timing = _gan_step_timing(
            make_generator(cfg).to(DEVICE), HiFiGANDiscriminators().to(DEVICE),
            batch, DSP.from_config(cfg, DEVICE).wav_to_mel_batch, smi, kind)
    return {'steps': step, 'wall_s': wall, 'losses': losses,
            'generated_mel_l1': gen_l1, 'moved': moved, 'step_ms': timing}


@phase('vocoder training path (full width)')
def vocoder_path():
    """The vocoder-training path of the port at config.yaml's widths,
    random weights from seeds, in VOCODER_DIR. Cuts: a synthetic dataset
    of VOC_N_TRAIN + VOC_N_VAL items of 400-600 frames with random 9-bit
    labels (LJSpeech: 13,100 utterances); a seeded student checkpoint in
    place of a trained one; WaveRNN VOC_STEPS RAW steps at batch 32 and
    MOL_STEPS MOL steps, HiFi-GAN V1 and MelGAN GAN_STEPS steps each at
    batch 16 (config.yaml: 600k and 800k steps).

    1. `train_forward.main(['--force_gta'])` (`_voc_gta`);
    2. `train_wavernn.main(['--gta'])` with its launches, evaluate(),
       generate_samples and checkpoints; `gen_forward wavernn` on its
       latest model; the MOL steps; the step timing; the gradients against
       the CPU (`_voc_wavernn`);
    3. `train_hifigan.main(['--gta'])` for HiFi-GAN and for MelGAN, each served
       by `gen_forward` and timed (`_voc_gan`)."""
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.utils.paths import Paths
    smi = nvidia_smi_line()
    shutil.rmtree(VOCODER_DIR, ignore_errors=True)
    VOCODER_DIR.mkdir(parents=True)
    base = VOCODER_DIR.resolve()
    (base / 'sentences.txt').write_text(
        '\n'.join(Path('sentences.txt').read_text().splitlines()[:2]) + '\n')
    out = {}
    try:
        with _voc_env(base):
            cfg = default_config()
            index = _write_voc_dataset(Path(cfg['data_path']), cfg)
            paths = Paths(cfg['data_path'], cfg['tts_model_id'],
                          voc_id=cfg['voc_model_id'])
            student = paths.forward_checkpoints / 'latest_model.pt'
            out['gta'] = _voc_gta(cfg, paths, index, smi)
            out['wavernn'] = _voc_wavernn(cfg, paths, index, student, smi)
            out['gan'] = {kind: _voc_gan(kind, paths, student, smi)
                          for kind in ('hifigan', 'melgan')}
    finally:
        shutil.rmtree(VOCODER_DIR, ignore_errors=True)
    DETAILS['vocoder_path'] = out
    return out


# ------------------------------------------------- the trainers' options

OPTIONS_DIR = Path('smoke_options')   # datasets and checkpoints of phase 11
# phase 11's cuts: each trainer run 2 steps (config.yaml: 40k-800k), the
# student on phase 8's synthetic dataset, WaveRNN on phase 10's; every
# step timing on one batch of config.yaml's batch size
OPTIONS_STEPS = 2
# the student's options as phase 11 times them (config.yaml's
# forward_tacotron.training with these changed)
STUDENT_OPTIONS = (('f32', {}), ('bf16', {'precision': 'bf16'}),
                   ('grad_accum 2', {'grad_accum': 2}),
                   ('grad_accum 4', {'grad_accum': 4}),
                   ('remat', {'remat': True}),
                   ('ema 0.9995', {'ema_decay': 0.9995}))
# the teacher's options step: batch, phonemes and frames (r=5; phase 9's
# longest r=5 bucket is ~690 frames)
TEACHER_OPTIONS_BATCH = (32, 120, 700)
# the relative L2 distance of the card's bf16 student gradients from its
# float32 ones (all parameters together): the CPU tests measured 0.124
# between JAX's own float32 and bf16 steps at a tiny width
# (tests/test_torch_train_options_remat_bf16.py) and hold the port to 2x
# that
BF16_GRAD_L2_LIMIT = 0.25


def _option_counts(reset=False):
    """`_train_counts` with the launches of #2/#3 by compute dtype, over
    both paths and on each."""
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        train_backward, train_forward)
    out = _train_counts(reset)
    for name, fn in (('birnn_train_fwd', train_forward),
                     ('birnn_train_bwd', train_backward)):
        if reset:
            fn.path_dtype_launches = dict.fromkeys(fn.path_dtype_launches, 0)
        for (path, dtype), n in fn.path_dtype_launches.items():
            out[f'{name}_{path}_{dtype}'] = n
            out[f'{name}_{dtype}'] = out.get(f'{name}_{dtype}', 0) + n
    return out


def _check_launches(got, what, shapes, batch, train_cfg, steps=1):
    """`steps` steps of the recurrences `shapes` ((cell, streams, H)) at
    `batch` lanes: #2 k launches each a step (twice that under remat), #3
    k, all in the step's compute dtype, each on the paths the plans give
    at the micro-batch of batch / k lanes."""
    from forwardtacotron_tpu_torch.train.common import half_dtype
    k = int(train_cfg.get('grad_accum', 1) or 1)
    remat = bool(train_cfg.get('remat', False))
    dtype = 'float32' if half_dtype(train_cfg) is None else 'bfloat16'
    fwd = len(shapes) * steps * k * (2 if remat else 1)
    bwd = len(shapes) * steps * k
    want = _planned_launches(shapes, batch // k, getattr(torch, dtype),
                             fwd // len(shapes), bwd // len(shapes))
    by_path = {key: got[key] for key in want}
    check(by_path == want, f'{what}: kernels #2/#3 by path {by_path} == '
                           f'planned {want}')
    ok = (got['birnn_train_fwd'] == got[f'birnn_train_fwd_{dtype}'] == fwd
          and got['birnn_train_bwd'] == got[f'birnn_train_bwd_{dtype}']
          == bwd)
    check(ok, f'{what}: kernel #2 {got["birnn_train_fwd"]} launches '
              f'({got[f"birnn_train_fwd_{dtype}"]} in {dtype}) == {fwd}, #3 '
              f'{got["birnn_train_bwd"]} ({got[f"birnn_train_bwd_{dtype}"]} '
              f'in {dtype}) == {bwd}')


def _student_options(cfg, paths, smi):
    """Each of STUDENT_OPTIONS on one batch of the 768-frame bucket at
    batch 32: one `train_step` with its launches counted, then its step
    timing."""
    from forwardtacotron_tpu_torch.data.dataset import get_tts_datasets
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.forward_trainer import (
        batch_to_device)
    _, val_set = get_tts_datasets(cfg['data_path'], 32, 1, None)
    batch = batch_to_device(next(b for b in val_set
                                 if b['mel'].shape[1] == 768), DEVICE)
    torch.manual_seed(0)
    model = ForwardTacotron.from_config(cfg).to(DEVICE).train()
    optimizer = tc.make_optimizer(model)
    out = {}
    for label, options in STUDENT_OPTIONS:
        train_cfg = dict(cfg['forward_tacotron']['training'], **options)
        ema = tc.make_ema(model, train_cfg)
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        _option_counts(reset=True)
        metrics = tc.train_step(model, optimizer, batch, gen, train_cfg, ema)
        launches = _option_counts()
        _check_launches(launches, f'student {label} step',
                        _student_shapes(cfg), 32, train_cfg)
        check(math.isfinite(float(metrics['loss'])),
              f'student {label}: loss {float(metrics["loss"]):.4f} finite')
        row = step_timing(_student_parts(model, optimizer, batch, train_cfg,
                                         ema),
                          f'student {label} step at batch 32, 768 frames',
                          smi)
        row['launches'] = launches
        out[label] = row
    out['batch'] = list(batch['mel'].shape)
    out['grads'] = _student_option_grads(model, batch)
    return out


def _student_grads(model, batch, train_cfg, seed=0):
    """{parameter: gradient} and the running statistics after one
    forward and backward of a copy of `model` under `train_cfg`'s
    precision and remat, dropout live from the global RNG seeded with
    `seed`."""
    from forwardtacotron_tpu_torch.train import common as tc
    m = copy.deepcopy(model).train()
    torch.manual_seed(seed)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    loss = tc.forward_micro_loss(m, train_cfg)(
        tc.forward_step_batch(batch, gen, train_cfg))[0]
    loss.backward()
    stats = {k: v.clone() for k, v in m.state_dict().items()
             if 'running' in k or k.endswith('num_batches_tracked')}
    return ({k: p.grad.detach().float().cpu()
             for k, p in m.named_parameters()}, stats)


def _student_option_grads(model, batch):
    """On the card at full width: remat against no remat (the running
    statistics exactly equal, the gradients within phase 8's limits), and
    the bf16 step's gradients against the float32 step's (relative L2 of
    all parameters together <= BF16_GRAD_L2_LIMIT)."""
    from forwardtacotron_tpu_torch.config import default_config
    train_cfg = default_config()['forward_tacotron']['training']
    g32, s32 = _student_grads(model, batch, train_cfg)
    g_remat, s_remat = _student_grads(model, batch, dict(train_cfg,
                                                          remat=True))
    same_stats = all(torch.equal(s32[k], s_remat[k]) for k in s32)
    errors = _worst_grad_errors(g_remat, g32)
    check(same_stats and errors['ok'],
          f'student remat vs no remat on the card, dropout live: running '
          f'statistics {"equal" if same_stats else "DIFFER"} ({len(s32)} '
          f'tensors), gradients worst relative L2 '
          f'{errors["worst_rel_l2"]:.2e} ({errors["param_l2"]}) <= '
          f'{GRAD_L2_LIMIT:g}, worst max-element {errors["worst_rel_max"]:.2e} '
          f'({errors["param_max"]}) <= {GRAD_MAX_LIMIT:g}')
    g16, _ = _student_grads(model, batch, dict(train_cfg, precision='bf16'))
    num = sum(float((g16[k] - g).norm()) ** 2 for k, g in g32.items())
    den = sum(float(g.norm()) ** 2 for g in g32.values())
    rel = (num / den) ** 0.5
    per = _grad_errors(g16, g32)[0]
    worst = max(per, key=per.get)
    check(rel <= BF16_GRAD_L2_LIMIT and all(
        bool(torch.isfinite(g).all()) for g in g16.values()),
        f'student bf16 vs float32 gradients on the card: relative L2 '
        f'{rel:.4f} <= {BF16_GRAD_L2_LIMIT} (worst parameter {worst} '
        f'{per[worst]:.3f})')
    return {'remat': errors, 'remat_stats_equal': same_stats,
            'bf16_rel_l2': rel, 'bf16_worst_param': [worst, per[worst]]}


def _student_trainer_run(cfg, paths, smi):
    """`ForwardTrainer.train` with every option on (bf16, grad_accum 2,
    remat, ema_decay 0.9995) for OPTIONS_STEPS steps at batch 32, counts
    zeroed just before and read just after; `evaluate()` with the EMA
    weights (#1); the async writer's latest_model.pt against the payload
    a synchronous save writes."""
    from forwardtacotron_tpu_torch.data.dataset import get_tts_datasets
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.forward_trainer import (
        ForwardTrainer)
    from forwardtacotron_tpu_torch.utils.checkpoints import (
        checkpoint_payload, load_checkpoint)
    options = {'precision': 'bf16', 'grad_accum': 2, 'remat': True,
               'ema_decay': 0.9995}
    run_cfg = copy.deepcopy(cfg)
    run_cfg['forward_tacotron']['training'].update(options)
    trainer = ForwardTrainer(paths, run_cfg, DEVICE)
    torch.manual_seed(0)
    model = ForwardTacotron.from_config(run_cfg).to(DEVICE)
    optimizer = tc.make_optimizer(model)
    _option_counts(reset=True)
    t0 = time.perf_counter()
    step = trainer.train(model, optimizer, max_steps_override=OPTIONS_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _, val_set = get_tts_datasets(cfg['data_path'], 32, 1, None)
    trainer.evaluate(model, val_set)
    launches = _option_counts()
    log(f'  ForwardTrainer with {options}: {step} steps in {wall:.1f} s '
        f'(host clock, first steps included), launches {launches}')
    check(step == OPTIONS_STEPS, f'student trainer with every option '
                                 f'reached step {step}')
    _check_launches(launches, f'student trainer, {step} steps, all options',
                    _student_shapes(run_cfg), 32,
                    run_cfg['forward_tacotron']['training'], step)
    check(launches['birnn'] == launches['birnn_stream_local'] > 0,
          f'evaluate() with the EMA weights: kernel #1 '
          f'{launches["birnn"]} launches, stream-local')
    payload = load_checkpoint(paths.forward_checkpoints / 'latest_model.pt')
    want = checkpoint_payload(model, optimizer, run_cfg, step, trainer.ema)

    def same(a, b):
        if torch.is_tensor(a):
            return torch.equal(a.cpu(), b.cpu())
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(same, a, b))
        return a == b
    ema_moved = any(not torch.equal(trainer.ema.params[k], p.detach())
                    for k, p in model.named_parameters())
    check(all(same(payload[k], want[k]) for k in ('model', 'raw_model',
                                                  'optim', 'step'))
          and ema_moved,
          'the async writer\'s latest_model.pt equals a synchronous save '
          '(EMA weights under model, raw under raw_model, Adam, step)')
    return {'steps': step, 'wall_s': wall, 'launches': launches,
            'options': options}


def _teacher_options(smi):
    """The teacher's step at r=5 on a synthetic batch of
    TEACHER_OPTIONS_BATCH, float32, bf16 and remat, each with its launches
    counted over one `taco_train_step` and then timed."""
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.models.tacotron import Tacotron
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.taco_trainer import (
        taco_micro_loss, taco_train_step)
    cfg = default_config()
    rng = np.random.RandomState(4)
    B, n, frames = TEACHER_OPTIONS_BATCH
    batch = {'x': torch.from_numpy(rng.randint(1, 60, (B, n))).to(DEVICE),
             'mel': torch.from_numpy((rng.randn(B, frames, 80) * 2
                                      - 5).astype(np.float32)).to(DEVICE)}
    torch.manual_seed(0)
    model = Tacotron.from_config(cfg).to(DEVICE).train()
    optimizer = tc.make_optimizer(model)
    out = {}
    for label, options in (('f32', {}), ('bf16', {'precision': 'bf16'}),
                           ('remat', {'remat': True})):
        train_cfg = dict(cfg['tacotron']['training'], **options)
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        _option_counts(reset=True)
        metrics, _ = taco_train_step(model, optimizer, batch, 5, gen,
                                     train_cfg)
        launches = _option_counts()
        _check_launches(launches, f'teacher {label} step',
                        _teacher_shapes(cfg), B, train_cfg)
        check(math.isfinite(float(metrics['loss'])),
              f'teacher {label}: loss {float(metrics["loss"]):.4f} finite')
        row = step_timing(train_parts(model, optimizer,
                                      taco_micro_loss(model, 5, gen,
                                                      train_cfg),
                                      batch, train_cfg),
                          f'teacher {label} step r=5 '
                          f'{list(batch["mel"].shape)}', smi, reps=2)
        row['launches'] = launches
        out[label] = row
    return out


def _wavernn_option_batch(cfg, seed=6):
    rng = np.random.RandomState(seed)
    seq, hop = cfg['vocoder']['training']['seq_len'], cfg['dsp']['hop_length']
    pad = cfg['vocoder']['model']['pad']
    return {'x': torch.from_numpy(rng.uniform(-1, 1, (32, seq)).astype(
                np.float32)).to(DEVICE),
            'mel': torch.from_numpy((rng.randn(
                32, seq // hop + 2 * pad, 80) * 2 - 5).astype(
                    np.float32)).to(DEVICE),
            'y': torch.from_numpy(rng.randint(0, 512, (32, seq))).to(DEVICE)}


def _wavernn_options(smi):
    """WaveRNN's step at batch 32, seq_len 1280, RAW: float32, bf16 and
    remat, launches counted over one `voc_train_step`, then timed."""
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.models.wavernn import WaveRNN
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.voc_trainer import (
        voc_micro_loss, voc_train_step)
    cfg = default_config()
    batch = _wavernn_option_batch(cfg)
    torch.manual_seed(0)
    model = WaveRNN.from_config(cfg).to(DEVICE).train()
    optimizer = tc.make_optimizer(model)
    out = {}
    for label, options in (('f32', {}), ('bf16', {'precision': 'bf16'}),
                           ('remat', {'remat': True})):
        train_cfg = dict(cfg['vocoder']['training'], **options)
        half = tc.half_dtype(train_cfg)
        remat = bool(train_cfg.get('remat'))
        _option_counts(reset=True)
        metrics = voc_train_step(model, optimizer, batch, 'RAW',
                                 train_cfg['clip_grad_norm'], half, remat)
        launches = _option_counts()
        _check_launches(launches, f'WaveRNN {label} step',
                        _wavernn_shapes(cfg), batch['x'].shape[0], train_cfg)
        check(math.isfinite(float(metrics['loss'])),
              f'WaveRNN {label}: loss {float(metrics["loss"]):.4f} finite')
        row = step_timing(train_parts(model, optimizer,
                                      voc_micro_loss(model, 'RAW', half,
                                                     remat),
                                      batch, train_cfg),
                          f'WaveRNN {label} step [32, 1280]', smi)
        row['launches'] = launches
        out[label] = row
    return out


def _wavernn_trainer_run(smi):
    """`VocTrainer.train` in bf16 with remat for OPTIONS_STEPS steps at
    batch 32 on phase 10's synthetic dataset (mel/ and quant/, no GTA), one
    generate_samples call at the trainer's fold: counts zeroed just before
    and read just after (#2/#3 in bf16, twice a GRU under remat; #1 in
    evaluate(); #4 in generate_samples)."""
    from forwardtacotron_tpu_torch import config
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.dsp.audio import DSP
    from forwardtacotron_tpu_torch.kernels.wavernn_sample import sample
    from forwardtacotron_tpu_torch.models.wavernn import WaveRNN
    from forwardtacotron_tpu_torch.train.voc_trainer import VocTrainer
    from forwardtacotron_tpu_torch.utils.paths import Paths
    base = (OPTIONS_DIR / 'vocoder').resolve()
    base.mkdir(parents=True)
    with _voc_env(base), _patched(
            config.VOCODER_TRAINING, precision='bf16', remat=True,
            schedule=[f'1e-4, {OPTIONS_STEPS}, {VOC_BATCH}'],
            gen_samples_every=OPTIONS_STEPS, num_gen_samples=1):
        cfg = default_config()
        _write_voc_dataset(Path(cfg['data_path']), cfg)
        paths = Paths(cfg['data_path'], cfg['tts_model_id'],
                      voc_id=cfg['voc_model_id'])
        trainer = VocTrainer(paths, DSP.from_config(cfg, DEVICE), cfg,
                             DEVICE)
        torch.manual_seed(0)
        model = WaveRNN.from_config(cfg)
        _option_counts(reset=True)
        sample.launches = 0
        t0 = time.perf_counter()
        step = trainer.train(model, max_steps_override=OPTIONS_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**_option_counts(), 'wavernn_sample': sample.launches}
        train_cfg = cfg['vocoder']['training']
    log(f'  VocTrainer bf16 + remat: {step} steps in {wall:.1f} s (host '
        f'clock, first steps, generate_samples included), launches '
        f'{launches}')
    check(step == OPTIONS_STEPS, f'WaveRNN trainer reached step {step}')
    _check_launches(launches, f'WaveRNN trainer bf16 + remat, {step} steps',
                    _wavernn_shapes(cfg), VOC_BATCH, train_cfg, step)
    check(launches['wavernn_sample'] > 0,
          f'generate_samples in the bf16 + remat run: kernel #4 '
          f'{launches["wavernn_sample"]} launches')
    return {'steps': step, 'wall_s': wall, 'launches': launches}


def _gan_options(smi):
    """The HiFi-GAN V1 and MelGAN steps at batch 16, seg_len 8192, float32
    and bf16, on a synthetic batch (`step_timing`)."""
    from forwardtacotron_tpu_torch import config
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.dsp.audio import DSP
    from forwardtacotron_tpu_torch.models.gan_discriminators import (
        HiFiGANDiscriminators)
    from forwardtacotron_tpu_torch.models.hifigan import make_generator
    from forwardtacotron_tpu_torch.train.hifigan_trainer import (
        disc_step, gen_step, make_gan_optimizer)
    out = {}
    for kind in ('hifigan', 'melgan'):
        with _patched(config.HIFIGAN_MODEL, generator_type=kind):
            cfg = default_config()
        hop, seg = cfg['dsp']['hop_length'], cfg['hifigan']['training'][
            'seg_len']
        rng = np.random.RandomState(7)
        mel = torch.from_numpy((rng.randn(GAN_BATCH, 80, seg // hop) * 2
                                - 5).astype(np.float32)).to(DEVICE)
        y = torch.from_numpy(rng.uniform(-0.5, 0.5, (GAN_BATCH, seg)).astype(
            np.float32)).to(DEVICE)
        wav_to_mel = DSP.from_config(cfg, DEVICE).wav_to_mel_batch
        torch.manual_seed(3)
        gen = make_generator(cfg).to(DEVICE)
        disc = HiFiGANDiscriminators().to(DEVICE)
        gopt, dopt = make_gan_optimizer(gen), make_gan_optimizer(disc)
        for label, half in (('f32', None), ('bf16', torch.bfloat16)):
            d_loss = disc_step(gen, disc, dopt, mel, y, half)
            g = gen_step(gen, disc, gopt, mel, y, wav_to_mel, half)
            check(math.isfinite(float(d_loss))
                  and math.isfinite(float(g['gen_loss'])),
                  f'{kind} {label} step: losses {float(d_loss):.4f} / '
                  f'{float(g["gen_loss"]):.4f} finite')
            out[f'{kind} {label}'] = step_timing(
                [('disc_ms', lambda half=half: disc_step(
                    gen, disc, dopt, mel, y, half)),
                 ('gen_ms', lambda half=half: gen_step(
                     gen, disc, gopt, mel, y, wav_to_mel, half))],
                f'{kind} {label} step [16, 8192]', smi)
    return out


def _train_kernel_bf16_times(smi):
    """#2 and #3 in bf16 at phase 7's training shapes (the student's five,
    the teacher's three, WaveRNN's): ms on the planned path (and #2's
    cooperative path forced on the same inputs where the cluster path is
    planned, which must be slower), the bound at bf16 sizes (gi, the stash
    and dgi/dgh 2 bytes an element, y and dy 4; operations against the
    bf16 peak) and cuDNN in bf16."""
    from forwardtacotron_tpu_torch.kernels import birnn_train as bt
    from forwardtacotron_tpu_torch.kernels.birnn_train import (
        train_backward, train_forward)
    bf16 = torch.bfloat16
    props = torch.cuda.get_device_properties(0)
    rows = []
    for name, cell, T, H, B, lens, S in (
            [(n, c, T, H, 32, ln, 2) for n, c, T, H, ln in
             TRAIN_KERNEL_CASES]
            + [c + (2,) for c in TEACHER_TRAIN_KERNEL_CASES]
            + [c + (1,) for c in VOCODER_TRAIN_KERNEL_CASES]):
        gi, w, b, ln, dy = _train_inputs(cell, T, B, H, lens, seed=H + T,
                                         S=S)
        gi, w = gi.to(bf16), w.to(bf16)
        plans = {k: fn(cell, S, B, H, bf16,
                       props.shared_memory_per_block_optin,
                       props.multi_processor_count)['path']
                 for k, fn in (('fwd', bt.train_forward_plan),
                               ('bwd', bt.train_backward_plan))}
        st = train_forward(cell, gi, w, b, ln, bf16)[1]
        row = {'case': f'{name} {cell} H={H} T={T} B={B}'
                       + (f' S={S}' if S != 2 else '') + ' bfloat16',
               'path': plans['fwd'], 'bwd_path': plans['bwd'],
               'ms_fwd': cuda_ms(lambda: train_forward(cell, gi, w, b, ln,
                                                       bf16), reps=5),
               'ms_bwd': cuda_ms(lambda: train_backward(cell, st, dy, w, ln,
                                                        bf16), reps=5)}
        if plans['fwd'] == 'cluster':
            row['ms_fwd_cooperative'] = cuda_ms(lambda: train_forward(
                cell, gi, w, b, ln, bf16, path='cooperative'), reps=5)
            _faster_than_cooperative(row)
        ng = 4 if cell == 'lstm' else 3
        active = S * sum(min(n, T) for n in lens)
        flops = 2.0 * active * ng * H * H
        small = w.numel() * 2 + (b.numel() + ln.numel()) * 4
        y_elems = B * T * S * H
        fwd_bytes = gi.numel() * 2 + st.numel() * 2 + y_elems * 4 + small
        bwd_bytes = (st.numel() * 2 + dy.numel() * 4
                     + (1 if cell == 'lstm' else 2) * gi.numel() * 2 + small)
        row['bound_ms_fwd'], row['bound_by_fwd'] = bound_ms(fwd_bytes, flops,
                                                            bf16)
        row['bound_ms_bwd'], row['bound_by_bwd'] = bound_ms(bwd_bytes, flops,
                                                            bf16)
        row['library_ms_fwd'], row['library_ms_bwd'] = _cudnn_train_ms(
            cell, T, H, B, S, bf16)
        log(f'  {row["case"]}: fwd {row["ms_fwd"]:.3f} ms ({plans["fwd"]}; '
            + (f'cooperative {row["ms_fwd_cooperative"]:.3f}; '
               if 'ms_fwd_cooperative' in row else '') +
            f'bound {row["bound_ms_fwd"]:.4f} {row["bound_by_fwd"]}, cuDNN '
            f'{row["library_ms_fwd"]:.3f}); bwd {row["ms_bwd"]:.3f} ms '
            f'({plans["bwd"]}; bound {row["bound_ms_bwd"]:.4f} '
            f'{row["bound_by_bwd"]}, cuDNN {row["library_ms_bwd"]:.3f}) | '
            f'{smi}')
        rows.append(row)
    return rows


@phase('training options (full width)')
def options_path():
    """The trainers' options at config.yaml's widths, random weights from
    seeds, in OPTIONS_DIR (cuts: OPTIONS_STEPS steps a trainer run; the
    synthetic datasets of phases 8 and 10):

    1. `ForwardTrainer.train` with bf16, grad_accum 2, remat and EMA
       together, counts zeroed just before and read just after, and the
       async writer's file against a synchronous payload
       (`_student_trainer_run`);
    2. the student's step under each of STUDENT_OPTIONS: launches of
       #2/#3 by dtype, step timing; remat against no remat and bf16
       against float32 gradients on the card (`_student_options`);
    3. the teacher's r=5 B=32 step in float32, bf16 and remat;
    4. WaveRNN's step in float32, bf16 and remat, and `VocTrainer.train`
       in bf16 with remat (#2/#3 in bf16, #1 in evaluate(), #4 in
       generate_samples);
    5. the HiFi-GAN V1 and MelGAN steps in float32 and bf16."""
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.utils.paths import Paths
    smi = nvidia_smi_line()
    shutil.rmtree(OPTIONS_DIR, ignore_errors=True)
    out = {'nvidia_smi': smi}
    try:
        cfg = default_config()
        cfg['data_path'] = str(OPTIONS_DIR / 'data')
        _write_dataset(OPTIONS_DIR / 'data')
        paths = Paths(cfg['data_path'], 'smoke_options', base=OPTIONS_DIR)
        out['student_trainer'] = _student_trainer_run(cfg, paths, smi)
        out['student'] = _student_options(cfg, paths, smi)
        out['teacher'] = _teacher_options(smi)
        out['wavernn'] = _wavernn_options(smi)
        out['wavernn_trainer'] = _wavernn_trainer_run(smi)
        out['gan'] = _gan_options(smi)
    finally:
        shutil.rmtree(OPTIONS_DIR, ignore_errors=True)
    DETAILS['options'] = out
    return out


# ------------------------------------------------------------------- main

# ------------------------------------- FastPitch and teacher synthesis

FP_DIR = Path('smoke_fast_pitch')     # dataset, checkpoints and outputs
FP_STEPS = 5         # an epoch of phase 8's dataset (4 batches of 32), and one
EVAL_N_ITEMS = 6     # utterances of the evaluation corpus
EVAL_SHIFT_CENTS = 100.0
EVAL_F0 = 150.0      # Hz: a flat contour, so that the DTW path cannot pair
                     # frames of equal F0 at other times and hide the shift


def _all_counts(reset=False):
    """Launches of kernels #1, #2 and #3 by path and of #4, zeroed first
    with `reset`."""
    from forwardtacotron_tpu_torch.kernels.wavernn_sample import sample
    if reset:
        sample.launches = 0
    return dict(_train_counts(reset), wavernn_sample=sample.launches)


def _no_dropout(model):
    """Every dropout rate of a FastPitch (its modules' `p`) set to 0."""
    for mod in model.modules():
        if hasattr(mod, 'p'):
            mod.p = 0.0
    return model


def _fp_model_grads(model, batch, device, decisions=None):
    """`_model_grads` for FastPitch: a copy on `device` in train mode with
    every dropout at 0 (a generator is still given), the ReLU decisions of
    its FFT blocks recorded or replayed through `decisions`."""
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.train import common as tc
    cfg = default_config()['fast_pitch']['training']
    m = _no_dropout(copy.deepcopy(model)).to(device).train()
    b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    gen = torch.Generator(device=device).manual_seed(0)
    with (_layer_decisions(decisions) if decisions is not None
          else contextlib.nullcontext()):
        loss, _ = tc.forward_loss(m(b, gen), b, b['pitch'], b['energy'], cfg)
    loss.backward()
    return {k: p.grad.detach().cpu() for k, p in m.named_parameters()}


def _fp_training(smi):
    """`ForwardTrainer.train` with tts_model fast_pitch for FP_STEPS steps
    at batch 32 on phase 8's synthetic dataset: no recurrence kernel
    launched, losses finite, every parameter moved; the step split by
    `step_timing` in float32 and bf16; float32 gradients against the CPU
    with conv1's ReLU decisions replayed. Returns (out, checkpoint)."""
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.data.dataset import get_tts_datasets
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.forward_trainer import (
        ForwardTrainer, batch_to_device)
    from forwardtacotron_tpu_torch.utils.checkpoints import init_tts_model
    from forwardtacotron_tpu_torch.utils.paths import Paths
    cfg = default_config()
    cfg['tts_model'] = 'fast_pitch'
    cfg['data_path'] = str(FP_DIR / 'data')
    _write_dataset(FP_DIR / 'data')
    paths = Paths(cfg['data_path'], 'smoke_fp', base=FP_DIR)
    writer = _Scalars()
    trainer = ForwardTrainer(paths, cfg, DEVICE, writer=writer)
    torch.manual_seed(0)
    model = init_tts_model(cfg).to(DEVICE)
    optimizer = tc.make_optimizer(model)
    before = copy.deepcopy(model.state_dict())
    _all_counts(reset=True)
    t0 = time.perf_counter()
    step = trainer.train(model, optimizer, max_steps_override=FP_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _all_counts()
    log(f'  FastPitch: {step} steps at batch 32 in {wall:.1f} s (host '
        f'clock, first steps and an evaluate() included), launches '
        f'{launches}')
    check(step == FP_STEPS, f'FastPitch trainer reached step {step} == '
                            f'{FP_STEPS}')
    check(sum(launches.values()) == 0,
          f'FastPitch training launched no kernel #1-#4 (no recurrence): '
          f'{launches}')
    losses = [v for tag, v, _ in writer.values if 'Loss' in tag]
    check(any(tag.endswith('/val') for tag, _, _ in writer.values)
          and losses and all(map(math.isfinite, losses)),
          f'FastPitch: {len(losses)} loss scalars (validation included), '
          f'all finite')
    moved = [k for k, p in model.named_parameters()
             if not torch.equal(p.detach(), before[k])]
    n_params = len(list(model.parameters()))
    check(len(moved) == n_params,
          f'{len(moved)} of {n_params} FastPitch parameters moved')
    _, val_set = get_tts_datasets(cfg['data_path'], 32, 1, None)
    batch = batch_to_device(next(b for b in val_set
                                 if b['mel'].shape[1] == 768), DEVICE)
    train_cfg = trainer.train_cfg
    timing = {}
    for name, tcfg in (('f32', train_cfg),
                       ('bf16', dict(train_cfg, precision='bf16'))):
        timing[name] = step_timing(
            _student_parts(model, optimizer, batch, tcfg),
            f'FastPitch step {name} at batch 32, 768 frames', smi)
    grads = _grads_vs_cpu(model, _fp_model_grads, 'FastPitch')
    out = {'steps': step, 'wall_s': wall, 'launches': launches,
           'step_ms': timing, 'grads_vs_cpu': grads}
    return out, paths.forward_checkpoints / 'latest_model.pt'


def _fp_utterance(model, voc, cfg, text, hop):
    """The 920-frame utterance through FastPitch (115 phonemes at 8 frames
    each, `generate_from_series`) into series, decode and vocode by CUDA
    events (the second of two passes); the card's float32 mel against the
    CPU at atol 1e-4 on a short input."""
    from forwardtacotron_tpu_torch import gen_forward
    from forwardtacotron_tpu_torch.models.wavernn import vocode
    ids = gen_forward.text_to_ids(text, cfg)
    x = torch.tensor([ids], device=DEVICE)
    xl = torch.tensor([len(ids)], device=DEVICE)
    max_t = ((8 * len(ids) + 1 + 255) // 256) * 256
    for _ in range(2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        series = model.predict_series(x, x_len=xl)
        ev[1].record()
        gen = model.generate_from_series(
            x, torch.full_like(series['dur'], 8.0), series['pitch'],
            series['energy'], max_t, x_len=xl)
        ev[2].record()
        n = int(gen['mel_len'][0])
        mel = gen['mel_post'][0, :n].T.float().cpu().numpy()
        wav = vocode(voc, mel, pcm16=True)
        ev[3].record()
        ev[3].synchronize()
    rms = float(np.sqrt(np.mean(wav.astype(np.float64) ** 2)))
    check(bool(np.isfinite(mel).all()) and len(wav) == (n - 1) * hop
          and rms > 0, f'FastPitch, 8 frames/phoneme: {len(ids)} ids, {n} '
                       f'frames (bucket {max_t}), {len(wav)} samples')
    row = {'ids': len(ids), 'frames': n, 'bucket': max_t,
           'series_ms': ev[0].elapsed_time(ev[1]),
           'decode_ms': ev[1].elapsed_time(ev[2]),
           'vocode_ms': ev[2].elapsed_time(ev[3]),
           'audio_s': len(wav) / cfg['dsp']['sample_rate']}
    log(f'  FastPitch 8 frames/phoneme stages: {row}')
    short = torch.tensor([ids[:24]])
    d4 = torch.full((1, 24), 4.0)
    zeros = torch.zeros((1, 24))
    ref = copy.deepcopy(model).cpu().generate_from_series(short, d4, zeros,
                                                          zeros, 128)
    got = model.generate_from_series(short.to(DEVICE), d4.to(DEVICE),
                                     zeros.to(DEVICE), zeros.to(DEVICE), 128)
    err = float((got['mel'].cpu() - ref['mel'])[0, :96].abs().max())
    check(err <= 1e-4, f'FastPitch float32 mel, card vs CPU: max err '
                       f'{err:.2e} <= 1e-4')
    row['mel_f32_vs_cpu_max_abs_err'] = err
    return row


def _fp_serving(checkpoint, lines, long_text, smi):
    """The trained FastPitch served: `gen_forward.main` with griffinlim and
    wavernn on the three lines of FP_DIR's sentences.txt (#4 counted, #1
    never), the 920-frame
    utterance (`_fp_utterance`), `TTSServer` with wavernn answering 8
    concurrent requests (`_serve`)."""
    from scipy.io import wavfile
    from forwardtacotron_tpu_torch import gen_forward
    from forwardtacotron_tpu_torch.serving import TTSServer
    model, cfg, _ = gen_forward.load_tts(str(checkpoint), None, DEVICE)
    hop = cfg['dsp']['hop_length']
    out, launches = {}, {}
    for vocoder in ('griffinlim', 'wavernn'):
        with _cwd(FP_DIR):
            _all_counts(reset=True)
            t0 = time.perf_counter()
            paths = gen_forward.main(['--checkpoint', str(checkpoint),
                                      '--seed', '0', '--device', DEVICE,
                                      vocoder])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _all_counts()
            wavs = [wavfile.read(p)[1] for p in paths]
        ok = len(wavs) == len(lines) and all(
            w.dtype == np.int16 and len(w) > 0 and len(w) % hop == 0
            and np.abs(w).max() > 0 for w in wavs)
        want_sampler = vocoder == 'wavernn'
        check(ok and counts['birnn'] == 0
              and (counts['wavernn_sample'] > 0) == want_sampler,
              f'gen_forward FastPitch {vocoder}: {len(wavs)} int16 wavs '
              f'{[len(w) for w in wavs]} in {wall:.2f} s, launches {counts}')
        out[f'gen_forward {vocoder}'] = {'wall_s': wall, 'launches': counts}
        launches = {k: launches.get(k, 0) + v for k, v in counts.items()}
    voc, _ = gen_forward.load_voc(None, cfg, DEVICE, 0)
    out['utterance'] = _fp_utterance(model, voc, cfg, long_text, hop)
    with TTSServer(str(checkpoint), vocoder='wavernn', max_batch=8,
                   max_wait_ms=20.0, device=DEVICE) as srv:
        warm = srv.warmup(batch_sizes=[8])
        _all_counts(reset=True)
        ok, wall, audio_s = _serve(srv, lines, hop, 1)
        counts = _all_counts()
        stats = srv.stats()
    check(ok and stats['completed'] == 8 and counts['birnn'] == 0
          and counts['wavernn_sample'] > 0,
          f'TTSServer FastPitch + wavernn: 8 concurrent requests, int16 of '
          f'the decoded lengths, in {wall:.3f} s ({audio_s:.2f} s of audio), '
          f'batches {list(srv.batch_sizes)}, launches {counts} | {smi}')
    out['server'] = {'warmup_s': warm['seconds'], 'wall_s': wall,
                     'audio_s': audio_s, 'audio_s_per_s': audio_s / wall,
                     'latency_s': stats['latency_s'], 'launches': counts}
    launches = {k: launches.get(k, 0) + v for k, v in counts.items()}
    return out, launches


def _teacher_synthesis(line, smi):
    """The teacher's free-running synthesis at config.yaml's width, random
    seeded weights in a `.pt`: `gen_tacotron.main` with griffinlim and
    wavernn on one line (#1 counted, every launch on the path its plan
    names, #4 in the wavernn run); ms a decoder step and utterances a
    second over 1000 steps; `Tacotron.generate` on the card against the
    CPU (first 16 steps at atol 1e-4, equal n_valid), with the default
    threshold and with one that stops the run."""
    from scipy.io import wavfile
    from forwardtacotron_tpu_torch import gen_tacotron
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.kernels import birnn as kb
    from forwardtacotron_tpu_torch.utils.checkpoints import save_checkpoint
    cfg = default_config()
    torch.manual_seed(0)
    model = gen_tacotron.Tacotron.from_config(cfg)
    checkpoint = (FP_DIR / 'tacotron.pt').resolve()
    save_checkpoint(model, None, cfg, checkpoint, step=0)
    props = torch.cuda.get_device_properties(0)
    plan = kb.inference_plan('gru', 2, 1, 128, torch.float32,
                             props.shared_memory_per_block_optin,
                             props.multi_processor_count)['path']
    out, launches = {}, {}
    for vocoder in ('griffinlim', 'wavernn'):
        with _cwd(FP_DIR):
            _all_counts(reset=True)
            t0 = time.perf_counter()
            paths = gen_tacotron.main(['--checkpoint', str(checkpoint),
                                       '--device', DEVICE, '-i', line,
                                       vocoder])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _all_counts()
            wav = wavfile.read(paths[0])[1]
        want_sampler = vocoder == 'wavernn'
        check(wav.dtype == np.int16 and len(wav) > 0
              and np.abs(wav).max() > 0 and counts['birnn'] == 2
              and counts[f'birnn_{plan}'] == 2
              and counts['birnn_train_fwd'] == 0
              and (counts['wavernn_sample'] > 0) == want_sampler,
              f'gen_tacotron {vocoder}: {len(wav)} samples in {wall:.2f} s, '
              f'launches {counts} (#1 planned {plan})')
        out[f'gen_tacotron {vocoder}'] = {'wall_s': wall, 'launches': counts,
                                          'samples': len(wav)}
        launches = {k: launches.get(k, 0) + v for k, v in counts.items()}

    model = model.to(DEVICE).eval()
    x = torch.tensor([gen_tacotron.text_to_ids(line, cfg)], device=DEVICE)
    model.generate(x, 1000, 1)                 # warm
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t0 = time.perf_counter()
    ev[0].record()
    _, _, _, n_valid = model.generate(x, 1000, 1)
    ev[1].record()
    ev[1].synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    ms = ev[0].elapsed_time(ev[1])
    steps = min(-(-n_valid // 8) * 8, 1000)    # the steps the loop ran
    out['generate'] = {'ids': x.shape[1], 'n_valid': n_valid, 'steps': steps,
                       'ms': ms, 'host_ms': wall_ms, 'ms_per_step': ms / steps,
                       'utterances_per_s': 1e3 / ms}
    log(f'  Tacotron.generate: {x.shape[1]} ids, {n_valid} valid frames of '
        f'{steps} steps in {ms:.1f} ms ({ms / steps:.3f} ms a decoder step, '
        f'{1e3 / ms:.2f} utterances a second) | {smi}')

    cpu = copy.deepcopy(model).cpu()
    xs = x[:, :24]
    rows = {}
    for name, threshold in (('default threshold', None), ('stopping', 1e9)):
        for m in (model, cpu):
            if threshold is not None:
                m.stop_threshold.fill_(threshold)
        got = model.generate(xs, 32, 1)
        ref = cpu.generate(xs.cpu(), 32, 1)
        errs = [float((a[:, :16].cpu() - b[:, :16]).abs().max())
                for a, b in zip(got[:3], ref[:3])]
        check(max(errs) <= 1e-4 and got[3] == ref[3],
              f'Tacotron.generate {name}, card vs CPU, first 16 steps: mel, '
              f'linear, attention max err {errs} <= 1e-4, n_valid '
              f'{got[3]} == {ref[3]}')
        rows[name] = {'max_abs_err': errs, 'n_valid': got[3]}
    out['generate_vs_cpu'] = rows
    return out, launches


def _eval_checks(smi):
    """`eval_tts.main` in wav mode with the DSP and F0 on the card: a
    seeded corpus at a flat EVAL_F0 against itself (MCD 0) and against a
    copy made EVAL_SHIFT_CENTS higher (F0 RMSE within 10 cents of the
    shift), each against the CPU's numbers."""
    from forwardtacotron_tpu_torch import eval_tts
    from forwardtacotron_tpu_torch.config import default_config
    sr = default_config()['dsp']['sample_rate']
    with _cwd(FP_DIR):
        for name, cents in (('eval_ref', 0.0),
                            ('eval_shift', EVAL_SHIFT_CENTS)):
            f0 = EVAL_F0 * 2 ** (cents / 1200)
            _write_corpus(Path(name), sr, EVAL_N_ITEMS, seed=3,
                          contour=lambda t, f0=f0: np.full_like(t, f0))
        out = {}
        for name, gen in (('self', 'eval_ref'), ('shifted', 'eval_shift')):
            for device in (DEVICE, 'cpu'):
                report = Path(f'eval_{name}_{device}.json')
                t0 = time.perf_counter()
                rc = eval_tts.main(['--gen_dir', f'{gen}/wavs',
                                    '--ref_dir', 'eval_ref/wavs',
                                    '--device', device,
                                    '--json', str(report)])
                wall = time.perf_counter() - t0
                summary = json.loads(report.read_text())['summary']
                out[f'{name}_{device}'] = dict(summary, wall_s=wall, rc=rc)
    card, cpu = out[f'self_{DEVICE}'], out['self_cpu']
    check(card['rc'] == 0 and card['n_files'] == EVAL_N_ITEMS
          and card['mcd_db'] == 0.0 and card['f0_rmse_cents'] == 0.0
          and cpu['mcd_db'] == 0.0,
          f'eval_tts on the card, corpus against itself: MCD '
          f'{card["mcd_db"]} dB, F0 RMSE {card["f0_rmse_cents"]} cents, '
          f'{card["n_files"]} files in {card["wall_s"]:.2f} s')
    card, cpu = out[f'shifted_{DEVICE}'], out['shifted_cpu']
    check(abs(card['f0_rmse_cents'] - EVAL_SHIFT_CENTS) <= 10
          and abs(card['f0_rmse_cents'] - cpu['f0_rmse_cents']) <= 0.5
          and abs(card['mcd_db'] - cpu['mcd_db']) <= 1e-2
          and abs(card['vde'] - cpu['vde']) <= 0.01,
          f'eval_tts on the card against a copy {EVAL_SHIFT_CENTS:g} cents '
          f'higher: F0 RMSE {card["f0_rmse_cents"]:.2f} cents (CPU '
          f'{cpu["f0_rmse_cents"]:.2f}), MCD {card["mcd_db"]:.4f} dB (CPU '
          f'{cpu["mcd_db"]:.4f}), VDE {card["vde"]:.4f} (CPU '
          f'{cpu["vde"]:.4f}), {card["wall_s"]:.2f} s (CPU '
          f'{cpu["wall_s"]:.2f} s) | {smi}')
    return out


@phase('FastPitch and teacher synthesis path (full width)')
def fast_pitch_and_teacher_path():
    """FastPitch, the teacher's free-running synthesis and the objective
    evaluation at config.yaml's `fast_pitch`, `tacotron` and `vocoder`
    widths, random weights from seeds, TF32 off, in FP_DIR. Cuts: FastPitch
    trains FP_STEPS steps (config.yaml: 300k) on phase 8's 96 + 32 items;
    the teacher is untrained (its run never stops, so every utterance
    takes the 1000 steps of --steps); the evaluation corpus has
    EVAL_N_ITEMS utterances of 2-8 s.

    1. `_fp_training`: ForwardTrainer with tts_model fast_pitch, counts
       from 0 (no kernel launched), step timing in float32 and bf16,
       gradients against the CPU;
    2. `_fp_serving`: gen_forward griffinlim and wavernn on its
       checkpoint (#4 counted), the 920-frame utterance, TTSServer;
    3. `_teacher_synthesis`: gen_tacotron griffinlim and wavernn (#1 and
       #4 counted), decoder step times, card against CPU;
    4. `_eval_checks`: eval_tts on the card against the CPU."""
    smi = nvidia_smi_line()
    lines = [s for s in Path('sentences.txt').read_text().splitlines()
             if s.strip()]
    shutil.rmtree(FP_DIR, ignore_errors=True)
    FP_DIR.mkdir(parents=True)
    (FP_DIR / 'sentences.txt').write_text('\n'.join(lines[:3]) + '\n')
    out = {}
    try:
        out['training'], checkpoint = _fp_training(smi)
        out['serving'], fp_launches = _fp_serving(checkpoint.resolve(),
                                                  lines[:3], lines[-1], smi)
        out['teacher'], taco_launches = _teacher_synthesis(lines[0], smi)
        out['evaluation'] = _eval_checks(smi)
    finally:
        shutil.rmtree(FP_DIR, ignore_errors=True)
    train = out['training']['launches']
    out['launches'] = {
        'fast_pitch': {k: train[k] + fp_launches.get(k, 0) for k in train},
        'gen_tacotron': taco_launches}
    DETAILS['fast_pitch_and_teacher_path'] = out
    return out['launches']


# ------------------------------------ speakers and the teacher-free aligner

MS_DIR = Path('smoke_speakers')      # corpus, data, checkpoints and outputs
MS_SPEAKERS = 8
MS_UTTERANCES = 5 * MS_SPEAKERS      # five utterances of 2-8 s a speaker
MS_TEACHER_SCHEDULE = ['5, 1e-3, 2, 32']    # config.yaml's first session
MS_ALIGNER_SCHEDULE = ['1e-3, 3, 32']       # config.yaml's first session
MS_STUDENT_STEPS = 3
DM_STEPS = 1000                      # DeepMind WaveRNN generate steps


@contextlib.contextmanager
def _speaker_env(base):
    """`_teacher_env(base)` with the built-in config's teacher, student and
    FastPitch at MS_SPEAKERS speakers and the teacher's and the aligner's
    schedules cut to MS_TEACHER_SCHEDULE and MS_ALIGNER_SCHEDULE, in
    memory (the CLIs read the built-in config)."""
    from forwardtacotron_tpu_torch import config
    with _teacher_env(base), \
            _patched(config.TACOTRON_MODEL, n_speakers=MS_SPEAKERS), \
            _patched(config.FORWARD_TACOTRON_MODEL, n_speakers=MS_SPEAKERS), \
            _patched(config.FAST_PITCH_MODEL, n_speakers=MS_SPEAKERS), \
            _patched(config.TACOTRON_TRAINING, schedule=MS_TEACHER_SCHEDULE), \
            _patched(config.ALIGNER_TRAINING, schedule=MS_ALIGNER_SCHEDULE,
                     checkpoint_every=1000):
        yield


def _ms_corpus(cfg, smi):
    """`_write_corpus`'s wavs with `id|speaker_<k>|text` metadata, k the
    line's index mod MS_SPEAKERS, through `preprocess.main(...,
    '--metadata_format', 'multispeaker')` on the card; speaker_dict.pkl
    checked item by item."""
    from forwardtacotron_tpu_torch import preprocess
    from forwardtacotron_tpu_torch.utils.files import unpickle_binary
    sr = cfg['dsp']['sample_rate']
    items = _write_corpus(Path('corpus'), sr, n_items=MS_UTTERANCES, seed=3)
    meta = Path('corpus') / 'metadata.csv'
    want = {}
    lines = []
    for k, line in enumerate(meta.read_text().splitlines()):
        item, text, _ = line.split('|')
        want[item] = k % MS_SPEAKERS
        lines.append(f'{item}|speaker_{k % MS_SPEAKERS}|{text}')
    meta.write_text('\n'.join(lines) + '\n')
    audio_s = sum(n for n, _ in items.values()) / sr
    t0 = time.perf_counter()
    train, val = preprocess.main(['--path', 'corpus', '--num_workers', '4',
                                  '--device', DEVICE, '--metadata_format',
                                  'multispeaker'])
    wall = time.perf_counter() - t0
    got = unpickle_binary(Path(cfg['data_path']) / 'speaker_dict.pkl')
    check(got == want and len(train) + len(val) == MS_UTTERANCES,
          f'multispeaker preprocess: {len(train)} train / {len(val)} val, '
          f'speaker_dict.pkl of {len(got)} items and '
          f'{len(set(got.values()))} speakers, each its line\'s')
    log(f'  preprocess: {len(items)} files, {audio_s:.1f} s of audio in '
        f'{wall:.2f} s | {smi}')
    return {'files': len(items), 'audio_s': audio_s, 'wall_s': wall,
            'speakers': len(set(got.values()))}


def _ms_teacher(cfg, paths, smi):
    """The teacher at MS_SPEAKERS speakers: `TacoTrainer.train` on
    MS_TEACHER_SCHEDULE (#2/#3 two a step on their planned paths), the step
    at r=5 B=32 on the longest bucket (`step_timing`), then `train_tacotron
    --force_align` (#1 two a batch, every duration sum its mel_len;
    utterances a second). Returns (out, launches)."""
    from forwardtacotron_tpu_torch import train_tacotron
    from forwardtacotron_tpu_torch.data.dataset import get_tts_datasets
    from forwardtacotron_tpu_torch.models.tacotron import Tacotron
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.taco_trainer import (
        TacoTrainer, taco_batch_to_device, taco_micro_loss)
    from forwardtacotron_tpu_torch.utils.files import unpickle_binary
    writer = _Scalars()
    torch.manual_seed(0)
    model = Tacotron.from_config(cfg).to(DEVICE)
    optimizer = tc.make_optimizer(model)
    before = copy.deepcopy(model.state_dict())
    _all_counts(reset=True)
    step = TacoTrainer(paths, cfg, DEVICE, writer=writer).train(model,
                                                                optimizer)
    train = _all_counts()
    want = _planned_launches(_teacher_shapes(cfg), 32, torch.float32, step,
                             step)
    losses = [v for tag, v, _ in writer.values if tag == 'Loss/train']
    moved = sum(not torch.equal(p.detach(), before[k])
                for k, p in model.named_parameters())
    check(step == 2 and all(train[k] == n for k, n in want.items())
          and len(losses) == step
          and all(map(math.isfinite, losses))
          and moved == len(list(model.parameters())),
          f'{MS_SPEAKERS}-speaker teacher: {step} steps, #2/#3 by path '
          f'{train} == planned {want}, losses {losses}, {moved} parameters '
          f'moved (speaker_embedding and speaker_proj among them)')
    train_set, _ = get_tts_datasets(paths.data, 32, 5, None,
                                    filter_attention=False,
                                    model_type='tacotron')
    batch = taco_batch_to_device(max(train_set.batches(0),
                                     key=lambda b: b['mel'].shape[1]), DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    train_cfg = cfg['tacotron']['training']
    timing = step_timing(
        train_parts(model, optimizer,
                    taco_micro_loss(model, 5, gen, train_cfg), batch,
                    train_cfg),
        f'{MS_SPEAKERS}-speaker teacher step r=5 B=32 '
        f'{list(batch["mel"].shape)}', smi)
    timing['batch'] = list(batch['mel'].shape)
    timing['single_speaker'] = _single_speaker_timing(
        Tacotron, cfg, 'tacotron', batch,
        lambda m, o, b: train_parts(m, o, taco_micro_loss(m, 5, gen,
                                                          train_cfg),
                                    b, train_cfg), 'teacher', smi)

    items = dict(unpickle_binary(paths.data / 'train_dataset.pkl')
                 + unpickle_binary(paths.data / 'val_dataset.pkl'))
    sets = get_tts_datasets(paths.data, 8, 1, None, filter_attention=False,
                            model_type='tacotron')
    n_batches = sum(len(s) for s in sets)
    _all_counts(reset=True)
    t0 = time.perf_counter()
    train_tacotron.main(['--force_align', '--device', DEVICE])
    wall = time.perf_counter() - t0
    align = _all_counts()
    bad = [i for i, n in items.items()
           if int(np.load(paths.alg / f'{i}.npy').sum()) != n]
    check(align['birnn'] == 2 * n_batches and align['birnn_train_fwd'] == 0
          and not bad,
          f'{MS_SPEAKERS}-speaker teacher --force_align: #1 launched '
          f'{align["birnn"]} times for {n_batches} batches; durations of '
          f'{len(items)} utterances sum to their mel_len (off: {bad})')
    log(f'  teacher alignment: {len(items)} utterances in {wall:.2f} s '
        f'({len(items) / wall:.2f} a second, host clock) | {smi}')
    out = {'steps': step, 'losses': losses, 'launches': train,
           'step_ms': timing,
           'align': {'launches': align, 'wall_s': wall,
                     'utterances_per_s': len(items) / wall}}
    return out, {k: train[k] + align[k] for k in train}


def _single_speaker_timing(build, cfg, section, batch, parts, what, smi):
    """`step_timing` of `parts(model, optimizer, batch)` for a
    single-speaker model of `cfg[section]` (seeded 0) on the same batch
    without its `speaker`: the multi-speaker step's yardstick in the same
    call."""
    from forwardtacotron_tpu_torch.train import common as tc
    one = copy.deepcopy(cfg)
    one[section]['model']['n_speakers'] = 1
    torch.manual_seed(0)
    model = build.from_config(one).to(DEVICE)
    plain = {k: v for k, v in batch.items() if k != 'speaker'}
    return step_timing(parts(model, tc.make_optimizer(model), plain),
                       f'single-speaker {what} step on the same batch', smi)


def _aligner_parts(model, optimizer, batch, clip, gen):
    """The aligner's step as `aligner_train_step` runs it, for
    `step_timing`: the encoders and the distances, the forward-sum dynamic
    program, the backward (both), the clip and Adam."""
    from forwardtacotron_tpu_torch.align.aligner import forward_sum_loss
    from forwardtacotron_tpu_torch.train import common as tc
    held = {}

    def encoders():
        model.train()
        optimizer.zero_grad(set_to_none=True)
        held['la'] = model(batch['x'], batch['mel'], batch['x_len'], gen)

    def dp():
        held['loss'] = forward_sum_loss(held.pop('la'), batch['x_len'],
                                        batch['mel_len'])
    return [('encoders_ms', encoders), ('dp_ms', dp),
            ('backward_ms', lambda: held.pop('loss').backward()),
            ('optimizer_ms', lambda: tc.apply_update(model, optimizer, {},
                                                     clip))]


def _ms_aligner(cfg, paths, smi):
    """`train_aligner.main` on MS_ALIGNER_SCHEDULE (batch 32), then
    `--force_align`: no kernel launched, counted from 0; the checkpoint at
    its step with every parameter moved from the seeded start and a finite
    validation loss; durations summing to mel_len; the step at batch 32 on
    the longest bucket (`step_timing`, the dynamic program's share of it
    with its backward); on one batch, the card against the CPU with the
    same weights: Viterbi durations equal as integers, the forward-sum
    loss and every parameter's gradient within 1e-4. Returns (out,
    launches)."""
    from forwardtacotron_tpu_torch import train_aligner
    from forwardtacotron_tpu_torch.align.aligner import (
        aligner_from_config, forward_sum_loss, viterbi_durations)
    from forwardtacotron_tpu_torch.data.dataset import get_tts_datasets
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.aligner_trainer import (
        aligner_batch_to_device, aligner_eval_loss)
    from forwardtacotron_tpu_torch.utils.checkpoints import (load_checkpoint,
                                                             restore)
    from forwardtacotron_tpu_torch.utils.files import unpickle_binary
    items = dict(unpickle_binary(paths.data / 'train_dataset.pkl')
                 + unpickle_binary(paths.data / 'val_dataset.pkl'))
    _all_counts(reset=True)
    t0 = time.perf_counter()
    step = train_aligner.main(['--device', DEVICE])
    train_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_aligner.main(['--force_align', '--device', DEVICE])
    wall = time.perf_counter() - t0
    launches = _all_counts()
    check(step == 3 and sum(launches.values()) == 0,
          f'train_aligner to step {step} == 3 and --force_align launched no '
          f'kernel #1-#4 (no recurrence): {launches}')
    torch.manual_seed(train_aligner.SEED)
    start = aligner_from_config(cfg)
    model = aligner_from_config(cfg)
    payload = load_checkpoint(paths.aligner_checkpoints / 'latest_model.pt')
    restore(model, None, payload)
    moved = sum(not torch.equal(p, q) for p, q in
                zip(model.parameters(), start.parameters()))
    model.to(DEVICE)
    sets = get_tts_datasets(paths.data, 8, 1, None, filter_attention=False,
                            model_type='tacotron')
    val = aligner_eval_loss(model, sets[1], DEVICE)
    bad = [i for i, n in items.items()
           if int(np.load(paths.alg / f'{i}.npy').sum()) != n]
    check(payload['step'] == 3 and moved == len(list(model.parameters()))
          and math.isfinite(val) and not bad,
          f'aligner checkpoint at step {payload["step"]}: {moved} parameters '
          f'moved, validation loss {val:.4f}, durations of {len(items)} '
          f'utterances sum to their mel_len (off: {bad})')
    log(f'  aligner: trained and aligned in {train_wall:.2f} s; '
        f'--force_align {len(items)} utterances in {wall:.2f} s '
        f'({len(items) / wall:.2f} a second, host clock) | {smi}')

    train_set, _ = get_tts_datasets(paths.data, 32, 1, 1250,
                                    filter_attention=False,
                                    model_type='tacotron')
    batch = aligner_batch_to_device(max(train_set.batches(0),
                                        key=lambda b: b['mel'].shape[1]),
                                    DEVICE)
    optimizer = tc.make_optimizer(model)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    timing = step_timing(_aligner_parts(model, optimizer, batch, 1.0, gen),
                         f'aligner step B=32 {list(batch["mel"].shape)}',
                         smi)
    model.eval()
    with torch.no_grad():
        la = model(batch['x'], batch['mel'], batch['x_len'])
    la.requires_grad_()
    dp_ms = cuda_ms(lambda: forward_sum_loss(la, batch['x_len'],
                                             batch['mel_len']).backward(),
                    reps=3)
    timing.update(batch=list(batch['mel'].shape), dp_fwd_bwd_ms=dp_ms,
                  dp_share=dp_ms / timing['step_ms'])
    log(f'  aligner DP forward + backward {dp_ms:.2f} ms of a '
        f'{timing["step_ms"]:.2f} ms step ({dp_ms / timing["step_ms"]:.3f})')

    # one batch, card against CPU, the same weights, eval mode
    b = next(iter(sets[1]))
    cpu = copy.deepcopy(model).cpu().eval()
    errs, durs = {}, []
    grads = []
    for m, dev in ((model, DEVICE), (cpu, 'cpu')):
        t = aligner_batch_to_device(b, dev)
        m.zero_grad(set_to_none=True)
        la = m(t['x'], t['mel'], t['x_len'])
        loss = forward_sum_loss(la, t['x_len'], t['mel_len'])
        loss.backward()
        durs.append(viterbi_durations(la.detach(), t['x_len'],
                                      t['mel_len']).cpu())
        grads.append((float(loss.detach()),
                      {k: p.grad.cpu() for k, p in m.named_parameters()}))
    errs['loss'] = abs(grads[0][0] - grads[1][0])
    errs['grad'] = max(float((grads[0][1][k] - grads[1][1][k]).abs().max())
                       for k in grads[1][1])
    same = bool(torch.equal(durs[0], durs[1]))
    check(same and errs['loss'] <= 1e-4 and errs['grad'] <= 1e-4,
          f'aligner on a batch of {tuple(b["mel"].shape)}, card vs CPU: '
          f'Viterbi durations equal {same}, forward-sum loss error '
          f'{errs["loss"]:.2e}, largest gradient error {errs["grad"]:.2e} '
          f'(both <= 1e-4)')
    out = {'steps': step, 'train_and_align_wall_s': train_wall,
           'val_loss': val, 'launches': launches, 'step_ms': timing,
           'align': {'wall_s': wall, 'utterances_per_s': len(items) / wall},
           'card_vs_cpu': dict(errs, durations_equal=same)}
    return out, launches


def _ms_student(cfg, paths, smi):
    """`ForwardTrainer.train` at MS_SPEAKERS speakers for MS_STUDENT_STEPS
    steps at batch 32 on the aligner's durations (#2/#3 on their planned
    paths), its step at batch 32 on the longest bucket (`step_timing`), the
    float32 teacher-forced eval outputs of two items card vs CPU. Returns
    (out, launches, checkpoint)."""
    from forwardtacotron_tpu_torch.data.dataset import get_tts_datasets
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.forward_trainer import (
        ForwardTrainer, batch_to_device)
    cfg['forward_tacotron']['training']['filter_attention'] = False
    writer = _Scalars()
    trainer = ForwardTrainer(paths, cfg, DEVICE, writer=writer)
    torch.manual_seed(0)
    model = ForwardTacotron.from_config(cfg).to(DEVICE)
    optimizer = tc.make_optimizer(model)
    _all_counts(reset=True)
    step = trainer.train(model, optimizer,
                         max_steps_override=MS_STUDENT_STEPS)
    launches = _all_counts()
    want = _planned_launches(_student_shapes(cfg), 32, torch.float32, step,
                             step)
    losses = [v for tag, v, _ in writer.values if tag == 'Mel_Loss/train']
    check(step == MS_STUDENT_STEPS
          and all(launches[k] == n for k, n in want.items())
          and len(losses) == step and all(map(math.isfinite, losses)),
          f'{MS_SPEAKERS}-speaker student on the aligner\'s durations: '
          f'{step} steps, #2/#3 by path {launches} == planned {want}, mel '
          f'losses {losses}')
    train_set, val_set = get_tts_datasets(
        paths.data, 32, 1, None, filter_attention=False)
    batch = batch_to_device(max(train_set.batches(0),
                                key=lambda b: b['mel'].shape[1]), DEVICE)
    timing = step_timing(_student_parts(model, optimizer, batch,
                                        trainer.train_cfg),
                         f'{MS_SPEAKERS}-speaker student step B=32 '
                         f'{list(batch["mel"].shape)}', smi)
    timing['batch'] = list(batch['mel'].shape)
    timing['single_speaker'] = _single_speaker_timing(
        ForwardTacotron, cfg, 'forward_tacotron', batch,
        lambda m, o, b: _student_parts(m, o, b, trainer.train_cfg),
        'student', smi)

    b = next(iter(val_set))
    two = {k: torch.from_numpy(np.asarray(b[k])[:2])
           for k in ('x', 'x_len', 'mel', 'mel_len', 'dur', 'pitch',
                     'energy', 'speaker')}
    cpu = copy.deepcopy(model).cpu().eval()
    model.eval()
    with torch.no_grad():
        got = model({k: v.to(DEVICE) for k, v in two.items()})
        ref = cpu(two)
    errs = {k: float((got[k].cpu() - ref[k]).abs().max()
                     / max(1.0, float(ref[k].abs().max())))
            for k in ('mel', 'mel_post', 'dur', 'pitch', 'energy')}
    check(max(errs.values()) <= 1e-4,
          f'{MS_SPEAKERS}-speaker student eval forward of speakers '
          f'{two["speaker"].tolist()}, card vs CPU: max abs errors over '
          f'max(1, |ref|) {errs} <= 1e-4')
    out = {'steps': step, 'mel_losses': losses, 'launches': launches,
           'step_ms': timing, 'card_vs_cpu': errs}
    return out, launches, paths.forward_checkpoints / 'latest_model.pt'


def _serve_speakers(srv, lines, speakers):
    """len(speakers) concurrent requests from threads, request i in the
    voice speakers[i]: (results, wall seconds)."""
    import threading
    results = [None] * len(speakers)

    def client(i):
        results[i] = srv.synthesize(lines[i % len(lines)],
                                    speaker=speakers[i], timeout=300)
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(speakers))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return results, time.perf_counter() - t0


def _ms_serving(student_ckpt, teacher_ckpt, lines, smi):
    """`gen_forward.main` wavernn with --speaker 0 and 5 (#1 and #4 > 0,
    the two voices' mels differ), `gen_tacotron.main` griffinlim with
    --speaker 3 (#1 two), and `TTSServer`: 8 concurrent requests of the 8
    voices with WaveRNN (wall time, audio seconds a second, #1 and #4),
    and in float32 with the vocoder stage handing the mels through, each
    request's mel against its solo run's at atol 1e-4. Returns (out,
    launches)."""
    from scipy.io import wavfile
    from forwardtacotron_tpu_torch import gen_forward, gen_tacotron
    from forwardtacotron_tpu_torch.serving import TTSServer
    out, launches = {}, {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    for spk in ('0', '5'):
        _all_counts(reset=True)
        t0 = time.perf_counter()
        (path,) = gen_forward.main(['--checkpoint', str(student_ckpt),
                                    '--device', DEVICE, '--speaker', spk,
                                    '-i', lines[0], 'wavernn'])
        wall = time.perf_counter() - t0
        counts = _all_counts()
        wav = wavfile.read(path)[1]
        check(wav.dtype == np.int16 and len(wav) > 0 and counts['birnn'] > 0
              and counts['wavernn_sample'] > 0,
              f'gen_forward --speaker {spk} wavernn: {len(wav)} samples in '
              f'{wall:.2f} s, launches {counts}')
        out[f'gen_forward speaker {spk}'] = {'wall_s': wall,
                                             'launches': counts}
        add(counts)
    model, cfg, _ = gen_forward.load_tts(str(student_ckpt), None, DEVICE)
    ids = gen_forward.text_to_ids(lines[0], cfg)
    mels = [gen_forward.synthesize(model, ids, speaker=s) for s in (0, 5)]
    differ = mels[0].shape != mels[1].shape or float(
        np.abs(mels[0] - mels[1]).max()) > 1e-3
    check(differ, f'speakers 0 and 5 give different mels '
                  f'{mels[0].shape} / {mels[1].shape}')

    _all_counts(reset=True)
    (path,) = gen_tacotron.main(['--checkpoint', str(teacher_ckpt),
                                 '--device', DEVICE, '--speaker', '3', '-i',
                                 lines[0], 'griffinlim'])
    counts = _all_counts()
    wav = wavfile.read(path)[1]
    check(wav.dtype == np.int16 and len(wav) > 0 and counts['birnn'] == 2,
          f'gen_tacotron --speaker 3 griffinlim: {len(wav)} samples, '
          f'launches {counts}')
    out['gen_tacotron speaker 3'] = {'launches': counts}
    add(counts)

    speakers = list(range(MS_SPEAKERS))
    with TTSServer(str(student_ckpt), vocoder='wavernn', max_batch=8,
                   max_wait_ms=20.0, device=DEVICE) as srv:
        warm = srv.warmup(batch_sizes=[8])
        _serve_speakers(srv, lines, speakers)      # the vocoder's shapes
        _all_counts(reset=True)
        srv.batch_sizes.clear()
        results, wall = _serve_speakers(srv, lines, speakers)
        counts = _all_counts()
        sizes = list(srv.batch_sizes)
    audio_s = sum(len(r) for r in results if r is not None) / srv.sample_rate
    check(all(r is not None and r.dtype == np.int16 and len(r) > 0
              for r in results) and counts['birnn'] > 0
          and counts['wavernn_sample'] > 0,
          f'TTSServer wavernn, 8 concurrent requests of speakers {speakers}: '
          f'{wall:.3f} s, {audio_s:.2f} s of audio, batches {sizes}, '
          f'launches {counts} | {smi}')
    out['server'] = {'warmup_s': warm['seconds'], 'wall_s': wall,
                     'audio_s': audio_s, 'audio_s_per_s': audio_s / wall,
                     'batch_sizes': sizes, 'launches': counts}
    add(counts)

    with TTSServer(str(student_ckpt), vocoder='griffinlim', max_batch=8,
                   max_wait_ms=200.0, device=DEVICE,
                   compute_dtype=torch.float32) as srv:
        srv._vocode = lambda ms: [m.copy() for m in ms]
        srv.warmup(batch_sizes=[1, 8], vocoder=False)
        srv.batch_sizes.clear()
        futs = [srv.submit(lines[i % len(lines)], speaker=s)
                for i, s in enumerate(speakers)]
        batched = [f.result(timeout=300) for f in futs]
        sizes = list(srv.batch_sizes)
        errs = []
        for i, s in enumerate(speakers):
            solo = srv.synthesize(lines[i % len(lines)], speaker=s,
                                  timeout=300)
            errs.append(float(np.abs(batched[i] - solo).max())
                        if batched[i].shape == solo.shape else math.inf)
    check(sizes[0] == 8 and max(errs) <= 1e-4,
          f'TTSServer float32, 8 voices in batches {sizes}: each mel vs its '
          f'solo run max abs error {max(errs):.2e} <= 1e-4')
    out['server_vs_solo'] = {'batch_sizes': sizes, 'max_abs_err': errs}
    return out, launches


def _ms_fast_pitch(lines, smi):
    """FastPitch at MS_SPEAKERS speakers, random seeded weights: `generate`
    of 8 lines in the 8 voices on the card against the CPU (equal
    mel_len, mel within 1e-4 of max(1, |ref|))."""
    from forwardtacotron_tpu_torch import gen_forward
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.models.fast_pitch import FastPitch
    cfg = default_config()
    torch.manual_seed(0)
    model = FastPitch.from_config(cfg).eval()
    ids = [gen_forward.text_to_ids(lines[i % len(lines)], cfg)
           for i in range(MS_SPEAKERS)]
    x = torch.zeros((MS_SPEAKERS, max(map(len, ids))), dtype=torch.long)
    for i, seq in enumerate(ids):
        x[i, :len(seq)] = torch.tensor(seq)
    x_len = torch.tensor([len(s) for s in ids])
    spk = torch.arange(MS_SPEAKERS)
    ref = model.generate(x, 1024, x_len=x_len, speaker=spk)
    card = copy.deepcopy(model).to(DEVICE)
    got = card.generate(x.to(DEVICE), 1024, x_len=x_len.to(DEVICE),
                        speaker=spk.to(DEVICE))
    same = torch.equal(got['mel_len'].cpu(), ref['mel_len'])
    err = max(float((got['mel_post'][i, :n].cpu() - ref['mel_post'][i, :n])
                    .abs().max()) for i, n in enumerate(ref['mel_len']))
    scale = max(1.0, float(ref['mel_post'].abs().max()))
    check(same and err <= 1e-4 * scale,
          f'{MS_SPEAKERS}-speaker FastPitch generate of speakers 0-7, card vs '
          f'CPU: mel_len {ref["mel_len"].tolist()} equal {same}, mel max '
          f'abs error {err:.2e} <= {1e-4 * scale:.2e} | {smi}')
    return {'mel_len': ref['mel_len'].tolist(), 'max_abs_err': err}


def _deepmind(smi):
    """The DeepMind WaveRNN at hidden 896 and 256 classes, random seeded
    weights: the step on the card against the CPU at atol 1e-5; DM_STEPS
    generate steps timed by CUDA events (one seed twice: the same
    samples)."""
    from forwardtacotron_tpu_torch.models.deepmind_wavernn import (
        DeepMindWaveRNN)
    torch.manual_seed(0)
    model = DeepMindWaveRNN()
    with torch.no_grad():
        for b in (model.bias_u, model.bias_r, model.bias_e):
            b.normal_(0, 0.3)
    g = torch.Generator().manual_seed(1)
    prev_y = torch.rand(4, 2, generator=g) * 2 - 1
    hidden = torch.randn(4, model.hidden_size, generator=g)
    cur = torch.rand(4, 1, generator=g) * 2 - 1
    with torch.no_grad():
        ref = model(prev_y, hidden, cur)
        card = copy.deepcopy(model).to(DEVICE)
        got = card(prev_y.to(DEVICE), hidden.to(DEVICE), cur.to(DEVICE))
    errs = [float((a.cpu() - b).abs().max()) for a, b in zip(got, ref)]
    check(max(errs) <= 1e-5, f'DeepMind WaveRNN step card vs CPU: coarse, '
                             f'fine, hidden max abs error {errs} <= 1e-5')

    def run(seed):
        return card.generate(DM_STEPS,
                             torch.Generator(device=DEVICE).manual_seed(seed))
    run(0)                                     # warm
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    c, f = run(7)
    ev[1].record()
    ev[1].synchronize()
    ms = ev[0].elapsed_time(ev[1])
    c2, f2 = run(7)
    same = bool(torch.equal(c, c2) and torch.equal(f, f2))
    check(same and c.shape == (1, DM_STEPS) and int(c.max()) < 256
          and int(f.max()) < 256,
          f'DeepMind WaveRNN generate {DM_STEPS} steps in {ms:.1f} ms '
          f'({ms / DM_STEPS:.3f} ms a step), same seed same samples {same} '
          f'| {smi}')
    return {'step_max_abs_err': errs, 'generate_ms': ms,
            'ms_per_step': ms / DM_STEPS, 'steps': DM_STEPS}


@phase('speakers and the teacher-free aligner (full width)')
def speakers_and_aligner_path():
    """Multi-speaker training and synthesis, the teacher-free aligner and
    the DeepMind WaveRNN at config.yaml's widths, random weights from
    seeds, in MS_DIR. Cuts: MS_SPEAKERS speakers of MS_UTTERANCES // 8
    utterances of 2-8 s each (VCTK: 109 speakers, ~400 each), n_val
    TEACHER_N_VAL, the teacher on MS_TEACHER_SCHEDULE (2 steps at r=5
    batch 32 against config.yaml's 40k), the aligner on
    MS_ALIGNER_SCHEDULE (3 steps at batch 32 against 15k), the student
    MS_STUDENT_STEPS steps (300k) without the attention filter.

    1. `_ms_corpus`: `id|speaker|text` metadata through `preprocess`;
    2. `_ms_teacher`: TacoTrainer (#2/#3 planned), its step, --force_align
       (#1);
    3. `_ms_aligner`: train_aligner and --force_align (no kernel), its
       step and the DP's share, card against CPU;
    4. `_ms_student`: ForwardTrainer on the aligner's durations (#2/#3
       planned), its step, card against CPU;
    5. `_ms_serving`: gen_forward --speaker, gen_tacotron --speaker,
       TTSServer with mixed voices;
    6. `_ms_fast_pitch`: FastPitch generate card against CPU;
    7. `_deepmind`: the DeepMind WaveRNN."""
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.utils.paths import Paths
    smi = nvidia_smi_line()
    lines = [s for s in Path('sentences.txt').read_text().splitlines()
             if s.strip()]
    shutil.rmtree(MS_DIR, ignore_errors=True)
    MS_DIR.mkdir(parents=True)
    base = MS_DIR.resolve()
    (base / 'sentences.txt').write_text(Path('sentences.txt').read_text())
    out = {}
    try:
        with _speaker_env(base):
            cfg = default_config()
            paths = Paths(cfg['data_path'], cfg['tts_model_id'])
            out['preprocess'] = _ms_corpus(cfg, smi)
            out['teacher'], teacher = _ms_teacher(cfg, paths, smi)
            out['aligner'], aligner = _ms_aligner(cfg, paths, smi)
            out['student'], student, ckpt = _ms_student(cfg, paths, smi)
            out['serving'], serving = _ms_serving(
                ckpt.resolve(), paths.taco_checkpoints / 'latest_model.pt',
                lines, smi)
            out['fast_pitch'] = _ms_fast_pitch(lines, smi)
        out['deepmind'] = _deepmind(smi)
    finally:
        shutil.rmtree(MS_DIR, ignore_errors=True)
    out['launches'] = {
        'multispeaker': {k: teacher[k] + student[k] + serving.get(k, 0)
                         for k in teacher},
        'aligner': aligner}
    DETAILS['speakers_and_aligner_path'] = out
    return out['launches']


# --------------------------------------------------- export and fused path

EXPORT_DIR = Path('model_outputs/smoke_export')   # artifacts, vocoder files
FUSED_MAX_T = 1024           # TTSServer's and serve_forward's default
EXPORT_BUCKET = '64:512'


def _fused_batch(srv, texts, seed, knobs=None):
    """(tx, B, the seven host inputs) of the fused program for `texts` as
    the server pads a batch (`knobs`: (alpha, pitch_scale, energy_scale)
    per text, 1 where None)."""
    from forwardtacotron_tpu_torch.serving import _Request
    knobs = knobs or [(1.0, 1.0, 1.0)] * len(texts)
    reqs = [_Request(t, *k) for t, k in zip(texts, knobs)]
    ids = [srv.tokenizer(srv.cleaner(t)) for t in texts]
    x, x_lens, scale = srv._padded_batch(reqs, ids, srv.text_bucket)
    B, tx = x.shape
    return tx, B, [x, x_lens, scale[0], scale[1], scale[2],
                   np.zeros((B,), np.int64), np.asarray(seed, np.int64)]


def _kernel_counts_now():
    """Every kernel's launches by path under
    `utils/profiling.kernel_launches`' keys."""
    from forwardtacotron_tpu_torch.utils.profiling import KERNEL_NAMES
    counts = _all_counts()
    return {k: counts[k] for k in KERNEL_NAMES.values()}


def _concurrent(srv, lines, hop):
    """8 concurrent requests of mixed alpha / pitch_scale (phase 6's):
    every answer int16, non-empty and a whole number of hops."""
    import threading
    results = [None] * 8
    alphas = (1.0, 1.2, 0.9, 1.1, 1.0, 0.8, 1.3, 1.0)
    pitches = (1.0, 0.9, 1.1, 1.0, 1.2, 1.0, 0.8, 1.05)

    def client(i):
        results[i] = srv.synthesize(lines[i % len(lines)], alpha=alphas[i],
                                    pitch_scale=pitches[i], timeout=300)
    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    srv.batch_sizes.clear()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    ok = all(r is not None and r.dtype == np.int16 and len(r) > 0
             and len(r) % hop == 0 for r in results)
    audio_s = sum(len(r) for r in results if r is not None) / srv.sample_rate
    return ok, wall, audio_s


def _counting_fallbacks(srv):
    """Wrap the server's fused batch so that the batches it hands to the
    staged path (a mel of fused_max_t frames or more) are counted."""
    fused, counted = srv._synthesize_batch_fused, {'fallbacks': 0}

    def wrapped(reqs, ids):
        out = fused(reqs, ids)
        counted['fallbacks'] += out is None
        return out
    srv._synthesize_batch_fused = wrapped
    return counted


def _replay_exact(srv, texts, vocoder):
    """The captured graph against the same function run eagerly on the
    card (same inputs and seed): pcm, mel_len, wav_len and the mel equal
    bit for bit; every kernel counted by name in a profiled replay and
    held to the eager run's counts; WaveRNN replays with another seed
    differ, with the same seed repeat."""
    from torch.profiler import ProfilerActivity, profile
    from forwardtacotron_tpu_torch.utils.profiling import kernel_launches
    tx, B, inputs = _fused_batch(srv, texts, 11,
                                 [(1.0, 1.0, 1.0), (1.2, 0.9, 1.1)])
    run = srv._fused_program(tx, B, FUSED_MAX_T)
    before = _kernel_counts_now()
    with torch.no_grad():
        eager = srv._fused_forward(
            *(torch.as_tensor(v).to(DEVICE) for v in inputs), FUSED_MAX_T)
    torch.cuda.synchronize()
    eager_counts = {k: v - before[k] for k, v in _kernel_counts_now().items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        replay = run(*inputs)
    counted = kernel_launches(prof)
    equal = all(np.array_equal(r, e.cpu().numpy())
                for r, e in zip(replay, eager[:3])) \
        and torch.equal(run.outputs[3], eager[3])
    need = ('birnn_stream_local', 'wavernn_sample') \
        if vocoder == 'wavernn' else ('birnn_stream_local',)
    check(equal and counted == eager_counts
          and all(counted[k] > 0 for k in need),
          f'fused {vocoder} (tx {tx}, B {B}): graph replay == eager, bit '
          f'for bit (pcm {replay[0].dtype} {replay[0].shape}, mel_len '
          f'{replay[1].tolist()}); kernels in the replay {counted}, eager '
          f'{eager_counts}')
    out = {'key': [tx, B, FUSED_MAX_T], 'launches_replay': counted,
           'launches_eager': eager_counts, 'mel_len': replay[1].tolist()}
    if vocoder == 'wavernn':
        again = run(*inputs[:-1], np.asarray(11))
        other = run(*inputs[:-1], np.asarray(12))
        check(np.array_equal(again[0], replay[0])
              and not np.array_equal(other[0], replay[0]),
              'fused wavernn: replays with seed 11 repeat, seed 12 differs')
    return out


def _utterance_920(srv, text, hop):
    """The 920-frame utterance (phase 5: 8 frames a phoneme, forced on the
    server's model) from text to PCM through the server's batch path: the
    staged one, or one fused replay (captured on the first call); ms by
    CUDA events and by the host clock (median of 3 after one call), and
    the graph's replay alone by CUDA events."""
    from forwardtacotron_tpu_torch.serving import _Request
    model = srv.model
    series = model.predict_series
    reqs = [_Request(text, 1.0, 1.0, 1.0)]
    ids = [srv.tokenizer(srv.cleaner(text))]
    tx = -(-len(ids[0]) // srv.text_bucket) * srv.text_bucket
    key = (tx, 1, FUSED_MAX_T)
    # the key's graph is captured again with the forced durations
    held = srv._fused_programs.pop(key, None)

    def eight(*args, **kw):
        out = series(*args, **kw)
        return dict(out, dur=torch.full_like(out['dur'], 8.0))
    model.predict_series = eight
    try:
        wav = srv._synthesize_batch(reqs, ids)[0]
        rows = []
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t0 = time.perf_counter()
            ev[0].record()
            wav = srv._synthesize_batch(reqs, ids)[0]
            ev[1].record()
            ev[1].synchronize()
            rows.append(((time.perf_counter() - t0) * 1e3,
                         ev[0].elapsed_time(ev[1])))
        row = {'host_ms': float(np.median([r[0] for r in rows])),
               'event_ms': float(np.median([r[1] for r in rows])),
               'samples': len(wav),
               'audio_s': len(wav) / srv.sample_rate}
        if srv.fused:
            row['capture_s'] = srv.capture_seconds[key]
            graph = srv._fused_programs[key].graph
            row['replay_event_ms'] = cuda_ms(graph.replay, reps=3)
    finally:
        model.predict_series = series
        if srv.fused:
            srv._fused_programs.pop(key, None)
            if held is not None:
                srv._fused_programs[key] = held
    frames = 8 * len(ids[0])
    n = frames * hop if srv.vocoder != 'wavernn' else (frames - 1) * hop
    check(len(wav) == n and wav.dtype == np.int16,
          f'{"fused" if srv.fused else "staged"} {srv.vocoder}: the '
          f'{frames}-frame utterance, {len(wav)} int16 samples, '
          f'{row["event_ms"]:.1f} ms (events), {row["host_ms"]:.1f} ms '
          f'(host)' + (f', replay alone {row["replay_event_ms"]:.1f} ms'
                       if srv.fused else ''))
    return row


def _pool_gib(pool):
    """GiB the caching allocator holds in the private pool `pool` (the
    fused server's CUDA graphs), from its segments; 'not measured' where
    this torch's snapshot does not name the pools."""
    segments = torch.cuda.memory_snapshot()
    if not segments or 'segment_pool_id' not in segments[0]:
        return 'not measured'
    return sum(s['total_size'] for s in segments
               if tuple(s['segment_pool_id']) == tuple(pool)) / 2 ** 30


def _servers(lines, hifi_path, hop, long_text):
    """For HiFi-GAN V1 and WaveRNN (bf16): the staged and the fused
    server, each warmed up (fused: the capture seconds of each key and
    the graph pool's memory), two rounds of 8 concurrent requests, the
    920-frame utterance; on the fused one the replay against the eager
    function."""
    from forwardtacotron_tpu_torch.serving import TTSServer
    out, exact = {}, {}
    for vocoder, voc_ckpt in (('hifigan', str(hifi_path)),
                              ('wavernn', None)):
        for mode in ('staged', 'fused'):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with TTSServer(None, vocoder=vocoder, voc_checkpoint=voc_ckpt,
                           max_batch=8, max_wait_ms=20.0, device=DEVICE,
                           fused=mode == 'fused',
                           fused_max_t=FUSED_MAX_T) as srv:
                n_ids = max(len(srv.tokenizer(srv.cleaner(t)))
                            for t in lines[:8])
                warm = srv.warmup(batch_sizes=[1, 8], text_lens=[n_ids])
                row = {'warmup_s': warm['seconds'],
                       'warmup_peak_gib':
                           torch.cuda.max_memory_allocated() / 2 ** 30}
                counted = _counting_fallbacks(srv) if srv.fused else None
                for rnd in ('first', 'second'):
                    ok, wall, audio_s = _concurrent(srv, lines, hop)
                    check(ok, f'TTSServer {mode} {vocoder}, {rnd} round: 8 '
                              f'concurrent requests in {wall:.3f} s '
                              f'({audio_s:.2f} s of audio), batches '
                              f'{list(srv.batch_sizes)}')
                    row[rnd] = {'wall_s': wall, 'audio_s': audio_s,
                                'audio_s_per_s': audio_s / wall,
                                'batch_sizes': list(srv.batch_sizes)}
                if srv.fused:
                    row['fallbacks'] = counted['fallbacks']
                    exact[vocoder] = _replay_exact(srv, lines[:2], vocoder)
                    row['capture_s'] = {str(k): v for k, v in
                                        srv.capture_seconds.items()}
                    row['graph_pool_gib'] = _pool_gib(srv._graph_pool)
                row['utterance_920'] = _utterance_920(srv, long_text, hop)
                log(f'  TTSServer {mode} {vocoder}: {row}')
                out[f'{mode}_{vocoder}'] = row
    return out, exact


def _fused_f32_vs_cpu(text, hifi_path):
    """The float32 mel out of a float32 fused program (HiFi-GAN, 512
    frames, one replay) against the same series and decode on the CPU's
    plain path, same seeded weights: atol 1e-4, an equal mel_len."""
    from forwardtacotron_tpu_torch import gen_forward
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.serving import TTSServer
    hifi = str(hifi_path)
    max_t = 512
    with TTSServer(None, vocoder='hifigan', voc_checkpoint=hifi,
                   device=DEVICE, fused=True, fused_max_t=max_t,
                   compute_dtype=torch.float32) as srv:
        tx, B, inputs = _fused_batch(srv, [text], 0, [(1.1, 0.9, 1.2)])
        run = srv._fused_program(tx, B, max_t)
        mel_len = run(*inputs)[1]
        mel = run.outputs[3].cpu()
    model, _, _ = gen_forward.load_tts(None, default_config(), 'cpu', 0)
    x, xl = torch.as_tensor(inputs[0]), torch.as_tensor(inputs[1])
    a, ps, es = (torch.as_tensor(v) for v in inputs[2:5])
    with torch.no_grad():
        s = model.predict_series(x, x_len=xl, compute_dtype=torch.float32)
        ref = model.generate_from_series(
            x, s['dur'] / a[:, None], s['pitch'] * ps[:, None],
            s['energy'] * es[:, None], max_t, x_len=xl,
            compute_dtype=torch.float32)
    n = int(ref['mel_len'][0])
    err = float((mel[0, :n] - ref['mel_post'][0, :n]).abs().max())
    check(int(mel_len[0]) == n < max_t and err < 1e-4,
          f'float32 fused mel, card vs CPU: mel_len {int(mel_len[0])} / {n}, '
          f'max err {err:.2e} < 1e-4')
    return {'mel_len': n, 'max_abs_err': err}


def _fused_overflow(text, hop, hifi_path):
    """A request whose mel reaches fused_max_t (64) frames is served
    through the staged path."""
    from forwardtacotron_tpu_torch.serving import TTSServer
    hifi = str(hifi_path)
    with TTSServer(None, vocoder='hifigan', voc_checkpoint=hifi,
                   device=DEVICE, fused=True, fused_max_t=64) as srv:
        counted = _counting_fallbacks(srv)
        pcm = srv.synthesize(text, timeout=300)
    check(counted['fallbacks'] == 1 and len(pcm) > 64 * hop,
          f'fused_max_t 64: {counted["fallbacks"]} batch rerun on the '
          f'staged path, {len(pcm)} samples > {64 * hop}')
    return {'fallbacks': counted['fallbacks'], 'samples': len(pcm)}


def _exports(text, hifi_path):
    """`export_forward --device cuda` with WaveRNN and with HiFi-GAN, one
    bucket each (export seconds, file size); the artifact's synthesize
    with a fixed seed twice equal, #1 and #4 counted in a profiled call
    (the wrappers' counters and the kernel names); generate against the
    live model (float32: mel L1 < 1e-3, an equal mel_len)."""
    from torch.profiler import ProfilerActivity, profile
    from forwardtacotron_tpu_torch import export_forward, gen_forward
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.utils.export import ExportedTTS
    from forwardtacotron_tpu_torch.utils.profiling import (KERNEL_NAMES,
                                                           kernel_launches)
    out, launches = {}, dict.fromkeys(KERNEL_NAMES.values(), 0)
    cfg = default_config()
    ids = gen_forward.text_to_ids(text, cfg)
    tx, max_t = (int(v) for v in EXPORT_BUCKET.split(':'))
    for name, argv in (('wavernn', ['--voc_type', 'wavernn']),
                       ('hifigan', ['--voc_checkpoint', str(hifi_path)])):
        path = EXPORT_DIR / f'{name}.ftpt'
        t0 = time.perf_counter()
        export_forward.main(['--device', 'cuda', '--output', str(path),
                             '--buckets', EXPORT_BUCKET, *argv])
        row = {'export_s': time.perf_counter() - t0,
               'file_mib': path.stat().st_size / 2 ** 20}
        t0 = time.perf_counter()
        art = ExportedTTS(path)
        row['load_s'] = time.perf_counter() - t0
        art.synthesize(ids, seed=3)                # first call
        before = _kernel_counts_now()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pcm = art.synthesize(ids, seed=3)
            row['synthesize_ms'] = (time.perf_counter() - t0) * 1e3
        counts = {k: v - before[k] for k, v in _kernel_counts_now().items()}
        named = kernel_launches(prof)
        for k in launches:
            launches[k] += counts[k]
        need = ('birnn_stream_local', 'wavernn_sample') \
            if name == 'wavernn' else ('birnn_stream_local',)
        same = np.array_equal(pcm, art.synthesize(ids, seed=3))
        check(counts == named and all(counts[k] > 0 for k in need)
              and same and pcm.dtype == np.int16 and len(pcm) > 0,
              f'export {name}: {row["export_s"]:.1f} s, '
              f'{row["file_mib"]:.1f} MiB; synthesize {len(pcm)} int16 '
              f'samples in {row["synthesize_ms"]:.1f} ms, seed 3 twice '
              f'equal {same}; kernels {counts} (profiler {named})')
        row.update(launches=counts, samples=len(pcm))
        if name == 'hifigan':
            mel, _ = art.generate(ids)
            model, _, _ = gen_forward.load_tts(None, cfg, DEVICE, 0)
            x = torch.zeros((1, tx), dtype=torch.long)
            x[0, :len(ids)] = torch.tensor(ids)
            live = model.generate(x.to(DEVICE), max_t, x_len=torch.tensor(
                [len(ids)], device=DEVICE), compute_dtype=torch.float32)
            n = int(live['mel_len'][0])
            ref = live['mel_post'][0, :n].T.float().cpu().numpy()
            l1 = float(np.abs(mel - ref).mean()) if mel.shape == ref.shape \
                else float('inf')
            check(mel.shape[1] == n and l1 < 1e-3,
                  f'export generate on the card vs the live model: mel_len '
                  f'{mel.shape[1]} / {n}, mel L1 {l1:.2e} < 1e-3')
            row['generate_l1'] = l1
        out[name] = row
        log(f'  export {name}: {row}')
        path.unlink()
    return out, launches


@phase('export and the fused server (full width)')
def export_and_fused_path():
    """The fused server and the exported artifact at config.yaml's widths,
    random weights from seeds (HiFi-GAN V1 written in the official layout,
    WaveRNN from config.yaml, bf16 in the servers). Cuts: 8 requests a
    round (phase 6's), the fused servers warmed at B 1 and 8 and one text
    bucket; one export bucket (64 tokens, 512 frames) of the CLI's
    default two (64:512, 192:1536), float32 (the export's default).

    1. `_servers`: staged and fused servers, HiFi-GAN and WaveRNN, two
       rounds of 8 concurrent requests, capture seconds, graph pool
       memory, the 920-frame utterance staged against one fused replay;
       the replay against the eager function (`_replay_exact`);
    2. `_fused_f32_vs_cpu`: the float32 mel of the fused program against
       the CPU;
    3. `_fused_overflow`: a mel of fused_max_t frames falls back;
    4. `_exports`: export_forward --device cuda, the artifact on the card.
    """
    from forwardtacotron_tpu_torch.config import default_config
    lines = [s for s in Path('sentences.txt').read_text().splitlines()
             if s.strip()]
    cfg = default_config()
    hop = cfg['dsp']['hop_length']
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    out = {}
    try:
        hifi_path, _ = _gan_files(cfg, EXPORT_DIR)
        out['servers'], out['exact'] = _servers(lines, hifi_path, hop,
                                                lines[-1])
        out['f32_vs_cpu'] = _fused_f32_vs_cpu(lines[0], hifi_path)
        out['overflow'] = _fused_overflow(lines[-1], hop, hifi_path)
        out['export'], export_launches = _exports(lines[0], hifi_path)
    finally:
        shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    fused = dict.fromkeys(export_launches, 0)
    for row in out['exact'].values():
        for k, v in row['launches_replay'].items():
            fused[k] += v
    out['launches'] = {'fused': fused, 'export': export_launches}
    DETAILS['export_and_fused_path'] = out
    return out['launches']


# ------------------------------------------- native I/O and the loader

NATIVE_DIR = Path('smoke_native')     # corpus, datasets and checkpoints
# the corpus's formats, in turn: (sample rate, WAVE format, bits, channels)
NATIVE_FORMATS = ((44100, 1, 16, 1), (48000, 1, 24, 2), (22050, 3, 32, 1))
NATIVE_N_UTTERANCES = 8
NATIVE_STEPS = 3


def _pcm_frames(y, fmt, bits, channels, rng):
    """(frames as written, (n, channels) int or float32 array): `y` on the
    first channel, 0.8 y plus its own faint noise on a second."""
    cols = [y] + [0.8 * y + 1e-4 * rng.randn(len(y))
                  for _ in range(channels - 1)]
    x = np.stack(cols, axis=1)
    if fmt == 3:
        return x.astype('<f4')
    scale = 2 ** (bits - 1)
    return np.clip(np.round(x * scale), -scale, scale - 1).astype(np.int64)


def _write_wav_frames(path, frames, sr, fmt, bits):
    """A RIFF wav of (n, channels) PCM integers of `bits` bits (format 1)
    or IEEE float32 samples (format 3)."""
    import struct
    ch = frames.shape[1]
    if fmt == 3:
        data = frames.astype('<f4').tobytes()
    elif bits == 24:
        data = frames.astype('<i4').view(np.uint8).reshape(-1, 4)[:, :3] \
            .tobytes()
    else:
        data = frames.astype(f'<i{bits // 8}').tobytes()
    block = ch * bits // 8
    path.write_bytes(
        b'RIFF' + struct.pack('<I', 36 + len(data)) + b'WAVE' + b'fmt '
        + struct.pack('<IHHIIHH', 16, fmt, ch, sr, sr * block, block, bits)
        + b'data' + struct.pack('<I', len(data)) + data)


def _reference_load(frames, sr, fmt, bits, target_sr):
    """`DSP.load_wav`'s arithmetic in numpy: integers over 2^(bits-1) (or
    the float samples), the channels' mean in float64, then linear
    interpolation at i * sr / target_sr."""
    acc = frames.astype(np.float64).sum(axis=1) * (1.0 / frames.shape[1])
    wav = (acc if fmt == 3 else acc / 2.0 ** (bits - 1)).astype(np.float32)
    if sr == target_sr:
        return wav
    n = len(wav)
    m = int(float(n) * target_sr / sr)
    pos = np.arange(m) * (sr / target_sr)
    i0 = pos.astype(np.int64)
    i1 = np.minimum(i0 + 1, n - 1)
    frac = pos - i0
    src = wav.astype(np.float64)
    return (src[i0] * (1.0 - frac) + src[i1] * frac).astype(np.float32)


def _write_native_corpus(root, target_sr, seed=3):
    """NATIVE_N_UTTERANCES utterances of `_write_corpus`'s harmonics, in
    NATIVE_FORMATS by turns, as an LJSpeech-layout corpus. Returns {item:
    (sample rate, format, bits, frames as written)}."""
    rng = np.random.RandomState(seed)
    lines = [s.strip() for s in Path('sentences.txt').read_text().splitlines()
             if s.strip()]
    (root / 'wavs').mkdir(parents=True)
    meta, items = [], {}
    for i in range(NATIVE_N_UTTERANCES):
        sr, fmt, bits, ch = NATIVE_FORMATS[i % len(NATIVE_FORMATS)]
        seconds, y, _ = _utterance(rng, sr)
        frames = _pcm_frames(y, fmt, bits, ch, rng)
        item = f'LJ{i:03d}'
        _write_wav_frames(root / 'wavs' / f'{item}.wav', frames, sr, fmt,
                          bits)
        text = ' '.join(rng.choice(lines, 3))[:int(15 * seconds)]
        meta.append(f'{item}|{text}|{text}')
        items[item] = (sr, fmt, bits, frames)
    (root / 'metadata.csv').write_text('\n'.join(meta) + '\n')
    return items


def _host_library():
    """Builds the port's host library from its sources into a fresh
    directory (the g++ seconds of each), then loads the package's own."""
    from forwardtacotron_tpu_torch import native
    version = subprocess.run([native.cxx_path(), '--version'],
                             capture_output=True, text=True,
                             check=True).stdout.splitlines()[0]
    saved = native.BUILD_DIR
    native.BUILD_DIR = (NATIVE_DIR / 'build').resolve()
    try:
        seconds = {}
        for name in ('audio_io', 'batch_loader'):
            t0 = time.perf_counter()
            native.build(name)
            seconds[name] = time.perf_counter() - t0
    finally:
        native.BUILD_DIR = saved
    for name in ('audio_io', 'batch_loader'):
        native.load(name)
    log(f'  host library: {version}; built {seconds} s')
    return {'gxx': version, 'build_s': seconds}


def _native_preprocess(cfg, smi):
    """The corpus through `preprocess.main` (the module's CLI; mel and F0
    on the card), `DSP.load_wav` against `_reference_load` within one ulp,
    a `save_wav` -> `load_wav` round trip; audio seconds a second."""
    from forwardtacotron_tpu_torch import preprocess
    from forwardtacotron_tpu_torch.dsp.audio import DSP
    sr = cfg['dsp']['sample_rate']
    items = _write_native_corpus(Path('corpus'), sr)
    audio_s = sum(len(f) / r for r, _, _, f in items.values())
    t0 = time.perf_counter()
    train, val = preprocess.main(['--path', 'corpus', '--num_workers', '4',
                                  '--device', DEVICE])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f'  preprocess: {len(items)} files ({NATIVE_FORMATS}), '
        f'{audio_s:.1f} s of audio in {wall:.2f} s ({audio_s / wall:.1f} '
        f'audio seconds a second, host clock) | {smi}')
    check(len(train) + len(val) == len(items),
          f'preprocess wrote {len(train)} train + {len(val)} val items')
    dsp = DSP.from_config(cfg, DEVICE)
    worst_ulps, worst_trip = 0.0, 0.0
    for item, (rate, fmt, bits, frames) in items.items():
        got = dsp.load_wav(Path('corpus') / 'wavs' / f'{item}.wav')
        want = _reference_load(frames, rate, fmt, bits, sr)
        ulps = np.abs(got.astype(np.float64) - want) / np.spacing(
            np.abs(want).astype(np.float32)).astype(np.float64)
        worst_ulps = max(worst_ulps, float(ulps.max()))
        check(got.shape == want.shape and ulps.max() <= 1,
              f'{item} ({rate} Hz, format {fmt}, {bits} bits, '
              f'{frames.shape[1]} ch): load_wav {got.shape} vs numpy '
              f'{want.shape}, {ulps.max():.0f} ulp')
        dsp.save_wav(got, Path('corpus') / 'trip.wav')
        back = dsp.load_wav(Path('corpus') / 'trip.wav')
        worst_trip = max(worst_trip, float(np.abs(back - got).max()))
    # half an LSB of rounding, and the reader's scale of 2^15 against the
    # writer's 2^15 - 1 at full scale
    check(worst_trip <= 0.5 / 32767 + 1 / 32768,
          f'save_wav -> load_wav within {worst_trip:.3g} (bound '
          f'{0.5 / 32767 + 1 / 32768:.3g})')
    mels = [np.load(Path(cfg['data_path']) / 'mel' / f'{i}.npy')
            for i, _ in train + val]
    check(all(m.shape[0] == 80 and np.isfinite(m).all() for m in mels),
          f'{len(mels)} mels of 80 bands, all finite')
    return {'files': len(items), 'audio_s': audio_s, 'wall_s': wall,
            'audio_s_per_s': audio_s / wall, 'load_wav_max_ulp': worst_ulps,
            'round_trip_max_abs': worst_trip}


class _BatchLog:
    """For the block: records what each `batches` call of the two
    batchers yields, with the native loader's accepted calls that made
    each batch (counted on the thread that assembled it: the trainers'
    prefetch threads or the caller's)."""

    LOADER = ('load_mel_batch', 'load_mel_windows', 'load_i64_windows')

    def __init__(self):
        import threading
        from forwardtacotron_tpu_torch.data import dataset, native_loader
        self.runs, self._local, self._saved = [], threading.local(), []
        for cls in (dataset.BucketBatcher, dataset.VocBatcher):
            self._saved.append((cls, 'batches', cls.batches))
            cls.batches = self._recording(cls.batches)
        for name in self.LOADER:
            fn = getattr(native_loader, name)
            self._saved.append((native_loader, name, fn))
            setattr(native_loader, name, self._counting(fn))

    def _recording(self, batches):
        runs, local = self.runs, self._local

        def recorded(batcher, epoch, start=0):
            rng = getattr(getattr(batcher, 'collator', None), 'rng', None)
            got = []
            runs.append((batches, batcher, epoch, start,
                         None if rng is None else rng.get_state(), got))
            it = batches(batcher, epoch, start)
            while True:
                local.accepted = 0
                try:
                    batch = next(it)
                except StopIteration:
                    return
                got.append((batch, local.accepted))
                yield batch
        return recorded

    def _counting(self, fn):
        local = self._local

        def counted(*args):
            out = fn(*args)
            local.accepted = getattr(local, 'accepted', 0) + (
                out is not None)
            return out
        return counted

    def restore(self):
        for owner, name, value in self._saved:
            setattr(owner, name, value)

    def native_share(self):
        """{'tts': (batches, on the native path), 'voc': ...}: a TTS batch
        is native when its mel block was read natively, a WaveRNN batch
        when its mel and label windows both were."""
        out = {'tts': [0, 0], 'voc': [0, 0]}
        for _, batcher, _, _, _, got in self.runs:
            kind, need = (('voc', 2) if hasattr(batcher, 'collator')
                          else ('tts', 1))
            for _, accepted in list(got):
                out[kind][0] += 1
                out[kind][1] += accepted == need
        return out

    def replay_numpy(self):
        """Every recorded run again with FTT_NATIVE_LOADER=0 (each
        collator's generator at its state then): (batches, batches equal
        bit for bit)."""
        import itertools
        import os
        n = same = 0
        with _patched(os.environ, FTT_NATIVE_LOADER='0'):
            for batches, batcher, epoch, start, rng, got in self.runs:
                got = [b for b, _ in list(got)]
                if rng is not None:
                    batcher.collator.rng.set_state(rng)
                want = list(itertools.islice(
                    batches(batcher, epoch, start), len(got)))
                for a, b in zip(got, want):
                    n += 1
                    same += set(a) == set(b) and all(
                        np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
                        and np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
                        for k in a)
        return n, same


def _assembly_ms(batcher, epoch=0, reps=3):
    """Host ms to assemble each batch of one epoch's plan, native and
    numpy (FTT_NATIVE_LOADER=0), each the median of `reps` passes after
    one that warms the page cache."""
    import os

    def per_batch():
        times = []
        for _ in range(reps + 1):
            t0 = time.perf_counter()
            n = sum(1 for _ in batcher.batches(epoch))
            times.append((time.perf_counter() - t0) * 1e3 / max(n, 1))
        return float(np.median(times[1:]))
    native = per_batch()
    with _patched(os.environ, FTT_NATIVE_LOADER='0'):
        plain = per_batch()
    return {'native_ms': native, 'numpy_ms': plain}


@phase('native I/O and the batch loader (full width)')
def native_io_path():
    """The port's host library on the card's machine at config.yaml's
    widths, random weights from seeds, in NATIVE_DIR. Cuts: a corpus of
    NATIVE_N_UTTERANCES utterances of 2-8 s (VCTK, 48 kHz: ~44k;
    LibriTTS, 24 kHz: ~375k), in the formats of NATIVE_FORMATS by turns;
    training on a synthetic dataset of 64 + 32 items of 400-600 frames
    (`_write_voc_dataset`, int64 labels), the student and WaveRNN
    NATIVE_STEPS steps each at batch 32 (300k and 600k); one
    generate_samples sample.

    1. the host library built by g++ from the port's C++ sources
       (`_host_library`);
    2. the corpus through `preprocess.main`, `DSP.load_wav` against numpy,
       the round trip (`_native_preprocess`);
    3. `ForwardTrainer.train` and `evaluate()`, then `VocTrainer.train`
       (its evaluate() and one generate_samples), fed by the native loader:
       launches of #1-#4 counted from 0 just before and read just after,
       every batch on the native path and equal to the numpy collation of
       the same plan; batch assembly ms, native against numpy; each step
       by `step_timing` with its idle share."""
    import os
    from forwardtacotron_tpu_torch import config
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.data.dataset import (get_tts_datasets,
                                                        get_vocoder_datasets)
    from forwardtacotron_tpu_torch.dsp.audio import DSP
    from forwardtacotron_tpu_torch.kernels.wavernn_sample import sample
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.models.wavernn import WaveRNN
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.forward_trainer import (
        ForwardTrainer, batch_to_device)
    from forwardtacotron_tpu_torch.train.voc_trainer import (VocTrainer,
                                                             voc_micro_loss)
    from forwardtacotron_tpu_torch.train.voc_trainer import (
        batch_to_device as voc_to_device)
    from forwardtacotron_tpu_torch.utils.paths import Paths
    smi = nvidia_smi_line()
    shutil.rmtree(NATIVE_DIR, ignore_errors=True)
    NATIVE_DIR.mkdir(parents=True)
    out = {'host_library': _host_library()}
    base = NATIVE_DIR.resolve()
    (base / 'sentences.txt').write_text(Path('sentences.txt').read_text())
    record = None
    try:
        with _patched(os.environ, FTT_BASE=str(base)), _cwd(base), \
                _patched(config.PREPROCESSING, n_val=2):
            cfg = default_config()
            out['preprocess'] = _native_preprocess(cfg, smi)

            data = base / 'train_data'
            cfg['data_path'] = str(data)
            _write_voc_dataset(data, cfg, quant_dtype=np.int64)
            paths = Paths(cfg['data_path'], 'smoke_native_tts', base=base,
                          voc_id='smoke_native_voc')
            voc_cfg = cfg['vocoder']['training']
            voc_cfg.update(schedule=[f'1e-4, {NATIVE_STEPS}, 32'],
                           checkpoint_every=NATIVE_STEPS,
                           gen_samples_every=NATIVE_STEPS,
                           num_gen_samples=1)
            trainer = ForwardTrainer(paths, cfg, DEVICE)
            voc_trainer = VocTrainer(paths, DSP.from_config(cfg, DEVICE),
                                     cfg, DEVICE, writer=_Scalars())
            torch.manual_seed(0)
            student = ForwardTacotron.from_config(cfg).to(DEVICE)
            s_opt = tc.make_optimizer(student)
            vocoder = WaveRNN.from_config(cfg).to(DEVICE)
            v_opt = tc.make_optimizer(vocoder)

            record = _BatchLog()
            _train_counts(reset=True)
            sample.launches = 0
            t0 = time.perf_counter()
            s_step = trainer.train(student, s_opt,
                                   max_steps_override=NATIVE_STEPS)
            torch.cuda.synchronize()
            s_wall = time.perf_counter() - t0
            _, s_val = get_tts_datasets(cfg['data_path'], 32, 1, None)
            s_eval = trainer.evaluate(student, s_val)
            t0 = time.perf_counter()
            v_step = voc_trainer.train(vocoder, v_opt)
            torch.cuda.synchronize()
            v_wall = time.perf_counter() - t0
            launches = {**_train_counts(), 'wavernn_sample': sample.launches}
            record.restore()
            native = record.native_share()
            n_batches, n_same = record.replay_numpy()
            log(f'  student {s_step} steps in {s_wall:.1f} s, WaveRNN '
                f'{v_step} steps in {v_wall:.1f} s (host clock, first '
                f'steps, evaluate() and generate_samples included); '
                f'launches {launches}; batches (all, native) {native}')
            check(s_step == v_step == NATIVE_STEPS
                  and all(map(math.isfinite, s_eval.values())),
                  f'student and WaveRNN reached step {NATIVE_STEPS}; '
                  f'student evaluate() {s_eval}')
            voc_values = voc_trainer.writer.values
            gen_l1 = [v for t, v, _ in voc_values
                      if t == 'Loss/generated_mel_l1']
            val = [v for t, v, _ in voc_values if t == 'Loss/val']
            check(len(gen_l1) == 1 and len(val) == 1
                  and math.isfinite(gen_l1[0]) and math.isfinite(val[0]),
                  f'WaveRNN evaluate() {val}, generate_samples mel L1 '
                  f'{gen_l1}')
            for name in ('birnn', 'birnn_train_fwd', 'birnn_train_bwd',
                         'wavernn_sample'):
                check(launches[name] > 0,
                      f'{name} launched {launches[name]} times')
            check(n_batches > 0 and n_same == n_batches,
                  f'{n_same} of {n_batches} batches equal to the numpy '
                  f'collation of the same plan, bit for bit')
            check(all(n == on > 0 for n, on in native.values()),
                  f'every batch on the native path: (batches, native) '
                  f'{native}')

            s_train, _ = get_tts_datasets(cfg['data_path'], 32, 1, None)
            v_train, _, _ = get_vocoder_datasets(
                cfg['data_path'], 32, False, voc_cfg['max_mel_len'],
                cfg['dsp']['hop_length'], vocoder.pad, voc_cfg['seq_len'],
                'RAW', cfg['dsp']['bits'], 1)
            assembly = {'bucket_batcher': _assembly_ms(s_train),
                        'voc_batcher': _assembly_ms(v_train)}
            log(f'  batch assembly at B=32, host ms a batch: {assembly}')
            s_batch = next(iter(s_train))
            timing = {
                'student': step_timing(_student_parts(
                    student, s_opt, batch_to_device(s_batch, DEVICE),
                    trainer.train_cfg),
                    f'student step, native batch {list(s_batch["mel"].shape)}',
                    smi),
                'wavernn': step_timing(train_parts(
                    vocoder, v_opt, voc_micro_loss(vocoder, 'RAW'),
                    voc_to_device(next(iter(v_train)), DEVICE), voc_cfg),
                    'WaveRNN step, native batch', smi)}
            out.update({
                'launches': launches, 'native_batches': native,
                'batches': n_batches, 'batches_equal': n_same,
                'student': {'steps': s_step, 'wall_s': s_wall,
                            'evaluate': s_eval},
                'wavernn': {'steps': v_step, 'wall_s': v_wall,
                            'val_loss': val, 'generated_mel_l1': gen_l1},
                'assembly_ms': assembly, 'step_ms': timing, 'nvidia_smi': smi})
    finally:
        if record is not None:
            record.restore()
        shutil.rmtree(NATIVE_DIR, ignore_errors=True)
    DETAILS['native_io_path'] = out
    return out


# --------------------------------------------------- data parallelism

PARALLEL_DIR = Path('smoke_parallel')   # datasets, checkpoints and logs
PARALLEL_STEPS = 3
PARALLEL_BATCH = 32
# 150-320 frames: at most 25 folds a mel at the kernel's target, so four
# mels a shard fit one sampler launch (128 lanes)
PARALLEL_VOCODE_FRAMES = (150, 321)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _max_diff(a, b):
    """The largest |a - b| over the float tensors of two state dicts."""
    return max(float((a[k].float() - b[k].float()).abs().max())
               for k in a if a[k].is_floating_point())


def _copy_state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _no_dropout_student(cfg):
    """config.yaml's student at full width with every dropout rate 0: the
    ranks draw from seed + rank, one process from seed."""
    cfg = copy.deepcopy(cfg)
    m = cfg['forward_tacotron']['model']
    for k in m:
        if k.endswith('dropout'):
            m[k] = 0.0
    return cfg


def _sharded_vocoding(cfg, smi):
    """(d): `vocode_batch` over a mesh of [cuda:0, cuda:0] against the
    unsharded call, and `TTSServer(vocoder='wavernn', mesh=)` at 8
    concurrent requests."""
    from forwardtacotron_tpu_torch.kernels.wavernn_sample import sample
    from forwardtacotron_tpu_torch.models.wavernn import (SHARD_SEED_STRIDE,
                                                          WaveRNN,
                                                          vocode_batch)
    from forwardtacotron_tpu_torch.parallel import make_mesh
    from forwardtacotron_tpu_torch.serving import TTSServer
    mesh = make_mesh(devices=['cuda:0', 'cuda:0'])
    torch.manual_seed(21)
    voc = WaveRNN.from_config(cfg).to('cuda').eval()
    rng = np.random.RandomState(9)
    mels = [(rng.randn(80, int(rng.randint(*PARALLEL_VOCODE_FRAMES))) * 2
             - 5).astype(np.float32) for _ in range(8)]
    out = {'frames': [m.shape[1] for m in mels]}
    launched = {}
    for n in (3, 8):
        f32 = dict(greedy=True, compute_dtype=torch.float32)
        vocode_batch(voc, mels[:n], mesh=mesh, **f32)            # warm
        vocode_batch(voc, mels[:n], **f32)
        sample.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded = vocode_batch(voc, mels[:n], mesh=mesh, **f32)
        torch.cuda.synchronize()
        sharded_ms = (time.perf_counter() - t0) * 1e3
        launched[n] = sample.launches
        t0 = time.perf_counter()
        whole = vocode_batch(voc, mels[:n], **f32)
        torch.cuda.synchronize()
        whole_ms = (time.perf_counter() - t0) * 1e3
        same = sum(np.array_equal(a, b) for a, b in zip(sharded, whole))
        out[f'{n}_mels'] = {'sharded_ms': sharded_ms, 'unsharded_ms': whole_ms,
                            'launches': launched[n], 'bit_equal': same}
        log(f'  vocode_batch greedy float32, {n} mels on 2 shards of '
            f'cuda:0: {sharded_ms:.1f} ms (host clock) against '
            f'{whole_ms:.1f} unsharded; #4 launched {launched[n]} times | '
            f'{smi}')
        check(same == n, f'{n} mels: greedy sharded equals unsharded bit '
                         f'for bit ({same} of {n})')
        check(launched[n] == mesh.size,
              f'{n} mels: one #4 launch a shard ({launched[n]})')
    # sampled: shard i is vocode_batch of its own mels at seed + i * 7919
    sampled = vocode_batch(voc, mels, seed=5, mesh=mesh)
    shards = [vocode_batch(voc, mels[4 * i:4 * i + 4],
                           seed=5 + i * SHARD_SEED_STRIDE) for i in range(2)]
    same = sum(np.array_equal(a, b)
               for a, b in zip(sampled, shards[0] + shards[1]))
    check(same == 8, f'sampled (bfloat16): shard i equals vocode_batch of '
                     f'its mels at seed + i * 7919 ({same} of 8)')
    lines = [s.strip() for s in Path('sentences.txt').read_text()
             .splitlines() if s.strip()][:8]
    with TTSServer(None, vocoder='wavernn', mesh=mesh, device='cuda',
                   config=copy.deepcopy(cfg)) as srv:
        srv.synthesize(lines[0], timeout=600)                    # warm
        srv.batch_sizes.clear()
        sample.launches = 0
        t0 = time.perf_counter()
        futs = [srv.submit(line) for line in lines]
        pcm = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        server_launches = sample.launches
        sizes = list(srv.batch_sizes)
    audio_s = sum(len(p) for p in pcm) / cfg['dsp']['sample_rate']
    log(f'  TTSServer(wavernn, mesh of 2 shards on cuda:0): 8 concurrent '
        f'requests in {wall:.3f} s, {audio_s:.2f} audio s, batches {sizes}, '
        f'#4 launched {server_launches} times | {smi}')
    check(len(pcm) == 8 and all(p.dtype == np.int16 and len(p) > 0
                                and p.std() > 0 for p in pcm),
          'TTSServer with a mesh answered 8 concurrent requests')
    check(server_launches >= mesh.size * len(sizes),
          f'the server\'s vocode ran a #4 launch a shard '
          f'({server_launches} for {len(sizes)} batches)')
    out['server'] = {'wall_s': wall, 'audio_s': audio_s,
                     'batch_sizes': sizes, 'launches': server_launches}
    out['launches'] = {'wavernn_sample': launched[3] + launched[8]
                       + server_launches}
    return out


def _parallel_rank(rank, store, base, out_dir):
    """(b): rank `rank` of 2 gloo ranks sharing cuda:0 (NCCL refuses two
    ranks on one device): one student step and one WaveRNN step on its 16
    rows of the global batch of 32, then (e) the student in a checkpoint
    directory that both ranks write. Results in out_dir/rank<r>.pt."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group('gloo', init_method=f'file://{store}',
                            rank=rank, world_size=2)
    try:
        from forwardtacotron_tpu_torch.parallel import make_mesh
        from forwardtacotron_tpu_torch.utils.checkpoints import (
            save_checkpoint)
        mesh = make_mesh(devices=['cuda:0', 'cuda:0'])
        cfg, batches = torch.load(Path(base) / 'inputs.pt',
                                  weights_only=False)
        t0 = time.perf_counter()
        student, s_opt, s_res = _student_step(cfg, batches['student'], mesh)
        s_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, _, v_res = _wavernn_step(cfg, batches['wavernn'], mesh)
        v_wall = time.perf_counter() - t0
        save_checkpoint(student, s_opt, cfg, Path(out_dir) / 'student.dcp',
                        1)
        torch.save({'student': s_res, 'wavernn': v_res,
                    'wall_s': {'student': s_wall, 'wavernn': v_wall}},
                   Path(out_dir) / f'rank{rank}.pt')
    finally:
        dist.destroy_process_group()


def _student_step(cfg, batch, mesh=None):
    """One student step of `train_step` at full width (dropout 0) from
    seed 0 on `batch` (the collated global batch), on this rank's rows
    under `data_parallel(mesh)`; (model, optimizer, {'metrics', 'grads'
    (clipped), 'state' after, 'launches'})."""
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.parallel import data_parallel, local_rows
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.forward_trainer import (
        batch_to_device)
    torch.manual_seed(0)
    model = ForwardTacotron.from_config(cfg).to('cuda')
    opt = tc.make_optimizer(model)
    train_cfg = cfg['forward_tacotron']['training']
    rows = batch_to_device(local_rows(mesh, batch), 'cuda')
    _all_counts(reset=True)
    with data_parallel(mesh):
        metrics = tc.train_step(model, opt, rows,
                                torch.Generator('cuda').manual_seed(0),
                                train_cfg)
    torch.cuda.synchronize()
    return model, opt, {
        'metrics': {k: float(v) for k, v in metrics.items()},
        'grads': {k: p.grad.detach().cpu() for k, p in model.named_parameters()},
        'state': {k: v.cpu() for k, v in _copy_state(model).items()},
        'launches': _all_counts(), 'rows': int(rows['x'].shape[0])}


def _wavernn_step(cfg, batch, mesh=None):
    """One WaveRNN RAW step (`voc_train_step`) from seed 0 on `batch`, on
    this rank's rows under `data_parallel(mesh)`; as `_student_step`."""
    from forwardtacotron_tpu_torch.models.wavernn import WaveRNN
    from forwardtacotron_tpu_torch.parallel import data_parallel, local_rows
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.voc_trainer import (batch_to_device,
                                                             voc_train_step)
    torch.manual_seed(0)
    model = WaveRNN.from_config(cfg).to('cuda')
    opt = tc.make_optimizer(model)
    rows = batch_to_device(local_rows(mesh, batch), 'cuda')
    _all_counts(reset=True)
    with data_parallel(mesh):
        metrics = voc_train_step(model, opt, rows, 'RAW',
                                 cfg['vocoder']['training']['clip_grad_norm'])
    torch.cuda.synchronize()
    return model, opt, {
        'metrics': {k: float(v) for k, v in metrics.items()},
        'grads': {k: p.grad.detach().cpu() for k, p in model.named_parameters()},
        'state': {k: v.cpu() for k, v in _copy_state(model).items()},
        'launches': _all_counts(), 'rows': int(rows['x'].shape[0])}


def _unclipped(res, clip):
    """The gradients before the global-norm clip."""
    norm = res['metrics']['grad_norm']
    scale = 1.0 if clip is None or norm < clip else norm / clip
    return {k: g * scale for k, g in res['grads'].items()}


def _large_grad_errors(got, want, floor=1e-4):
    """Over the elements with |g| > floor: the largest |got - want| and the
    largest |got - want| / |want|."""
    worst_abs = worst_rel = 0.0
    for k, w in want.items():
        big = w.abs() > floor
        if big.any():
            d = (got[k] - w).abs()[big]
            worst_abs = max(worst_abs, float(d.max()))
            worst_rel = max(worst_rel, float((d / w.abs()[big]).max()))
    return worst_abs, worst_rel


def _two_ranks(cfg, base, batches, smi):
    """(b) two gloo ranks on cuda:0 against one process at B=32, and (e)
    their checkpoint directory."""
    import torch.multiprocessing as mp
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.utils.checkpoints import (load_checkpoint,
                                                             restore)
    out_dir = base / 'two_ranks'
    out_dir.mkdir()
    torch.save((cfg, batches), base / 'inputs.pt')
    t0 = time.perf_counter()
    ctx = mp.start_processes(_parallel_rank, args=(
        str(base / 'store'), str(base), str(out_dir)), nprocs=2, join=False,
        start_method='spawn')
    deadline = time.monotonic() + 600
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError('two ranks still running after 600 s')
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    wall = time.perf_counter() - t0
    ranks = [torch.load(out_dir / f'rank{r}.pt', weights_only=False)
             for r in range(2)]
    out = {'wall_s': wall, 'rank_wall_s': [r['wall_s'] for r in ranks]}
    for what, step, clip in (
            ('student', _student_step,
             cfg['forward_tacotron']['training']['clip_grad_norm']),
            ('wavernn', _wavernn_step,
             cfg['vocoder']['training']['clip_grad_norm'])):
        one = step(cfg, batches[what])[2]
        r0, r1 = ranks[0][what], ranks[1][what]
        identical = all(torch.equal(r0['state'][k], r1['state'][k])
                        for k in r0['state'])
        loss_rel = abs(r0['metrics']['loss'] - one['metrics']['loss']) \
            / abs(one['metrics']['loss'])
        g_abs, g_rel = _large_grad_errors(_unclipped(r0, clip),
                                    _unclipped(one, clip))
        p_diff = _max_diff(r0['state'], one['state'])
        fwd = {r: ranks[r][what]['launches']['birnn_train_fwd']
               for r in range(2)}
        bwd = {r: ranks[r][what]['launches']['birnn_train_bwd']
               for r in range(2)}
        log(f'  {what}, 2 gloo ranks x {r0["rows"]} rows on cuda:0 against '
            f'one process at {one["rows"]}: loss {r0["metrics"]["loss"]:.6f}'
            f' vs {one["metrics"]["loss"]:.6f} (rel {loss_rel:.3g}); '
            f'gradients where |g| > 1e-4: max abs {g_abs:.3g}, max rel '
            f'{g_rel:.3g}; state after max {p_diff:.3g}; ranks identical '
            f'{identical}; #2 {fwd} #3 {bwd} a rank; rank seconds '
            f'{[r["wall_s"][what] for r in ranks]} | {smi}')
        check(loss_rel <= 1e-5, f'{what}: 2-rank loss within rel 1e-5 of '
                                f'one process ({loss_rel:.3g})')
        check(g_abs <= 1e-4, f'{what}: reduced gradients within 1e-4 where '
                             f'|g| > 1e-4 ({g_abs:.3g})')
        check(identical, f'{what}: both ranks bit-identical after the step')
        check(all(fwd[r] > 0 and bwd[r] > 0 for r in range(2)),
              f'{what}: #2/#3 launched on each rank ({fwd}, {bwd})')
        out[what] = {'loss': r0['metrics']['loss'],
                     'loss_one': one['metrics']['loss'], 'loss_rel': loss_rel,
                     'grad_max_abs': g_abs, 'grad_max_rel': g_rel,
                     'state_max_diff': p_diff, 'identical': identical,
                     'launches_per_rank': [ranks[r][what]['launches']
                                           for r in range(2)]}
    # (e) the directory both ranks wrote (the file's `step` buffer holds
    # the step it was saved at, 1)
    payload = load_checkpoint(out_dir / 'student.dcp')
    state = dict(ranks[0]['student']['state'],
                 step=torch.ones(1, dtype=torch.long))
    apart = [k for k, v in state.items()
             if not torch.equal(payload['model'][k], v)]
    same = not apart
    torch.manual_seed(1)
    fresh = ForwardTacotron.from_config(cfg)
    opt = tc.make_optimizer(fresh)
    step = restore(fresh, opt, payload)
    back = all(torch.equal(fresh.state_dict()[k], v)
               for k, v in state.items())
    parts = sorted(p.name for p in (out_dir / 'student.dcp' / 'state')
                   .iterdir())
    log(f'  checkpoint directory of the 2 ranks: {parts}; loads equal '
        f'{same} (apart: {apart[:5]}), restores equal {back}, step {step}')
    check(same and back and step == 1 and payload['optim'] is not None,
          'the 2 ranks\' checkpoint directory round-trips')
    out['checkpoint_directory'] = {'files': parts, 'equal': same,
                                   'restored': back}
    return out


def _torchrun_cli(cfg, base, data, smi):
    """(c): `train_forward` under torchrun (one process, NCCL) for 2 steps;
    rank 0's checkpoint loads."""
    import os
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.utils.checkpoints import load_checkpoint
    cli_cfg = copy.deepcopy(cfg)
    cli_cfg['data_path'] = str(data)
    cli_cfg['tts_model_id'] = 'smoke_parallel_cli'
    cli_cfg['forward_tacotron']['training'].update(
        schedule=[f'1e-4, 2, {PARALLEL_BATCH}'], checkpoint_every=1000)
    path = base / 'cli.json'
    path.write_text(json.dumps(cli_cfg))
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
           '--nproc_per_node', '1', '-m',
           'forwardtacotron_tpu_torch.train_forward', '--config', str(path)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, FTT_BASE=str(base / 'cli')))
    wall = time.perf_counter() - t0
    (base / 'torchrun.log').write_text(proc.stdout + proc.stderr)
    lines = [s for s in proc.stdout.splitlines() if 'torch.distributed' in s]
    log(f'  {" ".join(cmd[1:8])} ... train_forward: exit {proc.returncode} '
        f'in {wall:.1f} s; {lines}')
    check(proc.returncode == 0, f'torchrun train_forward exited '
                                f'{proc.returncode}: {proc.stderr[-2000:]}')
    check(lines == ['| torch.distributed: nccl, rank 0 of 1, cuda:0'],
          f'the CLI brought up NCCL on cuda:0: {lines}')
    ckpt = (base / 'cli' / 'checkpoints' / 'smoke_parallel_cli.forward'
            / 'latest_model.pt')
    payload = load_checkpoint(ckpt)
    ForwardTacotron.from_config(cli_cfg).load_state_dict(payload['model'])
    check(payload['step'] == 2, f'rank 0\'s checkpoint loads, step '
                                f'{payload["step"]}')
    DETAILS['torchrun_log_tail'] = (proc.stdout + proc.stderr)[-4000:]
    return {'wall_s': wall, 'returncode': proc.returncode, 'group': lines}


@contextlib.contextmanager
def _deterministic():
    """Deterministic algorithms (cuDNN's and torch's), restored after;
    yields the warnings of ops that have no deterministic version. cuDNN's
    default algorithms make the student's step differ from itself run to
    run (3.05e-5 after 3 steps on an H100 80GB HBM3)."""
    saved = (torch.backends.cudnn.deterministic,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as noted:
            warnings.simplefilter('always')
            yield noted
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1], warn_only=saved[2])


def _trainer_runs(s_cfg, v_cfg, dsp, mesh, base, runs, launches, out):
    """(a)'s three runs of ForwardTrainer and VocTrainer from the same
    seeds: no group, the one-rank mesh, no group again; each run's states
    and models in `runs`, its launches in `launches`."""
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.models.wavernn import WaveRNN
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.forward_trainer import ForwardTrainer
    from forwardtacotron_tpu_torch.train.voc_trainer import VocTrainer
    from forwardtacotron_tpu_torch.utils.paths import Paths
    for tag, m in (('one', None), ('mesh', mesh), ('again', None)):
        torch.manual_seed(0)
        student = ForwardTacotron.from_config(s_cfg).to('cuda')
        trainer = ForwardTrainer(Paths(s_cfg['data_path'],
                                       f'par_{tag}', base=base),
                                 s_cfg, 'cuda', mesh=m)
        torch.manual_seed(0)
        vocoder = WaveRNN.from_config(v_cfg).to('cuda')
        v_trainer = VocTrainer(Paths(v_cfg['data_path'], 'par_tts',
                                     base=base, voc_id=f'par_{tag}'),
                               dsp, v_cfg, 'cuda', mesh=m)
        _all_counts(reset=True)
        t0 = time.perf_counter()
        s_step = trainer.train(student, tc.make_optimizer(student))
        torch.cuda.synchronize()
        s_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        v_step = v_trainer.train(vocoder, tc.make_optimizer(vocoder))
        torch.cuda.synchronize()
        v_wall = time.perf_counter() - t0
        launches[tag] = _all_counts()
        runs[tag] = (_copy_state(student), _copy_state(vocoder), student,
                     vocoder)
        log(f'  {tag}: student {s_step} steps in {s_wall:.1f} s, WaveRNN '
            f'{v_step} steps in {v_wall:.1f} s (host clock, evaluate() '
            f'included); launches {launches[tag]}')
        check(s_step == v_step == PARALLEL_STEPS,
              f'{tag}: both trainers reached step {PARALLEL_STEPS}')
        out[tag] = {'student_wall_s': s_wall, 'wavernn_wall_s': v_wall,
                    'launches': launches[tag]}


def _one_rank(cfg, base, data, voc_data, smi):
    """(a): ForwardTrainer and VocTrainer under a one-rank NCCL mesh
    against the same trainers without a group, and against a second run
    without one (the card's own run-to-run difference); the steps with
    and without the collectives, and the gradient all-reduce alone."""
    import torch.distributed as dist
    from forwardtacotron_tpu_torch.data.dataset import (get_tts_datasets,
                                                        get_vocoder_datasets)
    from forwardtacotron_tpu_torch.dsp.audio import DSP
    from forwardtacotron_tpu_torch.parallel import (data_parallel, make_mesh,
                                                    reduce_gradients)
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.forward_trainer import (
        batch_to_device)
    from forwardtacotron_tpu_torch.train.voc_trainer import voc_micro_loss
    from forwardtacotron_tpu_torch.train.voc_trainer import (
        batch_to_device as voc_to_device)
    torch.cuda.set_device(0)
    dist.init_process_group('nccl', init_method=f'tcp://127.0.0.1:'
                            f'{_free_port()}', rank=0, world_size=1)
    out = {}
    try:
        mesh = make_mesh()
        log(f'  {mesh}')
        s_cfg = copy.deepcopy(cfg)
        s_cfg['data_path'] = str(data)
        s_cfg['forward_tacotron']['training'].update(
            schedule=[f'1e-4, {PARALLEL_STEPS}, {PARALLEL_BATCH}'],
            checkpoint_every=1000)
        v_cfg = copy.deepcopy(cfg)
        v_cfg['data_path'] = str(voc_data)
        v_cfg['vocoder']['training'].update(
            schedule=[f'1e-4, {PARALLEL_STEPS}, {PARALLEL_BATCH}'],
            checkpoint_every=1000, gen_samples_every=1000)
        dsp = DSP.from_config(v_cfg, 'cuda')
        runs, launches = {}, {}
        with _deterministic() as noted:
            _trainer_runs(s_cfg, v_cfg, dsp, mesh, base, runs, launches, out)
        nondet = sorted({str(w.message).split('\n')[0][:160] for w in noted
                         if 'deterministic' in str(w.message)})
        log(f'  ops without a deterministic version in these runs: {nondet}')
        out['nondeterministic_ops'] = nondet
        student, vocoder = runs['mesh'][2:]
        s_diff = _max_diff(runs['mesh'][0], runs['one'][0])
        v_diff = _max_diff(runs['mesh'][1], runs['one'][1])
        s_again = _max_diff(runs['again'][0], runs['one'][0])
        v_again = _max_diff(runs['again'][1], runs['one'][1])
        log(f'  one-rank mesh against no group after {PARALLEL_STEPS} steps '
            f'(deterministic algorithms): student max {s_diff:.3g}, WaveRNN '
            f'max {v_diff:.3g}; no group twice: {s_again:.3g}, '
            f'{v_again:.3g}')
        check(s_diff <= 1e-6 and v_diff <= 1e-6,
              f'one-rank NCCL mesh within 1e-6 of no group (student '
              f'{s_diff:.3g}, WaveRNN {v_diff:.3g})')
        for name in ('birnn_train_fwd', 'birnn_train_bwd', 'birnn'):
            check(launches['mesh'][name] == launches['one'][name] > 0,
                  f'{name} launched {launches["mesh"][name]} times under the '
                  f'mesh, {launches["one"][name]} without')
        out.update({'student_max_diff': s_diff, 'wavernn_max_diff': v_diff,
                    'student_run_to_run': s_again,
                    'wavernn_run_to_run': v_again})

        # each step with and without the collectives, and the all-reduce
        s_train, _ = get_tts_datasets(s_cfg['data_path'], PARALLEL_BATCH, 1,
                                      None)
        s_batch = batch_to_device(next(iter(s_train)), 'cuda')
        v_tc = v_cfg['vocoder']['training']
        v_train, _, _ = get_vocoder_datasets(
            v_cfg['data_path'], PARALLEL_BATCH, False, v_tc['max_mel_len'],
            v_cfg['dsp']['hop_length'], vocoder.pad, v_tc['seq_len'], 'RAW',
            v_cfg['dsp']['bits'], 1)
        v_batch = voc_to_device(next(iter(v_train)), 'cuda')
        s_opt, v_opt = (tc.make_optimizer(student),
                        tc.make_optimizer(vocoder))
        s_parts = _student_parts(student, s_opt, s_batch,
                                 s_cfg['forward_tacotron']['training'])
        v_parts = train_parts(vocoder, v_opt, voc_micro_loss(vocoder, 'RAW'),
                              v_batch, v_tc)
        timing = {}
        for what, parts, model in (('student', s_parts, student),
                                   ('wavernn', v_parts, vocoder)):
            plain = step_timing(parts, f'{what} step, no group', smi)
            with data_parallel(mesh):
                under = step_timing(parts, f'{what} step, one-rank NCCL mesh',
                                    smi)
                reduce_ms = cuda_ms(lambda: reduce_gradients(
                    model.parameters()), reps=10)
            n_grad = sum(p.numel() for p in model.parameters())
            log(f'  {what}: step {plain["step_ms"]:.2f} ms without the group,'
                f' {under["step_ms"]:.2f} under the mesh (optimizer part '
                f'{plain["optimizer_ms"]:.2f} -> {under["optimizer_ms"]:.2f}'
                f'); the gradient all-reduce alone ({n_grad} floats) '
                f'{reduce_ms:.3f} ms | {smi}')
            timing[what] = {'no_group': plain, 'mesh': under,
                            'all_reduce_ms': reduce_ms, 'n_grad': n_grad}
        out['step_ms'] = timing
        out['launches_mesh'] = launches['mesh']
    finally:
        dist.destroy_process_group()
    return out


@phase('data parallelism (full width)')
def parallel_path():
    """`parallel/` on the one H100 at config.yaml's widths, random weights
    from seeds, in PARALLEL_DIR. Cuts: two ranks share the one card (gloo,
    which carries CUDA tensors: NCCL refuses two ranks on one device), not
    two cards; the student and WaveRNN PARALLEL_STEPS steps (300k and
    600k); datasets of phase 8 (96 + 32 items, 520-870 frames) and phase
    10 (64 + 32 items, 400-600 frames).

    (d) `vocode_batch` over a mesh of [cuda:0, cuda:0] with 3 and 8 mels
        (`_sharded_vocoding`) and `TTSServer(wavernn, mesh=)`;
    (b) two gloo ranks of 16 rows each against one process at 32 on the
        card, one student and one WaveRNN step (`_two_ranks`), and (e)
        their checkpoint directory;
    (c) `train_forward` under torchrun, NCCL (`_torchrun_cli`);
    (a) ForwardTrainer and VocTrainer under a one-rank NCCL mesh against
        no group, the steps' times with and without the collectives
        (`_one_rank`)."""
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.data.dataset import (get_tts_datasets,
                                                        get_vocoder_datasets)
    smi = nvidia_smi_line()
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    PARALLEL_DIR.mkdir(parents=True)
    base = PARALLEL_DIR.resolve()
    cfg = _no_dropout_student(default_config())
    out = {'nvidia_smi': smi}
    try:
        data, voc_data = base / 'data', base / 'voc_data'
        _write_dataset(data)
        _write_voc_dataset(voc_data, cfg)
        out['vocode'] = _sharded_vocoding(cfg, smi)
        s_train, _ = get_tts_datasets(data, PARALLEL_BATCH, 1, None)
        student_batch = next(b for b in s_train.batches(0)
                             if b['x'].shape[0] == PARALLEL_BATCH)
        v_tc = cfg['vocoder']['training']
        v_train, _, _ = get_vocoder_datasets(
            voc_data, PARALLEL_BATCH, False, v_tc['max_mel_len'],
            cfg['dsp']['hop_length'], cfg['vocoder']['model']['pad'],
            v_tc['seq_len'], 'RAW', cfg['dsp']['bits'], 1)
        batches = {'student': student_batch,
                   'wavernn': next(iter(v_train))}
        log(f'  global student batch: mel_len {sorted(student_batch["mel_len"].tolist())}')
        out['two_ranks'] = _two_ranks(cfg, base, batches, smi)
        out['torchrun'] = _torchrun_cli(cfg, base, data, smi)
        out['one_rank'] = _one_rank(cfg, base, data, voc_data, smi)
        out['launches'] = {
            k: out['one_rank']['launches_mesh'].get(k, 0)
            + out['two_ranks']['student']['launches_per_rank'][0].get(k, 0)
            + out['two_ranks']['wavernn']['launches_per_rank'][0].get(k, 0)
            for k in out['one_rank']['launches_mesh']}
        out['launches']['wavernn_sample'] += \
            out['vocode']['launches']['wavernn_sample']
    finally:
        shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    DETAILS['parallel_path'] = out
    return out


# ------------------------------------------------------------- phase 17

AXIS_DIR = Path('smoke_axis')   # dataset, checkpoints and logs of phase 17
AXIS_STEPS = 2
AXIS_BATCH = 32
MEMORY_REL = 0.02               # resident bytes against param_spec's share


class _Recorder:
    """A writer for the card's machine, which has no tensorboardX: keeps
    every scalar, figure tag and wav."""

    def __init__(self):
        self.scalars, self.figures, self.wavs = [], [], []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))

    def add_figure(self, tag, fig, step):
        self.figures.append((tag, int(step)))

    def add_audio(self, tag, wav, step, sample_rate):
        self.wavs.append((tag, int(step), np.asarray(wav), int(sample_rate)))


def _plots_run(kind, cfg, base, smi):
    """(a) for one trainer: `ForwardTrainer` (kind 'student') or
    `TacoTrainer` (r=5) for AXIS_STEPS steps at batch 32 with `plot_every`
    1 and a recording writer; then `generate_plots` once more, timed by
    CUDA events, and its #1 launches against those of the eval forward
    and the generation it runs, called directly."""
    from forwardtacotron_tpu_torch.data.dataset import get_tts_datasets
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.models.tacotron import Tacotron
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.forward_trainer import (
        ForwardTrainer, batch_to_device)
    from forwardtacotron_tpu_torch.train.taco_trainer import (
        TacoTrainer, taco_batch_to_device)
    from forwardtacotron_tpu_torch.utils.display import can_plot
    from forwardtacotron_tpu_torch.utils.paths import Paths
    student = kind == 'student'
    r = 1 if student else 5
    section = 'forward_tacotron' if student else 'tacotron'
    cfg = copy.deepcopy(cfg)
    cfg[section]['training'].update(
        schedule=[f'1e-4, {AXIS_STEPS}, {AXIS_BATCH}' if student
                  else f'{r}, 1e-4, {AXIS_STEPS}, {AXIS_BATCH}'],
        plot_every=1, checkpoint_every=1000)
    paths = Paths(cfg['data_path'], f'axis_{kind}', base=base)
    writer = _Recorder()
    torch.manual_seed(0)
    model = (ForwardTacotron if student else Tacotron).from_config(cfg)
    trainer = (ForwardTrainer if student else TacoTrainer)(
        paths, cfg, DEVICE, writer=writer)
    _all_counts(reset=True)
    t0 = time.perf_counter()
    step = trainer.train(model, tc.make_optimizer(model))
    _sync(DEVICE)
    wall = time.perf_counter() - t0
    launches = _all_counts()
    check(step == AXIS_STEPS, f'{kind}: the trainer reached step {step}')
    wav_tags = ['Ground_Truth_Aligned/target_wav',
                'Ground_Truth_Aligned/postnet_wav', 'Generated/postnet_wav']
    check([t for t, _, _, _ in writer.wavs] == AXIS_STEPS * wav_tags,
          f'{kind}: generate_plots wrote its three wavs at every step '
          f'({[t for t, _, _, _ in writer.wavs]})')
    val = get_tts_datasets(paths.data, AXIS_BATCH, r, None,
                           model_type='forward' if student else 'tacotron',
                           filter_attention=False)[1]
    sample = val.first_batch()
    hop = cfg['dsp']['hop_length']
    target_len = (min(600, sample['mel'].shape[1]) - 1) * hop
    for tag, _, wav, sr in writer.wavs:
        check(np.isfinite(wav).all() and wav.dtype == np.float32
              and sr == cfg['dsp']['sample_rate'],
              f'{kind}: {tag} finite float32 at {sr} Hz')
        if tag != 'Generated/postnet_wav':
            check(len(wav) == target_len,
                  f'{kind}: {tag} has the target length ({len(wav)} vs '
                  f'{target_len})')
    if can_plot():
        check(len(writer.figures) > 0, f'{kind}: figures written')
    else:
        check(not writer.figures and trainer._plots_noted,
              f'{kind}: no matplotlib here: the figures skipped with the '
              'note')
    session = types.SimpleNamespace(val_sample=sample, r=r)
    _all_counts(reset=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    trainer.generate_plots(model, session, step)
    end.record()
    torch.cuda.synchronize()
    plots_ms = start.elapsed_time(end)
    in_plots = _all_counts()['birnn']
    _all_counts(reset=True)
    model.eval()
    with torch.no_grad():
        if student:
            batch = batch_to_device(sample, DEVICE)
            model(batch)
            model.generate(batch['x'][0:1], int(batch['mel'].shape[1]),
                           x_len=batch['x_len'][0:1],
                           compute_dtype=torch.float32)
        else:
            batch = taco_batch_to_device(sample, DEVICE)
            model(batch['x'], batch['mel'], r)
            steps = int(batch['mel_len'][0]) + 20
            model.generate(batch['x'][0:1], steps + (-steps) % r, r)
    _sync(DEVICE)
    direct = _all_counts()['birnn']
    model.train()
    log(f'  {kind}: {step} steps with plots at every step in {wall:.1f} s '
        f'(host clock); generate_plots {plots_ms:.1f} ms (CUDA events) with '
        f'{in_plots} #1 launches ({direct} in its forward and generation '
        f'called directly); figures {len(writer.figures)}, wavs '
        f'{len(writer.wavs)}; launches {launches} | {smi}')
    check(in_plots == direct > 0, f'{kind}: generate_plots launched #1 as '
                                  f'its passes do ({in_plots} vs {direct})')
    return {'wall_s': wall, 'generate_plots_ms': plots_ms,
            'birnn_launches_in_plots': in_plots, 'launches': launches,
            'figures': len(writer.figures),
            'wavs': [(t, len(w)) for t, _, w, _ in writer.wavs]}


def _axis_model(kind, cfg, device):
    from forwardtacotron_tpu_torch.models.forward_tacotron import (
        ForwardTacotron)
    from forwardtacotron_tpu_torch.models.wavernn import WaveRNN
    torch.manual_seed(0)
    return (ForwardTacotron if kind == 'student' else WaveRNN).from_config(
        cfg).to(device)


def _axis_step(kind, cfg, batch, mesh, device):
    """One step of `kind` ('student' or 'wavernn') from seed 0 on the
    whole `batch`, the weights in shards over `mesh`'s 'model' axis:
    (metrics, this rank's gradients, the state after gathered whole, the
    launches, the resident bytes of the parameters and Adam's state
    between steps and those `param_spec` predicts)."""
    import gc
    from forwardtacotron_tpu_torch.parallel import data_parallel
    from forwardtacotron_tpu_torch.parallel.mesh import param_specs
    from forwardtacotron_tpu_torch.parallel.model_axis import (shard_module,
                                                               unshard)
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train import forward_trainer, voc_trainer
    n = 1 if mesh is None else mesh.shape['model']
    before_model = _allocated(device)[0]
    model = _axis_model(kind, cfg, device)
    specs = param_specs(model, n)
    whole = {name: p.numel() * p.element_size()
             for name, p in model.named_parameters()}
    opt = tc.make_optimizer(model)
    shard_module(model, mesh, [opt])
    sharded_model = _allocated(device)[0] - before_model
    if kind == 'student':
        rows = forward_trainer.batch_to_device(batch, device)
    else:
        rows = voc_trainer.batch_to_device(batch, device)
    _all_counts(reset=True)
    with data_parallel(mesh):
        if kind == 'student':
            metrics = tc.train_step(
                model, opt, rows, torch.Generator(device).manual_seed(0),
                cfg['forward_tacotron']['training'])
        else:
            metrics = voc_trainer.voc_train_step(
                model, opt, rows, 'RAW',
                cfg['vocoder']['training']['clip_grad_norm'])
    _sync(device)
    launches = _all_counts()
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()
             if p.grad is not None}
    predicted = sum(b.numel() * b.element_size() for b in model.buffers())
    for name, p in model.named_parameters():
        share = whole[name] // (1 if specs[name] is None else n)
        predicted += share * (3 if p in opt.state else 1)
    del rows
    opt.zero_grad(set_to_none=True)
    gc.collect()
    with_model = _allocated(device)
    storages = {}
    for t in list(model.parameters()) + list(model.buffers()) + [
            v for st in opt.state.values() for v in st.values()
            if torch.is_tensor(v)]:
        if t.device.type != 'cpu':
            storages[t.untyped_storage().data_ptr()] = \
                t.untyped_storage().nbytes()
    unshard(model)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model, opt
    gc.collect()
    resident = [a - b for a, b in zip(with_model, _allocated(device))]
    return {'metrics': {k: float(v) for k, v in metrics.items()},
            'grads': grads, 'state': state, 'launches': launches,
            'resident_bytes': resident[1], 'allocated_bytes': resident[0],
            'predicted_bytes': predicted,
            'tensor_bytes': sum(storages.values()),
            'resident_before_step': sharded_model,
            'whole_param_bytes': sum(whole.values()),
            'model_rank': 0 if mesh is None else mesh.model_rank}


def _sync(device):
    if device == 'cuda':
        torch.cuda.synchronize()


def _allocated(device):
    """The caching allocator's (allocated, requested) bytes on the device
    ((0, 0) off the card, where no check of them can pass), after it has
    handled the completed events of blocks freed while another stream
    used them (gloo's). Allocated counts whole blocks: a large block keeps
    up to 1 MB of slack where the rest is too small to split off;
    requested counts what the tensors asked for."""
    if device != 'cuda':
        return 0, 0
    torch.cuda.synchronize()
    torch.empty(1, device=device)     # malloc processes completed events
    return (torch.cuda.memory_allocated(),
            torch.cuda.memory_stats()['requested_bytes.all.current'])


def _axis_rank(rank, store, base, out_dir, device):
    """(b): rank `rank` of 2 gloo ranks sharing `device` (cuda:0) as data
    1 x model 2: one student step and one WaveRNN step on the whole global
    batch, the weights in shards. Results in out_dir/rank<r>.pt."""
    import torch.distributed as dist
    if device == 'cuda':
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group('gloo', init_method=f'file://{store}',
                            rank=rank, world_size=2)
    try:
        from forwardtacotron_tpu_torch.parallel import make_mesh
        mesh = make_mesh(n_data=1, n_model=2, devices=[device, device])
        cfg, batches = torch.load(Path(base) / 'axis_inputs.pt',
                                  weights_only=False)
        out = {}
        for kind in ('student', 'wavernn'):
            t0 = time.perf_counter()
            out[kind] = _axis_step(kind, cfg, batches[kind], mesh, device)
            out[kind]['wall_s'] = time.perf_counter() - t0
        torch.save(out, Path(out_dir) / f'rank{rank}.pt')
    finally:
        dist.destroy_process_group()


def _model_axis(cfg, base, batches, smi):
    """(b): two gloo ranks on cuda:0 as data 1 x model 2 against one
    process on the whole batch of 32."""
    import torch.multiprocessing as mp
    out_dir = base / 'axis_ranks'
    out_dir.mkdir()
    torch.save((cfg, batches), base / 'axis_inputs.pt')
    t0 = time.perf_counter()
    ctx = mp.start_processes(_axis_rank, args=(
        str(base / 'axis_store'), str(base), str(out_dir), DEVICE), nprocs=2,
        join=False, start_method='spawn')
    deadline = time.monotonic() + 600
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError('two ranks still running after 600 s')
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    wall = time.perf_counter() - t0
    ranks = [torch.load(out_dir / f'rank{r}.pt', weights_only=False)
             for r in range(2)]
    out = {'wall_s': wall}
    for kind, step, clip, lr in (
            ('student', _student_step,
             cfg['forward_tacotron']['training']['clip_grad_norm'], 1e-4),
            ('wavernn', _wavernn_step,
             cfg['vocoder']['training']['clip_grad_norm'], 1e-4)):
        one = step(cfg, batches[kind])[2]
        r0, r1 = ranks[0][kind], ranks[1][kind]
        identical = all(torch.equal(r0['state'][k], r1['state'][k])
                        for k in r0['state'])
        loss_rel = abs(r0['metrics']['loss'] - one['metrics']['loss']) \
            / abs(one['metrics']['loss'])
        want = _unclipped(one, clip)
        g_abs = g_rel = 0.0
        for res in (r0, r1):
            got = _unclipped(res, clip)
            chunks = {}
            for k, w in want.items():
                if got[k].shape != w.shape:
                    dim = [a != b for a, b in zip(got[k].shape,
                                                  w.shape)].index(True)
                    w = w.chunk(2, dim)[res['model_rank']]
                chunks[k] = w
            a, rel = _large_grad_errors(got, chunks)
            g_abs, g_rel = max(g_abs, a), max(g_rel, rel)
        p_diff = _max_diff(r0['state'], one['state'])
        fwd = [ranks[r][kind]['launches']['birnn_train_fwd'] for r in range(2)]
        bwd = [ranks[r][kind]['launches']['birnn_train_bwd'] for r in range(2)]
        mem = [(ranks[r][kind]['resident_bytes'],
                ranks[r][kind]['predicted_bytes']) for r in range(2)]
        allocated = [ranks[r][kind]['allocated_bytes'] for r in range(2)]
        log(f'  {kind}: a rank\'s device tensors between steps (unique '
            f'storages of the parameters, buffers and Adam state) '
            f'{[ranks[r][kind]["tensor_bytes"] for r in range(2)]}; '
            f'memory_allocated by them {allocated} (whole blocks: the '
            f'allocator\'s slack included); allocated by the model made '
            f'and sharded, before the step '
            f'{[ranks[r][kind]["resident_before_step"] for r in range(2)]}')
        mem_rel = max(abs(a - b) / b for a, b in mem)
        log(f'  {kind}, data 1 x model 2 (2 gloo ranks on cuda:0) against '
            f'one process at {AXIS_BATCH}: loss {r0["metrics"]["loss"]:.6f} '
            f'vs {one["metrics"]["loss"]:.6f} (rel {loss_rel:.3g}); gradient '
            f'shards where |g| > 1e-4: max abs {g_abs:.3g}, max rel '
            f'{g_rel:.3g}; state after max {p_diff:.3g}; peers identical '
            f'{identical}; #2 {fwd} #3 {bwd} a rank; resident bytes '
            f'(requested, param_spec) {mem} of {r0["whole_param_bytes"]} '
            f'whole parameter bytes (rel {mem_rel:.3g}); rank seconds '
            f'{[ranks[r][kind]["wall_s"] for r in range(2)]} | {smi}')
        check(loss_rel <= 1e-5, f'{kind}: model-axis loss within rel 1e-5 '
                                f'of one process ({loss_rel:.3g})')
        check(g_abs <= 1e-4, f'{kind}: gradient shards within 1e-4 where '
                             f'|g| > 1e-4 ({g_abs:.3g})')
        check(p_diff <= 2 * lr + 1e-6, f'{kind}: parameters after within '
                                       f'2 lr of one process ({p_diff:.3g})')
        check(identical, f'{kind}: the peers\' gathered weights '
                         'bit-identical')
        check(all(f > 0 for f in fwd) and all(b > 0 for b in bwd),
              f'{kind}: #2/#3 launched on each rank ({fwd}, {bwd})')
        check(mem_rel <= MEMORY_REL, f'{kind}: each rank\'s resident '
                                     f'parameters and Adam state (the '
                                     f'allocator\'s requested bytes) within '
                                     f'{MEMORY_REL:.0%} of param_spec\'s '
                                     f'share ({mem})')
        out[kind] = {'loss': r0['metrics']['loss'],
                     'loss_one': one['metrics']['loss'], 'loss_rel': loss_rel,
                     'grad_max_abs': g_abs, 'grad_max_rel': g_rel,
                     'state_max_diff': p_diff, 'identical': identical,
                     'resident_bytes': mem, 'memory_rel': mem_rel,
                     'tensor_bytes': [ranks[r][kind]['tensor_bytes']
                                      for r in range(2)],
                     'allocated_bytes': allocated,
                     'whole_param_bytes': r0['whole_param_bytes'],
                     'rank_wall_s': [ranks[r][kind]['wall_s']
                                     for r in range(2)],
                     'launches_per_rank': [ranks[r][kind]['launches']
                                           for r in range(2)]}
    return out


@phase('plots, writers and the mesh\'s model axis (full width)')
def logging_and_model_axis_path():
    """The trainers' plots and audio samples and the mesh's 'model' axis
    on the one H100 at config.yaml's widths, random weights from seeds, in
    AXIS_DIR. Cuts: AXIS_STEPS steps of each trainer (300k and 600k);
    phase 8's dataset (96 + 32 items, 520-870 frames); a recording writer
    (the card's machine has neither tensorboardX nor matplotlib, so the
    figures are skipped with the note); the 'model' axis over two gloo
    ranks sharing the one card (NCCL refuses two ranks on one device),
    not two cards.

    (a) `ForwardTrainer.train` and `TacoTrainer.train` (r=5) at batch 32
        with `plot_every` 1 (`_plots_run`): `generate_plots` on the card,
        its wavs, its #1 launches and its time;
    (b) two ranks as data 1 x model 2 against one process, a student and
        a WaveRNN step each, and what each rank stores (`_model_axis`)."""
    from forwardtacotron_tpu_torch.config import default_config
    from forwardtacotron_tpu_torch.data.dataset import (get_tts_datasets,
                                                        get_vocoder_datasets)
    smi = nvidia_smi_line()
    shutil.rmtree(AXIS_DIR, ignore_errors=True)
    AXIS_DIR.mkdir(parents=True)
    base = AXIS_DIR.resolve()
    cfg = _no_dropout_student(default_config())
    out = {'nvidia_smi': smi}
    try:
        data, voc_data = base / 'data', base / 'voc_data'
        _write_dataset(data)
        cfg['data_path'] = str(data)
        out['student_plots'] = _plots_run('student', cfg, base, smi)
        out['teacher_plots'] = _plots_run('teacher', cfg, base, smi)
        _write_voc_dataset(voc_data, cfg)
        s_train, _ = get_tts_datasets(data, AXIS_BATCH, 1, None)
        v_tc = cfg['vocoder']['training']
        v_train, _, _ = get_vocoder_datasets(
            voc_data, AXIS_BATCH, False, v_tc['max_mel_len'],
            cfg['dsp']['hop_length'], cfg['vocoder']['model']['pad'],
            v_tc['seq_len'], 'RAW', cfg['dsp']['bits'], 1)
        batches = {'student': next(b for b in s_train.batches(0)
                                   if b['x'].shape[0] == AXIS_BATCH),
                   'wavernn': next(iter(v_train))}
        out['model_axis'] = _model_axis(cfg, base, batches, smi)
        launches = {}
        for part in (out['student_plots']['launches'],
                     out['teacher_plots']['launches'],
                     out['model_axis']['student']['launches_per_rank'][0],
                     out['model_axis']['wavernn']['launches_per_rank'][0]):
            for k, v in part.items():
                launches[k] = launches.get(k, 0) + v
        out['launches'] = launches
    finally:
        shutil.rmtree(AXIS_DIR, ignore_errors=True)
    DETAILS['logging_and_model_axis_path'] = out
    return out


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument('--only', nargs='+', default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        log('chip_smoke: torch.cuda is not available; this script needs '
            'an NVIDIA GPU')
        return 2
    import forwardtacotron_tpu_torch  # noqa: F401  (fails outside the repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log(f'device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | '
        f'torch {torch.__version__} cuda {torch.version.cuda}')
    build_kernels()
    if args.only:
        for name in args.only:
            globals()[name]()
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / 'chip_smoke_only.json').write_text(json.dumps(
            {'nvidia_smi': smi, 'failures': FAILURES, **DETAILS}, indent=1,
            default=str))
        log(f'\n{len(FAILURES)} failures: '
            + '; '.join(f.splitlines()[0] for f in FAILURES))
        return 1 if FAILURES else 0
    birnn_rows = birnn_cases() or []
    wr = wavernn_cases() or {}
    launches = main_path() or {}
    serving_path()
    train_rows, bf16_rows = train_kernel_cases() or ([], [])
    train_launches = training_path() or {}
    teacher = teacher_path() or {}
    voc = vocoder_path() or {}
    opts = options_path() or {}
    fp = fast_pitch_and_teacher_path() or {}
    ms = speakers_and_aligner_path() or {}
    ef = export_and_fused_path() or {}
    nio = native_io_path() or {}
    par = parallel_path() or {}
    ax = logging_and_model_axis_path() or {}

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / 'chip_smoke.json').write_text(json.dumps(
        {'nvidia_smi': smi, 'failures': FAILURES, **DETAILS}, indent=1,
        default=str))
    if FAILURES:
        log(f'\nFAILED ({len(FAILURES)}):')
        for f in FAILURES:
            log(f'  - {f.splitlines()[0]}')
        return 1

    # kernel #1's cooperative path is on neither main path (no shape of
    # config.yaml takes it); phase 3 checks and times it (chip_smoke.json)
    serving = next(r for r in birnn_rows if r['case'].startswith(
        'decoder lstm T=1024 H=512 S=2 B=1 bfloat16'))
    # the vocoder-training path's launches (phase 10): #1 in evaluate(),
    # #2/#3 in the RAW and MOL steps, #4 in generate_samples
    voc_launches = {k: voc['wavernn']['launches'][k]
                    + voc['wavernn']['mol']['launches'].get(k, 0)
                    for k in voc['wavernn']['launches']}
    voc_birnn = next(r for r in birnn_rows if 'wavernn' in r['case'])
    voc_train = next(r for r in train_rows if 'wavernn' in r['case'])
    # the training options' path (phase 11): the student's and WaveRNN's
    # trainer runs with their options on
    opt_launches = {k: opts['student_trainer']['launches'].get(k, 0)
                    + opts['wavernn_trainer']['launches'].get(k, 0)
                    for k in opts['wavernn_trainer']['launches']}
    # the FastPitch paths (phase 12: training, gen_forward, TTSServer) and
    # the teacher's free-running synthesis (gen_tacotron)
    fpl, gtl = fp['fast_pitch'], fp['gen_tacotron']
    # phase 13: the multi-speaker teacher, student, CLIs and server, and
    # the teacher-free aligner (which launches none)
    msl, all_ = ms['multispeaker'], ms['aligner']
    # phase 14: every kernel counted by name in one profiled replay of each
    # fused graph (HiFi-GAN, WaveRNN), and in the exported artifacts'
    # profiled calls (#2/#3, training kernels, are counted there too)
    fus, exl = ef['fused'], ef['export']
    # phase 15: the student and WaveRNN fed by the native loader
    nil = nio['launches']
    # phase 16: the one-rank mesh's trainers, rank 0 of the two ranks'
    # steps, the sharded vocode and the server with a mesh
    pal = par['launches']
    # phase 17: the student's and the teacher's runs with plots at every
    # step, and rank 0 of the model axis's student and WaveRNN steps
    axl = ax['launches']
    kernels = [
        {'name': 'birnn (stream-local path)', 'route': 'cuda',
         'source': 'forwardtacotron_tpu_torch/csrc/birnn.cu',
         'replaces': 'forwardtacotron_tpu/kernels/birnn.py:45',
         'launches': launches['birnn_stream_local'],
         'launches_teacher': sum(teacher[k]['birnn_stream_local']
                                 for k in ('evaluate', 'align')),
         'case': serving['case'],
         'max_abs_err': serving['max_abs_err']['stream_local'],
         'ms': serving['ms_stream_local'], 'plain_ms': serving['plain_ms'],
         'bound_ms': serving['bound_ms'], 'bound_by': serving['bound_by'],
         'library_ms': serving['library_ms'],
         'launches_vocoder': voc_launches['birnn_stream_local'],
         'launches_options': opt_launches['birnn_stream_local'],
         'launches_fast_pitch': fpl['birnn_stream_local'],
         'launches_gen_tacotron': gtl['birnn_stream_local'],
         'launches_multispeaker': msl['birnn_stream_local'],
         'launches_aligner': all_['birnn_stream_local'],
         'launches_fused': fus['birnn_stream_local'],
         'launches_export': exl['birnn_stream_local'],
         'launches_native_io': nil['birnn_stream_local'],
         'launches_parallel': pal['birnn_stream_local'],
         'launches_logging_model_axis': axl['birnn_stream_local'],
         'vocoder_case': voc_birnn['case'],
         'vocoder_ms': voc_birnn['ms_stream_local'],
         'vocoder_plain_ms': voc_birnn['plain_ms'],
         'vocoder_bound_ms': voc_birnn['bound_ms'],
         'vocoder_library_ms': voc_birnn['library_ms']}]
    kernels.append(
        {'name': 'wavernn_sample', 'route': 'cuda',
         'source': 'forwardtacotron_tpu_torch/csrc/wavernn_sample.cu',
         'replaces': 'forwardtacotron_tpu/kernels/wavernn_sample.py:64',
         'launches': launches['wavernn_sample'], 'launches_teacher': 0,
         'launches_vocoder': voc_launches['wavernn_sample'],
         'launches_options': opt_launches['wavernn_sample'],
         'launches_fast_pitch': fpl['wavernn_sample'],
         'launches_gen_tacotron': gtl['wavernn_sample'],
         'launches_multispeaker': msl['wavernn_sample'],
         'launches_aligner': all_['wavernn_sample'],
         'launches_fused': fus['wavernn_sample'],
         'launches_export': exl['wavernn_sample'],
         'launches_native_io': nil['wavernn_sample'],
         'launches_parallel': pal['wavernn_sample'],
         'launches_logging_model_axis': axl['wavernn_sample'],
         'max_abs_err': wr['max_abs_err'], 'agreement': wr['agreement'],
         'ms': wr['ms'], 'plain_ms': wr['plain_ms'],
         'bound_ms': wr['bound_ms'], 'bound_by': wr['bound_by'],
         'library_ms': None,
         'vocoder_case': wr['trainer_fold']['shape'],
         'vocoder_ms': wr['trainer_fold']['ms'],
         'vocoder_plain_ms': wr['trainer_fold']['plain_ms'],
         'vocoder_bound_ms': wr['trainer_fold']['bound_ms']})
    # #2 and #3 by path: the decoder's float32 forward is cooperative, its
    # bf16 forward and the postnet's float32 one take the cluster path
    dec = train_rows[0]       # decoder LSTM H=512, T=1024, B=32, float32
    post = next(r for r in train_rows if r['case'].startswith('postnet'))
    pitch = next(r for r in train_rows if r['case'].startswith('pitch'))

    def bf16_of(row):
        return next(r for r in bf16_rows
                    if r['case'].startswith(row['case'].split(' ')[0]))
    for name, row, sfx, line, path in (
            ('birnn_train_fwd (cooperative path)', dec, 'fwd', 294,
             'cooperative'),
            ('birnn_train_fwd (batch-split path)', pitch, 'fwd', 294,
             'batch_split'),
            ('birnn_train_fwd (cluster path)', post, 'fwd', 294, 'cluster'),
            ('birnn_train_bwd (cooperative path)', dec, 'bwd', 388,
             'cooperative'),
            ('birnn_train_bwd (batch-split path)', pitch, 'bwd', 388,
             'batch_split')):
        count = f'birnn_train_{sfx}_{path}'
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': 'forwardtacotron_tpu_torch/csrc/birnn_train.cu',
            'replaces': f'forwardtacotron_tpu/kernels/birnn.py:{line}',
            'launches': train_launches[count],
            'launches_teacher': teacher['train'][count],
            'launches_vocoder': voc_launches[count],
            'launches_options': opt_launches[count],
            'launches_options_bfloat16': opt_launches[f'{count}_bfloat16'],
            'launches_fast_pitch': fpl[count],
            'launches_gen_tacotron': gtl[count],
            'launches_multispeaker': msl[count],
            'launches_aligner': all_[count],
            'launches_fused': fus[count], 'launches_export': exl[count],
            'launches_native_io': nil[count],
            'launches_parallel': pal[count],
            'launches_logging_model_axis': axl[count],
            'case': row['case'],
            'max_abs_err': row[f'max_abs_err_{sfx}'],
            'ms': row[f'ms_{sfx}'], 'plain_ms': row[f'plain_ms_{sfx}'],
            'bound_ms': row[f'bound_ms_{sfx}'],
            'bound_by': row[f'bound_by_{sfx}'],
            'library_ms': row[f'library_ms_{sfx}']})
        if path == 'batch_split':
            b16 = bf16_of(row)
            kernels[-1].update({
                'bf16_case': b16['case'], 'bf16_ms': b16[f'ms_{sfx}'],
                'bf16_bound_ms': b16[f'bound_ms_{sfx}'],
                'bf16_library_ms': b16[f'library_ms_{sfx}']})
            continue
        # the decoder in bf16 and WaveRNN's GRU in float32: the planned
        # path's times, or the cooperative forward forced where the
        # cluster path is planned
        b16, key = bf16_of(dec), f'ms_{sfx}'
        coop = sfx == 'fwd' and path == 'cooperative'
        kernels[-1].update({
            'bf16_case': b16['case'],
            'bf16_ms': b16[f'{key}_cooperative' if coop else key],
            'bf16_bound_ms': b16[f'bound_ms_{sfx}'],
            'bf16_library_ms': b16[f'library_ms_{sfx}'],
            'vocoder_case': voc_train['case'],
            'vocoder_ms': voc_train[f'{key}_cooperative' if coop else key],
            'vocoder_plain_ms': voc_train[f'plain_ms_{sfx}'],
            'vocoder_bound_ms': voc_train[f'bound_ms_{sfx}'],
            'vocoder_library_ms': voc_train[f'library_ms_{sfx}']})
        if path == 'cluster':
            kernels[-1].update({
                'cooperative_ms': row['ms_fwd_cooperative'],
                'bf16_cooperative_ms': b16['ms_fwd_cooperative'],
                'vocoder_cooperative_ms': voc_train['ms_fwd_cooperative'],
                'max_abs_err_cooperative': row['max_abs_err_fwd_cooperative']})
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
