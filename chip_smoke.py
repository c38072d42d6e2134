"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure makes the exit code nonzero, and the final line is
printed only when every phase passed):

1. device: CUDA must be available; prints the card's name and power
   limit from nvidia-smi;
2. build: compiles the CUDA kernels of `forwardtacotron_tpu_torch/csrc`
   with nvcc, all sources at once;
3. BiRNN kernel (#1) against its plain version on the card at the
   serving path's shapes (`SERVING_BIRNN_CASES`: decoder LSTM H=512 and
   postnet GRU H=256 at T=1024, prenet GRU H=256 and the 6-stream
   predictor GRU H=128 at T=160; B=1 and B=8; float32 at atol 1e-4,
   bfloat16 at atol 2e-2) on the path `inference_plan` names and, at
   B=1, on the cooperative path too, with both paths' timings beside the
   plain version's, cuDNN's and the bound; and at the five shapes that
   `evaluate()` gives it on the training path (`EVAL_BIRNN_CASES`, B=32:
   decoder LSTM H=512 T=896 ragged, CBHG GRUs H=256 at T=896 and T=176,
   predictor GRUs H=128/64 T=176; float32 at atol 1e-4; the decoder on
   both paths, timed);
4. WaveRNN sampling kernel against its plain version, greedy, in both
   compute types (class agreement > 95%; MOL within 1e-3 on > 95%): RAW
   at 64 lanes x 3850 steps, float32 at 128 lanes x 600 steps, bfloat16 at
   72 lanes x 3850 steps (the 920-frame utterance's fold), MOL at 16 lanes
   x 1650 steps; RAW and MOL sampled, same seed same samples, lane groups;
   timed in bfloat16 at 1, 8, 64 and 128 lanes x 3850 steps;
5. the main path at the full width of config.yaml with random weights:
   `gen_forward.main` on three lines of sentences.txt (text -> ids ->
   generate -> vocode -> int16 wav), with the kernels' launch counts
   reset just before and read just after, every launch of kernel #1 on
   the stream-local path, which its plan names for every batch-1 bf16
   shape of the serving path; per-stage CUDA-event times;
   one utterance decoded at 8 frames per phoneme; a float32 check of the
   decoder against the CPU plain path;
6. BiRNN training kernels (forward with stash, BPTT) against their plain
   versions at the training path's shapes (B=32: decoder LSTM H=512
   T=1024 ragged, postnet GRU H=256 T=1024, prenet GRU H=256 T=192,
   predictor GRUs H=128/64 T=192; float32 at atol 1e-4; bfloat16 at 2^-7
   of the largest plain value for the outputs stored in bfloat16 (stash,
   dgi, dgh), 2e-3 for y, and a relative L2 error of at most 2^-8), with
   each kernel's path (`train_forward_plan`, `train_backward_plan`),
   timings beside cuDNN's nn.LSTM/nn.GRU, and, where a batch-split path is
   planned, the cooperative path checked (backward) and timed on the same
   inputs;
7. the training path at full width: `ForwardTrainer.train` for 6 steps at
   batch 32 on a synthetic LJSpeech-like dataset, counts reset just
   before and read just after (kernels #2/#3), then one `evaluate()`
   (kernel #1, every launch stream-local); the three predictor BiGRUs of
   every step on the batch-split paths of #2 and #3, the other three
   recurrences on their cooperative paths; losses finite, every parameter
   moved, the checkpoint served by `gen_forward`; ms per step split into forward, backward and
   optimizer; float32 gradients on the card against the CPU plain path,
   the CPU replaying the card's ReLU and max-pool decisions;
8. a {"kernels": [...]} JSON line, the nvidia-smi line, and last
   {"ok": true, "device": {...}}.

Details go to chiprun_out/chip_smoke.json.
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
                log(f'   ({name}: {time.perf_counter() - t0:.1f} s)')
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
        for B in (1, 8):
            lens = [T - 100] if B == 1 else [T - 13 * i for i in range(B)]
            for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
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
    for what, cell, T, H, lens in EVAL_BIRNN_CASES:
        gi, w, b, ln = _birnn_inputs(cell, T, 32, 2, H, f32, seed=T + H,
                                     lens=lens)
        plan = kb.inference_plan(cell, 2, 32, H, f32, smem, n_sms)
        # the decoder on the cooperative path too, on the same inputs
        paths = [plan['path']]
        if what == 'decoder' and plan['path'] == 'stream_local':
            paths.append('cooperative')
        outs = {p: kb.recurrence(cell, gi, w, b, ln, f32, path=p)
                for p in paths}
        torch.cuda.synchronize()
        ref = birnn_recurrence(cell, gi, w, b, ln, f32)
        name = f'evaluate() {what}: {cell} T={T} H={H} S=2 B=32 float32'
        row = {'case': name, 'path': plan['path'],
               'cluster': plan.get('cluster'), 'waves': plan.get('waves'),
               'max_abs_err': {}, 'tol': 1e-4}
        for p, y in outs.items():
            err = float((y - ref).abs().max())
            check(err <= 1e-4 and bool(torch.isfinite(y).all()),
                  f'BiRNN {name} {p}: max|kernel-plain| {err:.3g} <= 0.0001')
            row['max_abs_err'][p] = err
        if what == 'decoder':
            for p in paths:
                row[f'ms_{p}'] = cuda_ms(lambda: kb.recurrence(
                    cell, gi, w, b, ln, f32, path=p), reps=3)
            row['plain_ms'] = cuda_ms(lambda: birnn_recurrence(
                cell, gi, w, b, ln, f32), reps=1, warmup=0)
            row['bound_ms'], row['bound_by'] = _birnn_bound(cell, gi, w, b,
                                                            ln, H)
            row['library_ms'] = _cudnn_ms(cell, T, H, 2, 32, f32)
            times = ', '.join(f'{p} {row[f"ms_{p}"]:.3f} ms' for p in paths)
            log(f'  {name}: {times} (planned {plan["path"]}, cluster '
                f'{plan.get("cluster")}, {plan.get("waves")} waves), plain '
                f'{row["plain_ms"]:.1f} ms, bound {row["bound_ms"]:.4f} ms '
                f'({row["bound_by"]}), library {row["library_ms"]:.3f} ms')
        rows.append(row)
    DETAILS['birnn'] = rows
    return rows


def _cudnn_ms(cell, T, H, S, B, dtype):
    """One cuDNN bidirectional nn.LSTM/nn.GRU call over (B, T, H) inputs
    (input projection included) as a yardstick; None for grouped
    streams, which no single library call computes."""
    if S != 2:
        return None
    mod = (torch.nn.LSTM if cell == 'lstm' else torch.nn.GRU)(
        H, H, batch_first=True, bidirectional=True).cuda().to(dtype)
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
    # RAW greedy float32 at 64 lanes x 3850 steps
    model, mels, aux = _wavernn_inputs('RAW', 64, 3850, seed=1)
    w32 = ws.pack_weights(model, f32)
    cond32 = ws.compact_cond(mels, aux, f32)
    k = ws.sample(cond32, w32, 0, 0, True, f32)
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
    a = ws.sample(condbf, wbf, 7, 0, False, bf16)
    b = ws.sample(condbf, wbf, 7, 0, False, bf16)
    c = ws.sample(condbf, wbf, 8, 0, False, bf16)
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
    gk = ws.sample(condbf, wbf, 0, 0, True, bf16)
    gp = ws.sample_plain(condbf, wbf, 0, 0, True, bf16)
    agree = float(((gk - gp).abs() < 1e-6).float().mean())
    check(agree > 0.95, f'RAW greedy bf16 64x3850: class agreement '
                        f'{agree:.4f} > 0.95')
    out['raw_greedy_bf16_agreement'] = agree
    out['raw_greedy_bf16_max_abs_err'] = float((gk - gp).abs().max())
    T, L, C = condbf.shape
    out['ms'] = cuda_ms(lambda: ws.sample(condbf, wbf, 7, 0, False, bf16),
                        reps=2)
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
    k = ws.sample(cond128, w32, 0, 0, True, f32)
    p = ws.sample_plain(cond128, w32, 0, 0, True, f32)
    agree = float(((k - p).abs() < 1e-6).float().mean())
    check(agree > 0.95, f'RAW greedy f32 128x600: class agreement '
                        f'{agree:.4f} > 0.95')
    out['raw_greedy_f32_128_agreement'] = agree
    cbf = ws.compact_cond(mels128, aux128, bf16)
    w128 = ws.pack_weights(model128, bf16)
    check(torch.equal(ws.sample(cbf, w128, 9, 0, False, bf16),
                      ws.sample(cbf, w128, 9, 0, False, bf16)),
          'RAW sampled bf16 128x600: same seed, same output')

    # 72 lanes x 3850 steps, the fold of the 920-frame utterance (a lane
    # tile and grid that no other case here takes): greedy bf16
    model72, mels72, aux72 = _wavernn_inputs('RAW', 72, 3850, seed=6)
    w72 = ws.pack_weights(model72, bf16)
    cond72 = ws.compact_cond(mels72, aux72, bf16)
    k = ws.sample(cond72, w72, 0, 0, True, bf16)
    p = ws.sample_plain(cond72, w72, 0, 0, True, bf16)
    agree = float(((k - p).abs() < 1e-6).float().mean())
    check(agree > 0.95, f'RAW greedy bf16 72x3850: class agreement '
                        f'{agree:.4f} > 0.95')
    out['raw_greedy_bf16_72_agreement'] = agree

    # bf16 RAW sampled at 1, 8, 64 and 128 lanes x 3850 steps (random
    # conditioning of the model's width)
    g = torch.Generator(device='cuda').manual_seed(5)
    out['lanes_ms'] = {}
    for lanes in (1, 8, 64, 128):
        cond_l = (torch.randn((3850, lanes, C), device='cuda', generator=g)
                  * 0.5).to(bf16)
        out['lanes_ms'][lanes] = cuda_ms(
            lambda: ws.sample(cond_l, wbf, 7, 0, False, bf16), reps=2)
    log(f'  RAW sampled bf16 x 3850 steps, ms by lanes: {out["lanes_ms"]}')

    # lane groups: 64 lanes as groups of 16 == one launch (greedy)
    one = ws.sample_conditioned(model, mels, aux, 0, True, bf16)
    saved = ws.MAX_LANES
    ws.MAX_LANES = 16
    try:
        grouped = ws.sample_conditioned(model, mels, aux, 0, True, bf16)
    finally:
        ws.MAX_LANES = saved
    check(torch.equal(one, grouped), 'lane groups of 16 == one launch')

    # MOL greedy float32 and MOL sampled
    model, mels, aux = _wavernn_inputs('MOL', 16, 1650, seed=2)
    w32 = ws.pack_weights(model, f32)
    cond32 = ws.compact_cond(mels, aux, f32)
    k = ws.sample(cond32, w32, 0, 10, True, f32)
    p = ws.sample_plain(cond32, w32, 0, 10, True, f32)
    agree = float(((k - p).abs() < 1e-3).float().mean())
    check(agree > 0.95, f'MOL greedy f32 16x1650: agreement {agree:.4f} '
                        '> 0.95 at |d| < 1e-3')
    out['mol_greedy_f32_agreement'] = agree
    condbf, wbf = ws.compact_cond(mels, aux, bf16), ws.pack_weights(model,
                                                                    bf16)
    k = ws.sample(condbf, wbf, 0, 10, True, bf16)
    p = ws.sample_plain(condbf, wbf, 0, 10, True, bf16)
    agree = float(((k - p).abs() < 1e-3).float().mean())
    check(agree > 0.95, f'MOL greedy bf16 16x1650: agreement {agree:.4f} '
                        '> 0.95 at |d| < 1e-3')
    out['mol_greedy_bf16_agreement'] = agree
    s = ws.sample(condbf, wbf, 3, 10, False, bf16)
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


def _train_inputs(cell, T, B, H, lens, seed):
    g = torch.Generator().manual_seed(seed)
    ng = 4 if cell == 'lstm' else 3
    bound = 1.0 / math.sqrt(H)
    gi = torch.randn((T, B, 2, ng * H), generator=g) * 0.5
    w = (torch.rand((2, ng * H, H), generator=g) * 2 - 1) * bound
    b = torch.zeros((2, ng * H)) if cell == 'lstm' else \
        (torch.rand((2, ng * H), generator=g) * 2 - 1) * bound
    dy = torch.randn((T, B, 2, H), generator=g)
    lengths = torch.tensor(lens, dtype=torch.int32)
    return [t.cuda().contiguous() for t in (gi, w, b, lengths, dy)]


def _cudnn_train_ms(cell, T, H, B):
    """cuDNN bidirectional nn.LSTM/nn.GRU over (B, T, H) inputs, forward
    with grad and backward timed apart (input projection included): a
    yardstick only, never called by the port."""
    mod = (torch.nn.LSTM if cell == 'lstm' else torch.nn.GRU)(
        H, H, batch_first=True, bidirectional=True).cuda()
    mod.flatten_parameters()
    x = torch.randn((B, T, H), device='cuda', requires_grad=True)
    fwd = cuda_ms(lambda: mod(x), reps=5)
    y = mod(x)[0]
    dy = torch.randn_like(y)
    bwd = cuda_ms(lambda: torch.autograd.grad(
        y, [x] + list(mod.parameters()), dy, retain_graph=True), reps=5)
    return fwd, bwd


@phase('BiRNN training kernels vs plain')
def train_kernel_cases():
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
    rows = []
    for name, cell, T, H, lens in TRAIN_KERNEL_CASES:
        gi, w, b, ln, dy = _train_inputs(cell, T, 32, H, lens, seed=H + T)
        row = {'case': f'{name} {cell} H={H} T={T} B=32', 'errors': {},
               'path': bt.train_forward_plan(
                   cell, 2, 32, H, f32, props.shared_memory_per_block_optin,
                   props.multi_processor_count)['path']}
        row['bwd_path'] = bt.train_backward_plan(
            cell, 2, 32, H, f32, props.shared_memory_per_block_optin,
            props.multi_processor_count)['path']
        for dtype in (f32, bf16):
            gi_d, w_d = gi.to(dtype), w.to(dtype)
            y, st = train_forward(cell, gi_d, w_d, b, ln, dtype)
            dgi, dgh = train_backward(cell, st, dy, w_d, ln, dtype)
            # (label, output, tensor); where the batch-split backward is
            # planned, the cooperative one forced on the same stash too
            outs = [(k, k, v) for k, v in (('y', y), ('stash', st),
                                           ('dgi', dgi), ('dgh', dgh))]
            if row['bwd_path'] != 'cooperative':
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
                key = f'{str(dtype)[6:]} {what}'
                if dtype == f32:
                    limit, l2_limit = 1e-4, math.inf
                else:
                    limit = bf16_rel[kind] * float(ref.float().abs().max())
                    l2_limit = 2.0 ** -8
                ok = err <= limit and rel_l2 <= l2_limit \
                    and bool(torch.isfinite(got).all())
                check(ok, f'{row["case"]} {key}: max|kernel-plain| '
                          f'{err:.3g} <= {limit:.3g}, relative L2 '
                          f'{rel_l2:.3g} <= {l2_limit:.3g}')
                row['errors'][key] = err
                row['errors'][f'{key} rel_l2'] = rel_l2
        for sfx, parts in (('fwd', ('y', 'stash')), ('bwd', ('dgi', 'dgh'))):
            row[f'max_abs_err_{sfx}'] = max(row['errors'][f'float32 {p}']
                                            for p in parts)
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
        active = 2 * sum(min(n, T) for n in lens)
        flops = 2.0 * active * ng * H * H
        small = (w.numel() + b.numel() + ln.numel()) * 4
        fwd_bytes = (gi.numel() + 32 * T * 2 * H * (1 + 5)) * 4 + small
        bwd_bytes = (st32.numel() + dy.numel()
                     + (1 if cell == 'lstm' else 2) * gi.numel()) * 4 + small
        row['bound_ms_fwd'], row['bound_by_fwd'] = bound_ms(fwd_bytes, flops,
                                                            f32)
        row['bound_ms_bwd'], row['bound_by_bwd'] = bound_ms(bwd_bytes, flops,
                                                            f32)
        row['library_ms_fwd'], row['library_ms_bwd'] = _cudnn_train_ms(
            cell, T, H, 32)
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
    return rows


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
        # per step: the three predictor BiGRUs on the batch-split path, the
        # prenet/decoder/postnet recurrences on the cooperative one
        check(launches['birnn_train_fwd_batch_split'] == 3 * step
              and launches['birnn_train_fwd_cooperative'] == 3 * step,
              f'kernel #2 paths in {step} steps: batch-split '
              f'{launches["birnn_train_fwd_batch_split"]} == {3 * step}, '
              f'cooperative {launches["birnn_train_fwd_cooperative"]} == '
              f'{3 * step}')
        check(launches['birnn_train_bwd_batch_split'] == 3 * step
              and launches['birnn_train_bwd_cooperative'] == 3 * step,
              f'kernel #3 paths in {step} steps: batch-split '
              f'{launches["birnn_train_bwd_batch_split"]} == {3 * step}, '
              f'cooperative {launches["birnn_train_bwd_cooperative"]} == '
              f'{3 * step}')
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

        timing = _step_timing(model, optimizer, trainer, val_set)
        grads = _grads_vs_cpu(model)
        DETAILS['training'] = {'launches': launches, 'wall_s': wall,
                               'val': val, 'step_ms': timing,
                               'grads_vs_cpu': grads}
        return launches
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)


def _step_timing(model, optimizer, trainer, val_set):
    """Steady-state ms per training step at batch 32 on one batch of the
    768-frame bucket, split by CUDA events into forward (with the loss),
    backward, and clip + Adam."""
    from forwardtacotron_tpu_torch.train import common as tc
    from forwardtacotron_tpu_torch.train.forward_trainer import (
        batch_to_device)
    cfg = trainer.train_cfg
    batch = next(b for b in val_set if b['mel'].shape[1] == 768)
    batch = batch_to_device(batch, 'cuda')
    model.train()
    rows = []
    for rep in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        optimizer.zero_grad(set_to_none=True)
        pred = model(batch)
        loss, _ = tc.forward_loss(pred, batch, batch['pitch'],
                                  batch['energy'], cfg)
        ev[1].record()
        loss.backward()
        ev[2].record()
        tc.clip_by_global_norm(model.parameters(), cfg['clip_grad_norm'])
        optimizer.step()
        ev[3].record()
        ev[3].synchronize()
        if rep >= 2:
            rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    fwd, bwd, opt = (float(np.median([r[i] for r in rows]))
                     for i in range(3))
    out = {'forward_ms': fwd, 'backward_ms': bwd, 'optimizer_ms': opt,
           'step_ms': fwd + bwd + opt, 'batch': list(batch['mel'].shape)}
    log(f'  step at batch 32, 768 frames: {out}')

    # one more step under the profiler: device time by kernel
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        optimizer.zero_grad(set_to_none=True)
        loss, _ = tc.forward_loss(model(batch), batch, batch['pitch'],
                                  batch['energy'], cfg)
        loss.backward()
        tc.clip_by_global_norm(model.parameters(), cfg['clip_grad_norm'])
        optimizer.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if str(e.device_type).endswith('CUDA')
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    out['profiled'] = {
        'wall_ms': wall_ms, 'device_busy_ms': busy,
        'idle_share': 1.0 - busy / wall_ms if kernels else 'not measured',
        'top': [{'kernel': k[:90], 'ms': t, 'count': c}
                for k, t, c in kernels[:15]]}
    log(f'  profiled step: wall {wall_ms:.1f} ms, device busy {busy:.1f} '
        f'ms; top kernels:')
    for row in out['profiled']['top'][:8]:
        log(f'    {row["ms"]:8.2f} ms  x{row["count"]:<4} {row["kernel"]}')
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
    """models/layers.py's `F` is `decisions` inside the block (nothing
    outside layers.py sees it)."""
    from forwardtacotron_tpu_torch.models import layers
    saved = layers.F
    layers.F = decisions
    try:
        yield decisions
    finally:
        layers.F = saved


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


def _card_cpu_grads(model, batch):
    """The card's gradients (kernels #2/#3), recording models/layers.py's
    decisions, against the CPU's (plain versions) with those decisions
    replayed and with its own: {'replay': errors, 'own': errors,
    'differ': decisions the CPU takes otherwise, 'decisions': their
    count}."""
    card = _Decisions()
    grads = _model_grads(model, batch, 'cuda', card)
    replayed = _Decisions(card.recorded)
    cpu_replay = _model_grads(model, batch, 'cpu', replayed)
    if replayed.calls != len(card.recorded):
        raise RuntimeError(f'the CPU pass took {replayed.calls} decisions '
                           f'of the {len(card.recorded)} recorded')
    cpu_own = _model_grads(model, batch, 'cpu')
    return {'replay': _worst_grad_errors(grads, cpu_replay),
            'own': _worst_grad_errors(grads, cpu_own),
            'differ': replayed.differ, 'decisions': replayed.total}


def _grads_vs_cpu(model):
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
    errors without the replay, which it does not hold to the limits."""
    out = _card_cpu_grads(model, _grads_batch())
    rep, own = out['replay'], out['own']
    check(rep['ok'],
          f'float32 gradients, card vs CPU plain (CPU replaying the card\'s '
          f'{out["decisions"]} ReLU/max-pool decisions; '
          f'{out["differ"]} differ on its own): worst relative L2 error '
          f'{rep["worst_rel_l2"]:.2e} ({rep["param_l2"]}) <= '
          f'{GRAD_L2_LIMIT:g}, worst max-element error '
          f'{rep["worst_rel_max"]:.2e} of the largest ({rep["param_max"]}) '
          f'<= {GRAD_MAX_LIMIT:g}')
    log(f'  without the replay: relative L2 {own["worst_rel_l2"]:.2e}, max '
        f'element {own["worst_rel_max"]:.2e} (not checked)')
    return out


# ------------------------------------------------------------------- main

def main() -> int:
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
    birnn_rows = birnn_cases() or []
    wr = wavernn_cases() or {}
    launches = main_path() or {}
    train_rows = train_kernel_cases() or []
    train_launches = training_path() or {}

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
    kernels = [
        {'name': 'birnn (stream-local path)', 'route': 'cuda',
         'source': 'forwardtacotron_tpu_torch/csrc/birnn.cu',
         'replaces': 'forwardtacotron_tpu/kernels/birnn.py:45',
         'launches': launches['birnn_stream_local'], 'case': serving['case'],
         'max_abs_err': serving['max_abs_err']['stream_local'],
         'ms': serving['ms_stream_local'], 'plain_ms': serving['plain_ms'],
         'bound_ms': serving['bound_ms'], 'bound_by': serving['bound_by'],
         'library_ms': serving['library_ms']}]
    kernels.append(
        {'name': 'wavernn_sample', 'route': 'cuda',
         'source': 'forwardtacotron_tpu_torch/csrc/wavernn_sample.cu',
         'replaces': 'forwardtacotron_tpu/kernels/wavernn_sample.py:64',
         'launches': launches['wavernn_sample'],
         'max_abs_err': wr['max_abs_err'], 'agreement': wr['agreement'],
         'ms': wr['ms'], 'plain_ms': wr['plain_ms'],
         'bound_ms': wr['bound_ms'], 'bound_by': wr['bound_by'],
         'library_ms': None})
    dec = train_rows[0]       # decoder LSTM H=512, T=1024, B=32, float32
    pitch = next(r for r in train_rows if r['case'].startswith('pitch'))
    for name, row, sfx, line, count in (
            ('birnn_train_fwd (cooperative path)', dec, 'fwd', 294,
             'birnn_train_fwd_cooperative'),
            ('birnn_train_fwd (batch-split path)', pitch, 'fwd', 294,
             'birnn_train_fwd_batch_split'),
            ('birnn_train_bwd (cooperative path)', dec, 'bwd', 388,
             'birnn_train_bwd_cooperative'),
            ('birnn_train_bwd (batch-split path)', pitch, 'bwd', 388,
             'birnn_train_bwd_batch_split')):
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': 'forwardtacotron_tpu_torch/csrc/birnn_train.cu',
            'replaces': f'forwardtacotron_tpu/kernels/birnn.py:{line}',
            'launches': train_launches[count],
            'max_abs_err': row[f'max_abs_err_{sfx}'],
            'ms': row[f'ms_{sfx}'], 'plain_ms': row[f'plain_ms_{sfx}'],
            'bound_ms': row[f'bound_ms_{sfx}'],
            'bound_by': row[f'bound_by_{sfx}'],
            'library_ms': row[f'library_ms_{sfx}']})
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
