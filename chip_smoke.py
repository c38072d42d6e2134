"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure makes the exit code nonzero, and the final line is
printed only when every phase passed):

1. device: CUDA must be available; prints the card's name and power
   limit from nvidia-smi;
2. build: compiles the CUDA kernels of `forwardtacotron_tpu_torch/csrc`
   with nvcc, all sources at once;
3. BiRNN kernel against its plain version on the card (LSTM H=512,
   grouped GRU G=3 H=128, GRU H=256; B=1 and B=8; float32 at atol 1e-4,
   bfloat16 at atol 2e-2), with timings;
4. WaveRNN sampling kernel against its plain version (RAW greedy float32
   at 64 lanes x 3850 steps, MOL greedy, RAW sampled, lane groups);
5. the main path at the full width of config.yaml with random weights:
   `gen_forward.main` on three lines of sentences.txt (text -> ids ->
   generate -> vocode -> int16 wav), with the kernels' launch counts
   reset just before and read just after; per-stage CUDA-event times;
   one utterance decoded at 8 frames per phoneme; a float32 check of the
   decoder against the CPU plain path;
6. a {"kernels": [...]} JSON line, the nvidia-smi line, and last
   {"ok": true, "device": {...}}.

Details go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import json
import math
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
    reports = _build.build(['birnn', 'wavernn_sample'])
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


@phase('BiRNN kernel vs plain')
def birnn_cases():
    from forwardtacotron_tpu_torch.kernels.birnn import recurrence
    from forwardtacotron_tpu_torch.ops.rnn import birnn_recurrence
    cases = [('lstm', 1024, 512, 2), ('gru', 160, 128, 6),
             ('gru', 1024, 256, 2)]
    rows = []
    for cell, T, H, S in cases:
        for B in (1, 8):
            lens = [T - 100] if B == 1 else [T - 13 * i for i in range(B)]
            for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
                gi, w, b, ln = _birnn_inputs(cell, T, B, S, H, dtype,
                                             seed=T + H + B, lens=lens)
                y = recurrence(cell, gi, w, b, ln, dtype)
                torch.cuda.synchronize()
                ref = birnn_recurrence(cell, gi, w, b, ln, dtype)
                err = float((y - ref).abs().max())
                name = (f'{cell} T={T} H={H} S={S} B={B} '
                        f'{str(dtype)[6:]}')
                check(err <= tol and bool(torch.isfinite(y).all()),
                      f'BiRNN {name}: max|kernel-plain| {err:.3g} <= {tol}')
                row = {'case': name, 'max_abs_err': err, 'tol': tol}
                if B == 1 and (dtype == torch.bfloat16 or cell == 'lstm'):
                    row['ms'] = cuda_ms(lambda: recurrence(
                        cell, gi, w, b, ln, dtype), reps=5)
                    row['plain_ms'] = cuda_ms(lambda: birnn_recurrence(
                        cell, gi, w, b, ln, dtype), reps=1, warmup=0)
                    ng = 4 if cell == 'lstm' else 3
                    active = sum(min(n, T) for n in lens) * S
                    item = gi.element_size()
                    n_bytes = (gi.numel() + w.numel()) * item \
                        + b.numel() * 4 + ln.numel() * 4 + T * B * S * H * 4
                    flops = 2.0 * active * ng * H * H
                    row['bound_ms'], row['bound_by'] = bound_ms(
                        n_bytes, flops, dtype)
                    row['library_ms'] = _cudnn_ms(cell, T, H, S, B, dtype)
                    log(f'  {name}: kernel {row["ms"]:.3f} ms, plain '
                        f'{row["plain_ms"]:.1f} ms, bound '
                        f'{row["bound_ms"]:.4f} ms ({row["bound_by"]}), '
                        f'library {row["library_ms"]}')
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
    gk = ws.sample(condbf, wbf, 0, 0, True, bf16)
    gp = ws.sample_plain(condbf, wbf, 0, 0, True, bf16)
    out['raw_greedy_bf16_agreement'] = float(
        ((gk - gp).abs() < 1e-6).float().mean())
    log(f'  RAW sampled bf16 kernel/plain agreement '
        f'{out["raw_sampled_bf16_agreement"]:.4f}, greedy bf16 '
        f'{out["raw_greedy_bf16_agreement"]:.4f}')
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
    out['max_abs_err'] = out['raw_greedy_f32_max_abs_err']

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
    s = ws.sample(ws.compact_cond(mels, aux, bf16),
                  ws.pack_weights(model, bf16), 3, 10, False, bf16)
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
    from forwardtacotron_tpu_torch.kernels.birnn import recurrence
    from forwardtacotron_tpu_torch.kernels.wavernn_sample import sample
    from forwardtacotron_tpu_torch.models.wavernn import vocode
    lines = [s for s in Path('sentences.txt').read_text().splitlines()
             if s.strip()][:3]

    recurrence.launches = 0
    sample.launches = 0
    t0 = time.perf_counter()
    paths = []
    for k, text in enumerate(lines):
        for path in gen_forward.main(['-i', text, '--seed', '0', 'wavernn']):
            paths.append(path.rename(
                path.with_name(f'smoke{k}_{path.name}')))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {'birnn': recurrence.launches,
                'wavernn_sample': sample.launches}
    log(f'  main path: 3 utterances in {wall:.2f} s (host clock, first call '
        f'included), launches {launches}')
    check(launches['birnn'] > 0 and launches['wavernn_sample'] > 0,
          f'main path launched every kernel: {launches}')
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

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / 'chip_smoke.json').write_text(json.dumps(
        {'nvidia_smi': smi, 'failures': FAILURES, **DETAILS}, indent=1,
        default=str))
    if FAILURES:
        log(f'\nFAILED ({len(FAILURES)}):')
        for f in FAILURES:
            log(f'  - {f.splitlines()[0]}')
        return 1

    main_case = next(r for r in birnn_rows
                     if r['case'] == 'lstm T=1024 H=512 S=2 B=1 bfloat16')
    kernels = [
        {'name': 'birnn', 'route': 'cuda',
         'source': 'forwardtacotron_tpu_torch/csrc/birnn.cu',
         'replaces': 'forwardtacotron_tpu/kernels/birnn.py:45',
         'launches': launches['birnn'],
         'max_abs_err': main_case['max_abs_err'],
         'ms': main_case['ms'], 'plain_ms': main_case['plain_ms'],
         'bound_ms': main_case['bound_ms'],
         'bound_by': main_case['bound_by'],
         'library_ms': main_case['library_ms']},
        {'name': 'wavernn_sample', 'route': 'cuda',
         'source': 'forwardtacotron_tpu_torch/csrc/wavernn_sample.cu',
         'replaces': 'forwardtacotron_tpu/kernels/wavernn_sample.py:64',
         'launches': launches['wavernn_sample'],
         'max_abs_err': wr['max_abs_err'],
         'ms': wr['ms'], 'plain_ms': wr['plain_ms'],
         'bound_ms': wr['bound_ms'], 'bound_by': wr['bound_by'],
         'library_ms': None},
    ]
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
