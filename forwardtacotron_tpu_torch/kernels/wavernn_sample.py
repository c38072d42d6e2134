"""WaveRNN autoregressive sampling as one persistent CUDA kernel.

Replaces the Pallas TPU kernel `forwardtacotron_tpu/kernels/
wavernn_sample.py:_kernel` (reached through `pallas_sample`). The kernel
is `csrc/wavernn_sample.cu`; `sample_plain` below is its plain version
with the same signature, used for tensors on the CPU.

What bounds it: every sample depends on the previous one through two
GRUs and three dense layers, so a fold of T samples is a chain of T
steps of six dependent small products (M = the number of fold lanes).
The least time is set by that chain, not by bytes or operations: per
step, the L2 traffic of the vectors every block stages, the grid
barriers, and the products' latency. The design keeps every loop weight
resident in shared memory (one cooperative launch for all steps; block j
owns U hidden units and the matching fc/logit columns), projects the
compact conditioning [mel | aux] (208 channels per step and lane) in the
kernel, runs the bf16 products on the tensor cores (`mma.sync`), publishes
the step's vectors to L2 only rounded to the compute type, stages them
into the blocks of a thread-block cluster with one multicast bulk copy
per row (L2 serves each row once per cluster), and folds the
sampling (Gumbel-max for RAW; mixture pick plus logistic inverse-CDF for
MOL) into the logits stage through one 64-bit `atomicMax` key per lane,
so a step has six grid barriers. Random numbers come from a counter-based
Philox generator keyed by (seed, step, lane, class). The seed is an int64
scalar in device memory that the kernel reads at its start, so a captured
CUDA graph draws new noise when its seed buffer changes. The source note
of `csrc/wavernn_sample.cu` gives the layout and why.

`sample` reaches the kernel through the custom op `ftt::wavernn_sample`
(`kernels/ops.py`), whose CPU implementation is `sample_plain`; plain
CUDA tensors call `launch` directly, without the op's dispatcher.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Union

import torch

from forwardtacotron_tpu_torch.ops.mol import (
    greedy_from_discretized_mix_logistic,
    sample_from_discretized_mix_logistic)
from forwardtacotron_tpu_torch.ops.rnn import gru_from_gates

MAX_LANES = 128        # fold lanes per launch; more are split into groups
MOL_CLASSES = 128      # MOL fc3 output padded to this width
KEY_SLOTS = 3          # ring of per-step sample keys (csrc kSlots)

# pointer order of ftt_wavernn_launch (csrc/wavernn_sample.cu `enum Ptr`)
WEIGHT_KEYS = ('w_ic', 'w_x', 'b_i', 'w1_ih', 'w1_hh', 'b1_ih', 'b1_hh',
               'w2_x', 'w2_a', 'w2_hh', 'b2_ih', 'b2_hh', 'fc1_x', 'fc1_a',
               'fc1_b', 'fc2_x', 'fc2_a', 'fc2_b', 'fc3', 'fc3_b')
MATRICES = ('w_ic', 'w1_ih', 'w1_hh', 'w2_x', 'w2_a', 'w2_hh', 'fc1_x',
            'fc1_a', 'fc2_x', 'fc2_a', 'fc3')

_M32 = 0xFFFFFFFF


# ----------------------------------------------------------- Philox 4x32-10

def _mulhilo(a: torch.Tensor, b: int):
    """High and low 32 bits of a * b for uint32 values held in int64."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & _M32


def philox4x32(c0, c1, c2, c3, seed: int):
    """Philox4x32-10 of counters (int64 tensors holding uint32 values)
    under the 64-bit key `seed`; the kernel computes the same words."""
    k0, k1 = seed & _M32, (seed >> 32) & _M32
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _M32
        k1 = (k1 + 0xBB67AE85) & _M32
    return c0, c1, c2, c3


def uniform(seed: int, step: int, n_lanes: int, n_slots: int, stream: int,
            device) -> torch.Tensor:
    """(n_lanes, n_slots) float32 uniforms in [0, 1) with 24 random bits:
    slot j of lane b at `step` is word j % 4 of Philox(counter (j // 4, b,
    step, stream), key seed)."""
    n4 = (n_slots + 3) // 4
    j4 = torch.arange(n4, device=device, dtype=torch.int64)[None, :]
    lane = torch.arange(n_lanes, device=device, dtype=torch.int64)[:, None]
    shape = (n_lanes, n4)
    words = philox4x32(j4.expand(shape), lane.expand(shape),
                       torch.full(shape, step, dtype=torch.int64,
                                  device=device),
                       torch.full(shape, stream, dtype=torch.int64,
                                  device=device),
                       seed & 0xFFFFFFFFFFFFFFFF)
    bits = torch.stack(words, dim=-1).reshape(n_lanes, 4 * n4)[:, :n_slots]
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


# ------------------------------------------------------------ weight layout

def pack_weights(model, compute_dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The sampler's weights from a WaveRNN module, in row (out x in)
    layout: matrices in `compute_dtype`, vectors float32, fc3 padded to
    128 outputs in MOL mode."""
    H, F = model.rnn_dims, model.fc_dims
    i_w = model.I.weight
    r1, r2 = model.rnn1, model.rnn2
    fc3_w, fc3_b = model.fc3.weight, model.fc3.bias
    if model.mode == 'MOL':
        pad = MOL_CLASSES - fc3_w.shape[0]
        fc3_w = torch.nn.functional.pad(fc3_w, (0, 0, 0, pad))
        fc3_b = torch.nn.functional.pad(fc3_b, (0, pad))
    w = {
        'w_ic': i_w[:, 1:], 'w_x': i_w[:, 0], 'b_i': model.I.bias,
        'w1_ih': r1.weight_ih_l0, 'w1_hh': r1.weight_hh_l0,
        'b1_ih': r1.bias_ih_l0, 'b1_hh': r1.bias_hh_l0,
        'w2_x': r2.weight_ih_l0[:, :H], 'w2_a': r2.weight_ih_l0[:, H:],
        'w2_hh': r2.weight_hh_l0, 'b2_ih': r2.bias_ih_l0,
        'b2_hh': r2.bias_hh_l0,
        'fc1_x': model.fc1.weight[:, :H], 'fc1_a': model.fc1.weight[:, H:],
        'fc1_b': model.fc1.bias,
        'fc2_x': model.fc2.weight[:, :F], 'fc2_a': model.fc2.weight[:, F:],
        'fc2_b': model.fc2.bias,
        'fc3': fc3_w, 'fc3_b': fc3_b,
    }
    return {k: v.detach().to(compute_dtype if k in MATRICES
                             else torch.float32).contiguous()
            for k, v in w.items()}


def compact_cond(mels_up: torch.Tensor, aux: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """(L, T, n_mels), (L, T, 4d) -> (T, L, n_mels + 4d) conditioning
    [mel | a1 | a2 | a3 | a4] in `compute_dtype`."""
    cond = torch.cat([mels_up, aux], dim=-1).transpose(0, 1)
    return cond.to(compute_dtype).contiguous()


def seed_tensor(seed: Union[int, torch.Tensor], device) -> torch.Tensor:
    """`seed` as the int64 scalar the kernel reads from device memory, on
    `device` (a tensor is moved and cast; an int is written by a fill on
    the device, which does not wait for the card as a copy from the host
    would)."""
    if isinstance(seed, torch.Tensor):
        return seed.to(device=device, dtype=torch.int64).reshape(())
    return torch.full((), int(seed), dtype=torch.int64, device=device)


# ----------------------------------------------------------- plain version

def sample_plain(cond: torch.Tensor, w: Dict[str, torch.Tensor],
                 seed: Union[int, torch.Tensor], nr_mix: int = 0,
                 greedy: bool = False,
                 compute_dtype: torch.dtype = torch.float32
                 ) -> torch.Tensor:
    """Plain version of the sampling kernel. cond (T, L, C) in
    `compute_dtype`; `w` from `pack_weights`; `seed` an int or an integer
    scalar tensor; nr_mix > 0 selects MOL. Activations are rounded to
    `compute_dtype` before each product, which accumulates in float32.
    Returns samples (T, L) float32 in [-1, 1]."""
    seed = int(seed)
    T, L, _ = cond.shape
    f = {k: v.float() for k, v in w.items()}
    H = f['w1_hh'].shape[1]
    d = f['w2_a'].shape[1]
    n_in = f['w_ic'].shape[1]
    n_classes = f['fc3'].shape[0]
    c = cond.float()

    def q(x):
        return x.to(compute_dtype).float()

    pre_i = c[..., :n_in] @ f['w_ic'].T                  # (T, L, H)
    pre_g2 = c[..., n_in:n_in + d] @ f['w2_a'].T
    pre_f1 = c[..., n_in + d:n_in + 2 * d] @ f['fc1_a'].T
    pre_f2 = c[..., n_in + 2 * d:n_in + 3 * d] @ f['fc2_a'].T
    x = c.new_zeros(L)
    h1 = c.new_zeros((L, H))
    h2 = c.new_zeros((L, H))
    out = []
    for t in range(T):
        xt = pre_i[t] + f['b_i'] + x[:, None] * f['w_x']
        h1 = gru_from_gates(q(xt) @ f['w1_ih'].T + f['b1_ih'],
                            q(h1) @ f['w1_hh'].T + f['b1_hh'], h1)
        x1 = xt + h1
        h2 = gru_from_gates(q(x1) @ f['w2_x'].T + pre_g2[t] + f['b2_ih'],
                            q(h2) @ f['w2_hh'].T + f['b2_hh'], h2)
        x2 = x1 + h2
        f1 = torch.relu(q(x2) @ f['fc1_x'].T + pre_f1[t] + f['fc1_b'])
        f2 = torch.relu(q(f1) @ f['fc2_x'].T + pre_f2[t] + f['fc2_b'])
        logits = q(f2) @ f['fc3'].T + f['fc3_b']
        if nr_mix:
            y = logits[:, :3 * nr_mix]
            if greedy:
                x = greedy_from_discretized_mix_logistic(y)
            else:
                x = sample_from_discretized_mix_logistic(
                    y, uniform(seed, t, L, nr_mix, 1, c.device),
                    uniform(seed, t, L, 1, 2, c.device)[:, 0])
        else:
            if not greedy:
                u = uniform(seed, t, L, n_classes, 0, c.device)
                logits = logits - torch.log(-torch.log(u + 1e-9) + 1e-9)
            cls = torch.argmax(logits, dim=-1)
            x = 2.0 * cls.float() / (n_classes - 1.0) - 1.0
        out.append(x)
    return torch.stack(out)


# ------------------------------------------------------------- the kernel

def _align16(n: int) -> int:
    return -(-n // 16) * 16


def scratch_bytes(lanes: int, hidden: int, fc: int, n_classes: int,
                  item: int) -> int:
    """Bytes of the kernel's zeroed global scratch (csrc `carve`): the
    sample keys (KEY_SLOTS, L) uint64, the logits (L, classes) float32,
    then xt, h1, x1, h2, x2 (L, H) and f1, f2 (L, F) in the compute type."""
    return (_align16(8 * KEY_SLOTS * lanes)
            + _align16(4 * lanes * n_classes)
            + item * lanes * (5 * hidden + 2 * fc))


def sample(cond: torch.Tensor, w: Dict[str, torch.Tensor],
           seed: Union[int, torch.Tensor], nr_mix: int = 0,
           greedy: bool = False,
           compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One launch of the sampler over L <= MAX_LANES lanes (contract of
    `sample_plain`), through the op `ftt::wavernn_sample`: CUDA tensors
    launch the kernel, CPU tensors take the plain version. `seed` is an
    int64 scalar tensor on cond's device (`seed_tensor`), or an int that
    is written there. A plain CUDA tensor, eager or under graph capture,
    launches directly: the op's dispatcher, which only torch.export's
    fake tensors need, is left out of the launch's host time."""
    seed = seed_tensor(seed, cond.device)
    if type(cond) is torch.Tensor and cond.is_cuda:
        return launch(cond, w, seed, nr_mix, greedy, compute_dtype)
    return torch.ops.ftt.wavernn_sample(
        cond, [w[k] for k in WEIGHT_KEYS], seed, nr_mix, greedy,
        compute_dtype)


sample.launches = 0


def launch(cond, w, seed, nr_mix, greedy, compute_dtype):
    """The kernel's launch on CUDA tensors (the CUDA implementation of
    `ftt::wavernn_sample`); `seed` an int64 scalar on cond's device."""
    from forwardtacotron_tpu_torch.kernels import _build
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'WaveRNN kernel: compute dtype {compute_dtype}')
    T, L, C = cond.shape
    dev = cond.device
    H = w['w1_hh'].shape[1]
    F = w['fc2_x'].shape[0]
    d = w['w2_a'].shape[1]
    feat = w['w_ic'].shape[1] - d
    n_classes = w['fc3'].shape[0]
    if C != feat + 4 * d or L > MAX_LANES:
        raise ValueError(f'WaveRNN kernel: cond {tuple(cond.shape)} does not '
                         f'match feat={feat}, aux={d} (at most {MAX_LANES} '
                         'lanes)')
    if cond.device.type != 'cuda':
        raise ValueError(f'WaveRNN kernel: unsupported device {cond.device}')
    tensors = [cond] + [w[k] for k in WEIGHT_KEYS] + [seed]
    for name, t in zip(('cond',) + WEIGHT_KEYS + ('seed',), tensors):
        dt = compute_dtype if name in MATRICES + ('cond',) else \
            torch.int64 if name == 'seed' else torch.float32
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f'WaveRNN kernel: {name} must be a contiguous '
                             f'{dt} tensor on {dev}, got {t.dtype} on '
                             f'{t.device}')
    out = torch.empty((T, L), dtype=torch.float32, device=dev)
    item = torch.empty((), dtype=compute_dtype).element_size()
    scratch = torch.zeros(scratch_bytes(L, H, F, n_classes, item),
                          dtype=torch.uint8, device=dev)
    if seed.numel() != 1:
        raise ValueError('WaveRNN kernel: the seed is one int64 value')
    ptrs = (ctypes.c_void_p * 24)(*[t.data_ptr() for t in tensors[:-1]],
                                  out.data_ptr(), scratch.data_ptr(),
                                  seed.data_ptr())
    ints = (ctypes.c_longlong * 9)(T, L, feat, d, H, F, n_classes, nr_mix,
                                   int(greedy))
    lib = _build.load('wavernn_sample')
    fn = lib.ftt_wavernn_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(int(compute_dtype == torch.bfloat16), ptrs, ints, stream)
    _build.check(lib, code, 'WaveRNN sampling kernel launch')
    sample.launches += 1
    return out


def sample_conditioned(model, mels_up: torch.Tensor, aux: torch.Tensor,
                       seed: Union[int, torch.Tensor] = 0,
                       greedy: bool = False,
                       compute_dtype: torch.dtype = torch.bfloat16,
                       w: Optional[Dict[str, torch.Tensor]] = None
                       ) -> torch.Tensor:
    """Samples (L, T) for fold lanes mels_up (L, T, n_mels) and aux
    (L, T, 4d). More than MAX_LANES lanes run as groups of MAX_LANES
    (each fold starts from zero state, so groups are independent); the
    group starting at lane g uses seed + g, formed on the device from the
    seed tensor (an int seed is written there first). `w` is
    `pack_weights(model, compute_dtype)`, packed here where not given."""
    if w is None:
        w = pack_weights(model, compute_dtype)
    seed = seed_tensor(seed, mels_up.device)
    nr_mix = model.n_classes // 3 if model.mode == 'MOL' else 0
    parts = []
    for g in range(0, mels_up.shape[0], MAX_LANES):
        cond = compact_cond(mels_up[g:g + MAX_LANES], aux[g:g + MAX_LANES],
                            compute_dtype)
        parts.append(sample(cond, w, seed + g, nr_mix, greedy,
                            compute_dtype).T)
    return torch.cat(parts, dim=0)
