"""WaveRNN vocoder (fatchord version): training forward and inference.

Mirrors `forwardtacotron_tpu/models/wavernn.py`: the teacher-forced
forward of training (`WaveRNN.forward`), the upsampling network
(MelResNet + nearest-neighbour stretches with one shared time kernel per
scale), the fold/crossfade batching of one utterance (`vocode`) or of
many (`vocode_batch`, over `vocode_program`: the JAX package's
`build_vocode_program`, a device function of static fold geometry that the
fused server and the exported artifact also run) into fold lanes, and the
autoregressive sampler, which runs through the sampling kernel wrapper
(`kernels/wavernn_sample.py`). Parameter names are the reference's torch
`state_dict` keys.
"""
from __future__ import annotations

import copy
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from forwardtacotron_tpu_torch.dsp.audio import decode_mu_law
from forwardtacotron_tpu_torch.kernels.wavernn_sample import (
    compact_cond, pack_weights, sample_conditioned, sample_plain,
    seed_tensor)
from forwardtacotron_tpu_torch.models.layers import batch_norm
from forwardtacotron_tpu_torch.ops import rnn as rnn_ops

# fold length (samples) and crossfade overlap of batched generation: the
# sampling kernel's fold on the card, the reference's for the plain
# sampler (the JAX package's TARGET_TPU and TARGET_REFERENCE)
TARGET_KERNEL = 2750
TARGET_PLAIN = 11_000
OVERLAP = 550


class ResBlock(nn.Module):

    def __init__(self, dims: int) -> None:
        super().__init__()
        self.conv1 = nn.Conv1d(dims, dims, 1, bias=False)
        self.conv2 = nn.Conv1d(dims, dims, 1, bias=False)
        self.batch_norm1 = nn.BatchNorm1d(dims)
        self.batch_norm2 = nn.BatchNorm1d(dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # (B, C, T)
        h = F.relu(batch_norm(self.batch_norm1, self.conv1(x)))
        return batch_norm(self.batch_norm2, self.conv2(h)) + x


class MelResNet(nn.Module):

    def __init__(self, res_blocks: int, in_dims: int, compute_dims: int,
                 res_out_dims: int, pad: int) -> None:
        super().__init__()
        self.conv_in = nn.Conv1d(in_dims, compute_dims, 2 * pad + 1,
                                 bias=False)
        self.batch_norm = nn.BatchNorm1d(compute_dims)
        self.layers = nn.ModuleList([ResBlock(compute_dims)
                                     for _ in range(res_blocks)])
        self.conv_out = nn.Conv1d(compute_dims, res_out_dims, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # (B, C, T)
        h = F.relu(batch_norm(self.batch_norm, self.conv_in(x)))
        for layer in self.layers:
            h = layer(h)
        return self.conv_out(h)


class Stretch(nn.Module):
    """Nearest-neighbour upsampling in time by `scale` ((B, T, C))."""

    def __init__(self, scale: int) -> None:
        super().__init__()
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.repeat_interleave(x, self.scale, dim=1)


class SharedTimeConv(nn.Module):
    """One 1-D kernel of width 2*scale+1 applied along time to every
    channel (the reference's Conv2d(1, 1, (1, k)) over the (freq, time)
    image); weight shape (1, 1, 1, k)."""

    def __init__(self, scale: int) -> None:
        super().__init__()
        k = 2 * scale + 1
        self.pad = scale
        self.weight = nn.Parameter(torch.full((1, 1, 1, k), 1.0 / k))

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # (B, T, C)
        B, T, C = x.shape
        y = F.conv1d(x.transpose(1, 2).reshape(B * C, 1, T),
                     self.weight.reshape(1, 1, -1), padding=self.pad)
        return y.reshape(B, C, -1).transpose(1, 2)


class UpsampleNetwork(nn.Module):

    def __init__(self, feat_dims: int, upsample_scales: Sequence[int],
                 compute_dims: int, res_blocks: int, res_out_dims: int,
                 pad: int) -> None:
        super().__init__()
        self.total_scale = int(np.prod(upsample_scales))
        self.indent = pad * self.total_scale
        self.resnet = MelResNet(res_blocks, feat_dims, compute_dims,
                                res_out_dims, pad)
        layers = []
        for scale in upsample_scales:
            layers += [Stretch(scale), SharedTimeConv(scale)]
        self.up_layers = nn.ModuleList(layers)

    def forward(self, m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """m (B, T, n_mels) -> (mels_up, aux), both
        (B, (T - 2*pad) * prod(scales), C)."""
        aux = self.resnet(m.transpose(1, 2)).transpose(1, 2)
        aux = torch.repeat_interleave(aux, self.total_scale, dim=1)
        x = m
        for layer in self.up_layers:
            x = layer(x)
        return x[:, self.indent:-self.indent], aux


class GRUWeights(nn.Module):
    """The parameters of one nn.GRU layer, under nn.GRU's names."""

    def __init__(self, input_dim: int, hidden: int) -> None:
        super().__init__()
        bound = 1.0 / hidden ** 0.5
        for name, shape in (('weight_ih_l0', (3 * hidden, input_dim)),
                            ('weight_hh_l0', (3 * hidden, hidden)),
                            ('bias_ih_l0', (3 * hidden,)),
                            ('bias_hh_l0', (3 * hidden,))):
            self.register_parameter(
                name, nn.Parameter(torch.empty(shape).uniform_(-bound,
                                                               bound)))


class WaveRNN(nn.Module):

    def __init__(self, rnn_dims: int = 512, fc_dims: int = 512,
                 bits: int = 9, pad: int = 2,
                 upsample_factors: Sequence[int] = (4, 8, 8),
                 feat_dims: int = 80, compute_dims: int = 128,
                 res_out_dims: int = 128, res_blocks: int = 10,
                 hop_length: int = 256, sample_rate: int = 22050,
                 mode: str = 'RAW') -> None:
        super().__init__()
        if mode not in ('RAW', 'MOL'):
            raise ValueError(f'Unknown model mode: {mode}')
        self.mode = mode
        self.rnn_dims, self.fc_dims = rnn_dims, fc_dims
        self.bits, self.pad = bits, pad
        self.feat_dims = feat_dims
        self.hop_length, self.sample_rate = hop_length, sample_rate
        self.aux_dims = res_out_dims // 4
        self.n_classes = 2 ** bits if mode == 'RAW' else 30
        self.register_buffer('step', torch.zeros(1, dtype=torch.long))
        self.upsample = UpsampleNetwork(feat_dims, upsample_factors,
                                        compute_dims, res_blocks,
                                        res_out_dims, pad)
        self.I = nn.Linear(feat_dims + self.aux_dims + 1, rnn_dims)
        self.rnn1 = GRUWeights(rnn_dims, rnn_dims)
        self.rnn2 = GRUWeights(rnn_dims + self.aux_dims, rnn_dims)
        self.fc1 = nn.Linear(rnn_dims + self.aux_dims, fc_dims)
        self.fc2 = nn.Linear(fc_dims + self.aux_dims, fc_dims)
        self.fc3 = nn.Linear(fc_dims, self.n_classes)
        self.eval()

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> 'WaveRNN':
        model_config = dict(config['vocoder']['model'])
        return cls(bits=config['dsp']['bits'],
                   feat_dims=config['dsp']['num_mels'],
                   hop_length=config['dsp']['hop_length'],
                   sample_rate=config['dsp']['sample_rate'],
                   upsample_factors=tuple(
                       model_config.pop('upsample_factors')),
                   **model_config)

    def _gru(self, rnn: GRUWeights, x: torch.Tensor) -> torch.Tensor:
        return rnn_ops.gru({'w_ih': rnn.weight_ih_l0,
                            'w_hh': rnn.weight_hh_l0,
                            'b_ih': rnn.bias_ih_l0,
                            'b_hh': rnn.bias_hh_l0}, x)

    def forward(self, x: torch.Tensor, mels: torch.Tensor) -> torch.Tensor:
        """Teacher-forced forward (the JAX package's `WaveRNN.__call__`,
        the reference's fatchord_version.py:132-169): x (B, T_seq) the
        previous samples as floats, mels (B, T_win, n_mels) time-major ->
        logits (B, T_seq, n_classes). The model's mode (train or eval)
        decides the batch-norm statistics; both GRUs run as one stream
        of the BiRNN kernels (`ops/rnn.py:gru`)."""
        mels_up, aux = self.upsample(mels)
        d = self.aux_dims
        a1, a2, a3, a4 = (aux[..., i * d:(i + 1) * d] for i in range(4))
        h = self.I(torch.cat([x[..., None], mels_up, a1], dim=-1))
        h = self._gru(self.rnn1, h) + h
        h = self._gru(self.rnn2, torch.cat([h, a2], dim=-1)) + h
        h = F.relu(self.fc1(torch.cat([h, a3], dim=-1)))
        h = F.relu(self.fc2(torch.cat([h, a4], dim=-1)))
        return self.fc3(h)

    @torch.no_grad()
    def upsample_cond(self, mels: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Conditioning (mels_up, aux) of padded mels (B, T, n_mels)."""
        return self.upsample(mels)

    @torch.no_grad()
    def sample_scan(self, mels_up: torch.Tensor, aux: torch.Tensor,
                    seed: int = 0, greedy: bool = False,
                    compute_dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
        """The plain autoregressive sampler: samples (B, T) in [-1, 1] for
        conditioning (B, T, C), on whatever device the inputs lie."""
        nr_mix = self.n_classes // 3 if self.mode == 'MOL' else 0
        cond = compact_cond(mels_up, aux, compute_dtype)
        return sample_plain(cond, pack_weights(self, compute_dtype), seed,
                            nr_mix, greedy, compute_dtype).T


# ------------------------------------------------------- fold / unfold

def fold_indices(total_len: int, target: int, overlap: int
                 ) -> Tuple[np.ndarray, int]:
    """Gather indices (num_folds, target + 2*overlap) of
    fold_with_overlap, and the zero-padded length they index."""
    num_folds = (total_len - overlap) // (target + overlap)
    extended_len = num_folds * (overlap + target) + overlap
    remaining = total_len - extended_len
    padded_len = total_len
    if remaining != 0:
        num_folds += 1
        padded_len = total_len + (target + 2 * overlap - remaining)
    starts = np.arange(num_folds) * (target + overlap)
    idx = starts[:, None] + np.arange(target + 2 * overlap)[None, :]
    return idx, padded_len


def fold_with_overlap(x: torch.Tensor, target: int, overlap: int
                      ) -> torch.Tensor:
    """(1, T, C) -> (num_folds, target + 2*overlap, C): overlapping
    windows, the last one zero-padded."""
    idx, padded_len = fold_indices(x.shape[1], target, overlap)
    x = F.pad(x[0], (0, 0, 0, padded_len - x.shape[1]))
    return x[torch.as_tensor(idx, device=x.device)]


def _fades(overlap: int):
    silence_len = overlap // 2
    fade_len = overlap - silence_len
    t = np.linspace(-1, 1, fade_len, dtype=np.float64)
    fade_in = np.concatenate([np.zeros(silence_len),
                              np.sqrt(0.5 * (1 + t))])
    fade_out = np.concatenate([np.ones(silence_len),
                               np.sqrt(0.5 * (1 - t))])
    return fade_in, fade_out


def xfade_and_unfold(y: np.ndarray, overlap: int) -> np.ndarray:
    """(num_folds, target + 2*overlap) -> (total,) float64 with an
    equal-power crossfade over each overlap (host version)."""
    num_folds, length = y.shape
    target = length - 2 * overlap
    fade_in, fade_out = _fades(overlap)
    y = y.astype(np.float64).copy()
    y[:, :overlap] *= fade_in
    y[:, -overlap:] *= fade_out
    out = np.zeros(num_folds * (target + overlap) + overlap)
    for i in range(num_folds):
        start = i * (target + overlap)
        out[start:start + length] += y[i]
    return out


def xfade_unfold_device(y: torch.Tensor, overlap: int,
                        fades: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None
                        ) -> torch.Tensor:
    """Float32 crossfade overlap-add on the samples' device: lane i's
    tail overlaps lane i+1's head, so the unfold is a flatten of each
    lane's first target+overlap samples plus a shifted add of the tails.
    y (..., num_folds, length) -> (..., total); `fades` (fade_in,
    fade_out) on y's device, made from `_fades` where not given."""
    *lead, num_folds, length = y.shape
    target = length - 2 * overlap
    stride = target + overlap
    if fades is None:
        fades = tuple(torch.as_tensor(f, dtype=y.dtype, device=y.device)
                      for f in _fades(overlap))
    fade_in, fade_out = fades
    y = torch.cat([y[..., :overlap] * fade_in, y[..., overlap:-overlap],
                   y[..., -overlap:] * fade_out], dim=-1)
    main = F.pad(y[..., :stride].reshape(*lead, -1), (0, overlap))
    tails = F.pad(y[..., stride:], (0, target)).reshape(
        *lead, -1)[..., :-target]
    return main + F.pad(tails, (stride, 0))


# ------------------------------------------------------------- vocoding

def fold_target(target: Optional[int], device) -> int:
    """`target`, or where it is None the fold of the sampler that runs on
    `device`: TARGET_KERNEL for the kernel (CUDA), TARGET_PLAIN for the
    plain version (CPU)."""
    if target is not None:
        return int(target)
    return TARGET_KERNEL if torch.device(device).type == 'cuda' \
        else TARGET_PLAIN


def _time_major(model: 'WaveRNN', mel) -> np.ndarray:
    """A mel as float32 (T, n_mels), from (n_mels, T) or (T, n_mels)."""
    mel = np.asarray(mel, dtype=np.float32)
    if mel.shape[0] == model.feat_dims and mel.shape[-1] != model.feat_dims:
        mel = mel.T
    return mel


def _samples(model: WaveRNN, mel, batched: bool, target: int, overlap: int,
             seed: int, greedy: bool, compute_dtype: torch.dtype
             ) -> Tuple[torch.Tensor, int]:
    """Upsample, fold and sample: (lanes, L) samples and the wave length."""
    device = next(model.parameters()).device
    mel = torch.as_tensor(_time_major(model, mel), device=device)
    wave_len = (mel.shape[0] - 1) * model.hop_length
    m = F.pad(mel[None], (0, 0, model.pad, model.pad))
    mels_up, aux = model.upsample_cond(m)
    if batched:
        mels_up = fold_with_overlap(mels_up, target, overlap)
        aux = fold_with_overlap(aux, target, overlap)
    samples = sample_conditioned(model, mels_up, aux, seed=seed,
                                 greedy=greedy, compute_dtype=compute_dtype)
    return samples, wave_len


def _pcm16(wave: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(wave, -1.0, 1.0) * 32767.0).to(torch.int16)


def vocode(model: WaveRNN, mel, target: Optional[int] = None,
           overlap: int = OVERLAP, mu_law: bool = True, seed: int = 0,
           greedy: bool = False,
           compute_dtype: torch.dtype = torch.bfloat16,
           pcm16: bool = False) -> np.ndarray:
    """mel (n_mels, T) or (T, n_mels) -> waveform, on the model's device
    end to end (fold, sampling kernel, mu-law decode, crossfade, tail
    fade, int16 conversion); one host copy of the finished audio.
    `target=None` folds as `fold_target` says for the model's device."""
    target = fold_target(target, next(model.parameters()).device)
    samples, wave_len = _samples(model, mel, True, target, overlap, seed,
                                 greedy, compute_dtype)
    wave = samples
    if mu_law and model.mode == 'RAW':
        wave = decode_mu_law(wave, model.n_classes, False)
    wave = xfade_unfold_device(wave, overlap)[:wave_len]
    n_fade = min(20 * model.hop_length, wave_len)
    fade = torch.linspace(1.0, 0.0, n_fade, device=wave.device)
    wave = torch.cat([wave[:wave_len - n_fade],
                      wave[wave_len - n_fade:] * fade])
    if pcm16:
        wave = _pcm16(wave)
    return wave.cpu().numpy()


class VocodeProgram(nn.Module):
    """The device core of batched vocoding (the JAX package's
    `build_vocode_program`): mel (B, T, n_mels) float32, wave_lens (B,)
    and an int64 seed scalar -> (B, total) waveform, float32 or int16
    PCM. Upsampling, the fold (a gather of static geometry for T),
    sampling of all B x F lanes (`sample_conditioned`: groups of
    MAX_LANES, the group at lane g seeded seed + g on the device), the
    mu-law decode, the crossfade unfold and each row's trim and terminal
    fade run on the mel's device as masks of `wave_lens`; samples at and
    past a row's length are 0. The sampler's weights are packed once
    (buffers `w_<key>`) and the fades made once, so a call copies nothing
    from the host: a CUDA graph captures it and `torch.export` traces
    it."""

    def __init__(self, model: WaveRNN, target: int, overlap: int,
                 mu_law: bool, greedy: bool, pcm16: bool,
                 compute_dtype: torch.dtype) -> None:
        super().__init__()
        self.model = model
        self.target, self.overlap = int(target), int(overlap)
        self.mu_law = bool(mu_law) and model.mode == 'RAW'
        self.greedy, self.pcm16 = bool(greedy), bool(pcm16)
        self.compute_dtype = compute_dtype
        device = next(model.parameters()).device
        for k, v in pack_weights(model, compute_dtype).items():
            self.register_buffer(f'w_{k}', v)
        fade_in, fade_out = _fades(overlap)
        self.register_buffer('fade_in', torch.as_tensor(
            fade_in, dtype=torch.float32, device=device))
        self.register_buffer('fade_out', torch.as_tensor(
            fade_out, dtype=torch.float32, device=device))

    def packed(self) -> Dict[str, torch.Tensor]:
        return {k[2:]: v for k, v in self.named_buffers()
                if k.startswith('w_')}

    def forward(self, mel: torch.Tensor, wave_lens: torch.Tensor,
                seed: torch.Tensor) -> torch.Tensor:
        model, overlap = self.model, self.overlap
        B = mel.shape[0]
        m = F.pad(mel, (0, 0, model.pad, model.pad))
        mels_up, aux = model.upsample_cond(m)
        idx, padded_len = fold_indices(mels_up.shape[1], self.target,
                                       overlap)
        n_folds, length = idx.shape
        pad_t = padded_len - mels_up.shape[1]
        mels_up = F.pad(mels_up, (0, 0, 0, pad_t))
        aux = F.pad(aux, (0, 0, 0, pad_t))
        # the gather's indices from the static geometry, on the device
        idx = (torch.arange(n_folds, device=mel.device)
               * (self.target + overlap))[:, None] \
            + torch.arange(length, device=mel.device)[None, :]
        samples = sample_conditioned(
            model, mels_up[:, idx].reshape(B * n_folds, length, -1),
            aux[:, idx].reshape(B * n_folds, length, -1), seed=seed,
            greedy=self.greedy, compute_dtype=self.compute_dtype,
            w=self.packed())
        if self.mu_law:
            samples = decode_mu_law(samples, model.n_classes, False)
        wave = xfade_unfold_device(samples.reshape(B, n_folds, length),
                                   overlap, (self.fade_in, self.fade_out))
        # each row's trim and vocode's terminal fade (linspace(1, 0,
        # n_fade) over its last samples) as masks of its length
        pos = torch.arange(wave.shape[1], device=mel.device,
                           dtype=torch.float32)[None, :]
        wl = wave_lens.to(torch.float32)[:, None]
        n_fade = 20.0 * model.hop_length
        wave = wave * torch.clamp((wl - 1.0 - pos) / (n_fade - 1.0),
                                  0.0, 1.0) * (pos < wl)
        return _pcm16(wave) if self.pcm16 else wave


def vocode_program(model: WaveRNN, target: Optional[int] = None,
                   overlap: int = OVERLAP, mu_law: bool = True,
                   greedy: bool = False, pcm16: bool = False,
                   compute_dtype: torch.dtype = torch.bfloat16
                   ) -> VocodeProgram:
    """The `VocodeProgram` of `model` (JAX `build_vocode_program`);
    `target=None` folds as `fold_target` says for the model's device."""
    target = fold_target(target, next(model.parameters()).device)
    return VocodeProgram(model, target, overlap, mu_law, greedy, pcm16,
                         compute_dtype)


# the seed stride between the shards of `vocode_batch(mesh=)` (the JAX
# package's `seed + axis_index('data') * 7919`)
SHARD_SEED_STRIDE = 7919
_REPLICAS: 'weakref.WeakKeyDictionary' = weakref.WeakKeyDictionary()


def _on_device(model: WaveRNN, device: torch.device) -> WaveRNN:
    """`model` where it lies on `device`, else its copy there (made once
    a device and kept while the model lives)."""
    if next(model.parameters()).device == device:
        return model
    copies = _REPLICAS.setdefault(model, {})
    if device not in copies:
        copies[device] = copy.deepcopy(model).to(device)
    return copies[device]


def _launch_batch(model: WaveRNN, prepped: Sequence[np.ndarray],
                  target: Optional[int], overlap: int, mu_law: bool,
                  seed, greedy: bool, compute_dtype: torch.dtype,
                  pcm16: bool, frame_bucket: int):
    """One `vocode_program` call over time-major mels, padded to a common
    `frame_bucket` multiple, left running on the model's device: (the
    (B, total) waveform there, each row's length)."""
    device = next(model.parameters()).device
    n_frames = [m.shape[0] for m in prepped]
    t_pad = -(-max(n_frames) // frame_bucket) * frame_bucket
    batch = np.zeros((len(prepped), t_pad, model.feat_dims), np.float32)
    for i, m in enumerate(prepped):
        batch[i, :m.shape[0]] = m
    wave_lens = [(n - 1) * model.hop_length for n in n_frames]
    program = vocode_program(model, target, overlap, mu_law, greedy, pcm16,
                             compute_dtype)
    with torch.no_grad():
        wave = program(torch.as_tensor(batch, device=device),
                       torch.as_tensor(wave_lens, device=device),
                       seed_tensor(seed, device))
    return wave, wave_lens


def vocode_batch(model: WaveRNN, mels: Sequence, target: Optional[int] = None,
                 overlap: int = OVERLAP, mu_law: bool = True,
                 seed: Union[int, torch.Tensor] = 0, greedy: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 pcm16: bool = False, frame_bucket: int = 64, mesh=None
                 ) -> List[np.ndarray]:
    """Many utterances in one pass: the mels ((n_mels, T_i) or (T_i,
    n_mels)) are padded to a common `frame_bucket` multiple and run
    through one `vocode_program` call (one upsample, all B x F fold lanes
    sampled together, each row trimmed and faded on the device), copied
    to the host once and cut to each row's length. Greedy output equals
    per-utterance `vocode` calls (each lane starts from zero state);
    sampled output draws other noise streams.

    With `mesh` (`parallel.Mesh`), the utterances are sharded over its
    data axis as the JAX package's `vocode_batch(mesh=)` shards them:
    their count padded to a multiple of it with silent dummies ((2,
    n_mels) mels of -4.0, dropped from the result), shard i (contiguous
    rows) vocoded as one `vocode_batch` call of its own mels on the
    mesh's device i (the model copied there where it lies elsewhere) with
    seed + i * 7919, every shard launched before any is copied back.
    Greedy output equals the unsharded call."""
    prepped = [_time_major(model, m) for m in mels]
    devices = [next(model.parameters()).device] if mesh is None \
        else mesh.devices
    n_requested = len(prepped)
    while len(prepped) % len(devices):
        prepped.append(np.full((2, model.feat_dims), -4.0, np.float32))
    per = len(prepped) // len(devices)
    launched = [_launch_batch(_on_device(model, device),
                              prepped[i * per:(i + 1) * per], target,
                              overlap, mu_law, seed + i * SHARD_SEED_STRIDE,
                              greedy, compute_dtype, pcm16, frame_bucket)
                for i, device in enumerate(devices)]
    out = []
    for wave, wave_lens in launched:
        wave = wave.cpu().numpy()
        out += [wave[i, :n] for i, n in enumerate(wave_lens)]
    return out[:n_requested]


def generate_wav(model: WaveRNN, mel, batched: bool = True,
                 target: Optional[int] = None, overlap: int = OVERLAP,
                 mu_law: bool = True, seed: int = 0, greedy: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 pcm16: bool = False) -> np.ndarray:
    """Step-by-step generation: sampling on the model's device, then the
    mu-law decode, crossfade (float64) and fade-out on the host.
    `batched=False` samples the whole utterance as one lane;
    `target=None` folds as `fold_target` says for the model's device."""
    target = fold_target(target, next(model.parameters()).device)
    samples, wave_len = _samples(model, mel, batched, target, overlap, seed,
                                 greedy, compute_dtype)
    output = samples.cpu().numpy().astype(np.float64)
    if mu_law and model.mode == 'RAW':
        output = decode_mu_law(output, model.n_classes, False)
    output = xfade_and_unfold(output, overlap) if batched else output[0]
    output = output[:wave_len]
    n_fade = min(20 * model.hop_length, len(output))
    output[len(output) - n_fade:] *= np.linspace(1, 0, n_fade)
    if pcm16:
        output = (np.clip(output, -1.0, 1.0) * 32767.0).astype(np.int16)
    return output
