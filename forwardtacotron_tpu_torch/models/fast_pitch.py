"""FastPitch: a transformer-based non-autoregressive mel synthesizer.

Mirrors `forwardtacotron_tpu/models/fast_pitch.py` (the reference's
models/fast_pitch.py): FFT blocks (self-attention, two convolutions, two
layer norms) in the prenet, the postnet and the duration / pitch / energy
`SeriesPredictor`s, the pitch and energy projections and the length
regulator of ForwardTacotron. Layout is time-major (B, T, C). Parameter
and buffer names are the reference's `state_dict` keys (`self_attn.
in_proj_weight`, `self_attn.out_proj`, `conv1`, `conv2`, `norm1`, `norm2`,
`pos_encoder.scale`, `pos_encoder.pe` of shape (5000, 1, d_model), ...),
so a converted checkpoint loads with `strict=True`.

Conventions kept from the JAX model:

- A key-padding mask is True where a position is padded (the opposite of
  `ops/masking.pad_mask`). The teacher-forced `forward` takes it from the
  pad token (`x == 0`); `predict_series` and `generate_from_series` from
  `x_len` where it is given.
- Training runs the blocks unmasked (padded positions flow through the
  convolutions, as on the reference's padded batches); inference zeroes
  the padded positions before each convolution, so a padded bucket
  computes what an exact-length run computes.
- Attention is two products and a softmax over `-inf`-masked scores. A
  row whose keys are all masked comes out NaN, as in JAX; it is a padded
  row and feeds no valid one.
- Dropout (attention probabilities, both residuals, the positional
  dropout; the predictors' at their own rate) is drawn from the
  `generator` that `forward` is given in train mode. Inference draws
  nothing.
- Linear maps, convolutions and layer norms compute in the promoted type
  of their input and their parameters, as flax does: under the trainers'
  bf16 cast the float32 positional table makes the transformers compute
  in float32 with bf16-rounded weights, as the JAX model does. Inference
  is float32; there is no recurrence and no kernel behind the model.
- With `n_speakers` > 1 a speaker embedding, through a bias-free
  projection, is added to the token embeddings of the encoder
  (`speaker_proj`, d_model wide) and of each predictor (`spk_proj`);
  `n_speakers: 1` adds no parameter.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Union

import torch
from torch import nn
from torch.nn import functional as F

from forwardtacotron_tpu_torch.models.layers import dropout, speaker_emb
from forwardtacotron_tpu_torch.ops.length_regulator import length_regulate
from forwardtacotron_tpu_torch.text.symbols import phonemes

PADDING_VALUE = -11.5129
# a synthesis knob: a float, or a 0-d tensor on the model's device (a
# runtime input of an exported or captured program)
Knob = Union[float, torch.Tensor]


def positional_table(d_model: int, max_len: int = 5000) -> torch.Tensor:
    """The reference's PositionalEncoding buffer, (max_len, 1, d_model)."""
    pe = torch.zeros(max_len, d_model)
    position = torch.arange(0, max_len, dtype=torch.float).unsqueeze(1)
    div_term = torch.exp(torch.arange(0, d_model, 2).float()
                         * (-math.log(10000.0) / d_model))
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe.unsqueeze(0).transpose(0, 1)


def _promoted(x: torch.Tensor, *params: Optional[torch.Tensor]):
    dtype = x.dtype
    for p in params:
        if p is not None:
            dtype = torch.promote_types(dtype, p.dtype)
    return [None if t is None else t.to(dtype) for t in (x,) + params]


def _linear(x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor]) -> torch.Tensor:
    return F.linear(*_promoted(x, weight, bias))


def _conv(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """conv over x (B, T, C) with 'same' padding k // 2, cut to T frames."""
    x, w, b = _promoted(x, conv.weight, conv.bias)
    y = F.conv1d(x.transpose(1, 2), w, b, padding=conv.padding)
    return y[:, :, :x.shape[1]].transpose(1, 2)


def _norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    x, w, b = _promoted(x, norm.weight, norm.bias)
    return F.layer_norm(x, norm.normalized_shape, w, b, norm.eps)


def _zero_padded(x: torch.Tensor, key_padding_mask: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """x (B, T, C) with the padded positions (mask True) zeroed."""
    if key_padding_mask is None:
        return x
    return x.masked_fill(key_padding_mask[..., None], 0.0)


class MultiheadSelfAttention(nn.Module):
    """nn.MultiheadAttention's parameters (packed qkv `in_proj_*`,
    `out_proj`), computed as the JAX module writes it."""

    def __init__(self, d_model: int, n_heads: int, p: float = 0.1) -> None:
        super().__init__()
        self.n_heads = n_heads
        self.p = p
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.xavier_uniform_(self.out_proj.weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        B, T, D = x.shape
        H = self.n_heads
        qkv = _linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (t.reshape(B, T, H, D // H).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(D // H)
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                        float('-inf'))
        attn = dropout(torch.softmax(scores, dim=-1), self.p, generator)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, T, D)
        return _linear(out, self.out_proj.weight, self.out_proj.bias)


class FFTBlock(nn.Module):

    def __init__(self, d_model: int, n_heads: int, conv1_kernel: int,
                 conv2_kernel: int, d_fft: int, p: float = 0.1) -> None:
        super().__init__()
        self.p = p
        self.self_attn = MultiheadSelfAttention(d_model, n_heads, p)
        self.conv1 = nn.Conv1d(d_model, d_fft, conv1_kernel,
                               padding=conv1_kernel // 2)
        self.conv2 = nn.Conv1d(d_fft, d_model, conv2_kernel,
                               padding=conv2_kernel // 2)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                masked: bool = False) -> torch.Tensor:
        """`masked` zeroes the padded positions before each convolution
        (inference); without it they flow through (training)."""
        attn = self.self_attn(x, key_padding_mask, generator)
        x = _norm(x + dropout(attn, self.p, generator), self.norm1)
        mask = key_padding_mask if masked else None
        h = F.relu(_conv(_zero_padded(x, mask), self.conv1))
        h = _conv(_zero_padded(h, mask), self.conv2)
        return _norm(x + dropout(h, self.p, generator), self.norm2)


class PositionalEncoding(nn.Module):
    """x + scale * pe[:T], then dropout."""

    def __init__(self, d_model: int, p: float = 0.1,
                 max_len: int = 5000) -> None:
        super().__init__()
        self.p = p
        self.scale = nn.Parameter(torch.ones(1))
        self.register_buffer('pe', positional_table(d_model, max_len))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = x + self.scale * self.pe[:x.shape[1], 0]
        return dropout(x, self.p, generator)


class ForwardTransformer(nn.Module):

    def __init__(self, d_model: int, d_fft: int, layers: int, heads: int,
                 conv1_kernel: int, conv2_kernel: int,
                 p: float = 0.1) -> None:
        super().__init__()
        self.pos_encoder = PositionalEncoding(d_model, p)
        self.layers = nn.ModuleList([
            FFTBlock(d_model, heads, conv1_kernel, conv2_kernel, d_fft, p)
            for _ in range(layers)])
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                masked: bool = False) -> torch.Tensor:
        x = self.pos_encoder(x, generator)
        for layer in self.layers:
            x = layer(x, key_padding_mask, generator, masked)
        return _norm(x, self.norm)


class SeriesPredictor(nn.Module):
    """embedding -> ForwardTransformer -> Linear(1). With `speaker_dims`,
    a (B, E) speaker embedding projected by `spk_proj` (no bias) is added
    to the token embeddings."""

    def __init__(self, num_chars: int, d_model: int, n_heads: int,
                 d_fft: int, layers: int, conv1_kernel: int,
                 conv2_kernel: int, p: float = 0.1,
                 speaker_dims: Optional[int] = None) -> None:
        super().__init__()
        self.embedding = nn.Embedding(num_chars, d_model)
        if speaker_dims is not None:
            self.spk_proj = nn.Linear(speaker_dims, d_model, bias=False)
        self.transformer = ForwardTransformer(d_model, d_fft, layers,
                                              n_heads, conv1_kernel,
                                              conv2_kernel, p)
        self.lin = nn.Linear(d_model, 1)

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                alpha: Knob = 1.0,
                generator: Optional[torch.Generator] = None,
                masked: bool = False,
                spk: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.embedding(x)
        if spk is not None:
            h = h + _linear(spk, self.spk_proj.weight, None)[:, None, :]
        if masked:
            h = _zero_padded(h, key_padding_mask)
        h = self.transformer(h, key_padding_mask, generator, masked)
        return _linear(h, self.lin.weight, self.lin.bias)[..., 0] / alpha


def _key_padding(x: torch.Tensor, x_len: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """True where a token is padding: from x_len where given, else from
    the pad token 0."""
    if x_len is None:
        return x == 0
    return torch.arange(x.shape[1], device=x.device)[None, :] \
        >= x_len[:, None]


def _check_float32(compute_dtype: Optional[torch.dtype]) -> None:
    if compute_dtype not in (None, torch.float32):
        raise ValueError(f'FastPitch infers in float32 (no recurrence '
                         f'takes another type); got {compute_dtype}')


class FastPitch(nn.Module):

    # the entry points infer in this type whatever they ask of
    # ForwardTacotron's recurrences
    inference_dtype = torch.float32

    def __init__(self, num_chars: int = len(phonemes),
                 durpred_dropout: float = 0.5, durpred_d_model: int = 128,
                 durpred_n_heads: int = 2, durpred_layers: int = 4,
                 durpred_d_fft: int = 128,
                 pitch_dropout: float = 0.5, pitch_d_model: int = 128,
                 pitch_n_heads: int = 2, pitch_layers: int = 4,
                 pitch_d_fft: int = 128,
                 energy_dropout: float = 0.5, energy_d_model: int = 128,
                 energy_n_heads: int = 2, energy_layers: int = 4,
                 energy_d_fft: int = 128,
                 pitch_strength: float = 1.0, energy_strength: float = 1.0,
                 d_model: int = 256, conv1_kernel: int = 9,
                 conv2_kernel: int = 1,
                 prenet_layers: int = 4, prenet_heads: int = 2,
                 prenet_fft: int = 1024, prenet_dropout: float = 0.1,
                 postnet_layers: int = 4, postnet_heads: int = 2,
                 postnet_fft: int = 1024, postnet_dropout: float = 0.1,
                 n_mels: int = 80, n_speakers: int = 1,
                 speaker_embed_dims: int = 64) -> None:
        super().__init__()
        self.n_speakers = n_speakers
        spk_dims = speaker_embed_dims if n_speakers > 1 else None
        self.pitch_strength = pitch_strength
        self.energy_strength = energy_strength
        self.register_buffer('step', torch.zeros(1, dtype=torch.long))
        self.embedding = nn.Embedding(num_chars, d_model)

        def predictor(dm, heads, fft, layers, p):
            return SeriesPredictor(num_chars, dm, heads, fft, layers,
                                   conv1_kernel, conv2_kernel, p, spk_dims)
        self.dur_pred = predictor(durpred_d_model, durpred_n_heads,
                                  durpred_d_fft, durpred_layers,
                                  durpred_dropout)
        self.pitch_pred = predictor(pitch_d_model, pitch_n_heads,
                                    pitch_d_fft, pitch_layers, pitch_dropout)
        self.energy_pred = predictor(energy_d_model, energy_n_heads,
                                     energy_d_fft, energy_layers,
                                     energy_dropout)
        self.prenet = ForwardTransformer(d_model, prenet_fft, prenet_layers,
                                         prenet_heads, conv1_kernel,
                                         conv2_kernel, prenet_dropout)
        self.postnet = ForwardTransformer(d_model, postnet_fft,
                                          postnet_layers, postnet_heads,
                                          conv1_kernel, conv2_kernel,
                                          postnet_dropout)
        self.pitch_proj = nn.Conv1d(1, d_model, 3, padding=1)
        self.energy_proj = nn.Conv1d(1, d_model, 3, padding=1)
        self.lin = nn.Linear(d_model, n_mels)
        if n_speakers > 1:
            self.speaker_embedding = nn.Embedding(n_speakers,
                                                  speaker_embed_dims)
            self.speaker_proj = nn.Linear(speaker_embed_dims, d_model,
                                          bias=False)
        self.eval()

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> 'FastPitch':
        model_config = dict(config['fast_pitch']['model'])
        model_config['num_chars'] = len(phonemes)
        model_config['n_mels'] = config['dsp']['num_mels']
        return cls(**model_config)

    def _embed(self, x: torch.Tensor, spk: Optional[torch.Tensor]
               ) -> torch.Tensor:
        h = self.embedding(x)
        if spk is not None:
            h = h + _linear(spk, self.speaker_proj.weight, None)[:, None, :]
        return h

    def _series_proj(self, h, pitch, energy):
        for series, proj, strength in (
                (pitch, self.pitch_proj, self.pitch_strength),
                (energy, self.energy_proj, self.energy_strength)):
            h = h + _conv(series[..., None], proj) * strength
        return h

    # ------------------------------------------------ teacher-forced
    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward of training (JAX `__call__`). batch: x
        (B, Tx) int, mel (B, Tm, M), mel_len (B,), dur, pitch, energy
        (B, Tx). The text mask comes from the pad token, the postnet's
        from mel_len, and every block runs unmasked. Frames at or beyond
        the batch's largest mel_len hold PADDING_VALUE; `mel` and
        `mel_post` are the same tensor. Train mode draws its dropout from
        `generator` and needs one. A multi-speaker model reads the batch's
        `speaker` (B,) ids (0 where absent). Returns mel, mel_post, dur,
        pitch, energy."""
        if self.training and generator is None:
            raise ValueError('train mode draws dropout from a '
                             'torch.Generator: pass `generator`')
        gen = generator if self.training else None
        x, mel_len = batch['x'], batch['mel_len']
        max_t = batch['mel'].shape[1]
        pad = x == 0
        spk = speaker_emb(self, batch.get('speaker'), x.shape[0], x.device)
        out = {name: pred(x, pad, generator=gen, spk=spk) for name, pred in
               (('dur', self.dur_pred), ('pitch', self.pitch_pred),
                ('energy', self.energy_pred))}
        h = self.prenet(self._embed(x, spk), pad, gen)
        h = self._series_proj(h, batch['pitch'], batch['energy'])
        h, _ = length_regulate(h, batch['dur'], max_t)
        frames = torch.arange(max_t, device=x.device)
        h = self.postnet(h, frames[None, :] >= mel_len[:, None], gen)
        mel = _linear(h, self.lin.weight, self.lin.bias)
        mel = torch.where(frames[None, :, None] < mel_len.max(), mel,
                          torch.full_like(mel, PADDING_VALUE))
        out['mel'] = out['mel_post'] = mel
        return out

    # ------------------------------------------------------- inference
    @torch.no_grad()
    def predict_series(self, x: torch.Tensor, alpha: Knob = 1.0,
                       pitch_scale: Knob = 1.0, energy_scale: Knob = 1.0,
                       x_len: Optional[torch.Tensor] = None,
                       compute_dtype: Optional[torch.dtype] = torch.float32,
                       speaker: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
        """dur/pitch/energy series (B, T), every block masked. When the
        batch's summed (truncated) valid durations are <= 0, every
        duration becomes 2. `speaker` (B,) ids pick the voice of a
        multi-speaker model (0 where None)."""
        _check_float32(compute_dtype)
        pad = _key_padding(x, x_len)
        spk = speaker_emb(self, speaker, x.shape[0], x.device)
        dur = self.dur_pred(x, pad, alpha=alpha, masked=True, spk=spk)
        total = dur.masked_fill(pad, 0.0).to(torch.int32).sum()
        dur = torch.where(total <= 0, torch.full_like(dur, 2.0), dur)
        return {'dur': dur,
                'pitch': self.pitch_pred(x, pad, masked=True, spk=spk)
                * pitch_scale,
                'energy': self.energy_pred(x, pad, masked=True, spk=spk)
                * energy_scale}

    @torch.no_grad()
    def generate_from_series(self, x: torch.Tensor, dur: torch.Tensor,
                             pitch: torch.Tensor, energy: torch.Tensor,
                             max_t: int,
                             x_len: Optional[torch.Tensor] = None,
                             compute_dtype: Optional[torch.dtype] =
                             torch.float32,
                             speaker: Optional[torch.Tensor] = None
                             ) -> Dict[str, torch.Tensor]:
        """Encode, expand to a `max_t` bucket and decode, every block
        masked; `mel_len` (B,) is the true length of each mel."""
        _check_float32(compute_dtype)
        pad = _key_padding(x, x_len)
        spk = speaker_emb(self, speaker, x.shape[0], x.device)
        h = _zero_padded(self._embed(x, spk), pad)
        h = self.prenet(h, pad, masked=True)
        h = self._series_proj(h, pitch.masked_fill(pad, 0.0),
                              energy.masked_fill(pad, 0.0))
        h, mel_len = length_regulate(_zero_padded(h, pad),
                                     dur.masked_fill(pad, 0.0), max_t)
        frames = torch.arange(max_t, device=x.device)
        h = self.postnet(h, frames[None, :] >= mel_len[:, None],
                         masked=True)
        mel = _linear(h, self.lin.weight, self.lin.bias)
        return {'mel': mel, 'mel_post': mel, 'pitch': pitch,
                'energy': energy, 'mel_len': mel_len}

    @torch.no_grad()
    def generate(self, x: torch.Tensor, max_t: int, alpha: Knob = 1.0,
                 pitch_scale: Knob = 1.0, energy_scale: Knob = 1.0,
                 x_len: Optional[torch.Tensor] = None,
                 compute_dtype: Optional[torch.dtype] = torch.float32,
                 speaker: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
        """Series, then decode to a `max_t` bucket. The knobs are floats
        or 0-d tensors, so that one exported program takes them as
        runtime inputs (`utils/export.py`)."""
        series = self.predict_series(x, alpha, pitch_scale, energy_scale,
                                     x_len, compute_dtype, speaker)
        out = self.generate_from_series(x, series['dur'], series['pitch'],
                                        series['energy'], max_t, x_len,
                                        compute_dtype, speaker)
        out['dur'] = series['dur']
        return out
