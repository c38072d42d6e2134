"""ForwardTacotron: series predictors, CBHG encoder, length regulator,
BiLSTM decoder and CBHG postnet.

Mirrors `forwardtacotron_tpu/models/forward_tacotron.py` (the reference
attribute names: embedding, prenet, dur_pred, pitch_pred, energy_pred,
pitch_proj, energy_proj, lstm, lin, postnet, post_proj). Inference runs
on padded buckets with every stage masked at the true lengths, so a
bucket computes the values of an exact-length run. Every bidirectional
recurrence (the fused 6-stream predictor GRU, both CBHG GRUs and the
decoder LSTM) goes through the BiRNN kernel wrapper; `compute_dtype`
selects its precision (bfloat16 weights and inputs with float32
accumulation, or float32).

With `n_speakers` > 1 (the JAX package's multi-speaker extension) a
speaker embedding conditions the predictors (each its own bias-free
`spk_proj`, added to the token embeddings; the fused path adds the three
concatenated in the stacked layout) and the encoder (`speaker_proj`,
added after the pitch and energy projections); `n_speakers: 1` adds no
parameter.

`forward(batch)` is the teacher-forced forward of training (the JAX
package's `__call__`), in train or eval mode by `self.training`. Under
autograd its recurrences run the training kernels #2/#3; evaluation under
`torch.no_grad()` runs the inference kernel #1.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
from torch import nn
from torch.nn import functional as F

from forwardtacotron_tpu_torch.models.layers import (BatchNormConv, BiRNN,
                                                     CBHG, speaker_emb)
from forwardtacotron_tpu_torch.ops.length_regulator import length_regulate
from forwardtacotron_tpu_torch.ops.masking import pad_mask, time_mask
from forwardtacotron_tpu_torch.ops.rnn import grouped_birnn, pad_gru_gates
from forwardtacotron_tpu_torch.text.symbols import phonemes

PADDING_VALUE = -11.5129
# a synthesis knob: a float, or a 0-d tensor on the model's device (a
# runtime input of an exported or captured program)
Knob = Union[float, torch.Tensor]


class SeriesPredictor(nn.Module):
    """embed -> [conv5-relu-BN-dropout]x3 -> BiGRU -> Linear(1). With
    `speaker_dims`, a (B, E) speaker embedding projected by `spk_proj`
    (no bias) is added to the token embeddings."""

    def __init__(self, num_chars: int, emb_dim: int, conv_dims: int,
                 rnn_dims: int, dropout: float,
                 speaker_dims: Optional[int] = None) -> None:
        super().__init__()
        self.dropout = nn.Dropout(dropout)
        self.embedding = nn.Embedding(num_chars, emb_dim)
        if speaker_dims is not None:
            self.spk_proj = nn.Linear(speaker_dims, emb_dim, bias=False)
        self.convs = nn.ModuleList([
            BatchNormConv(emb_dim if i == 0 else conv_dims, conv_dims, 5)
            for i in range(3)])
        self.rnn = BiRNN('gru', conv_dims, rnn_dims)
        self.lin = nn.Linear(2 * rnn_dims, 1)

    def forward(self, x: torch.Tensor, alpha: Knob = 1.0,
                lengths: Optional[torch.Tensor] = None,
                compute_dtype: Optional[torch.dtype] = torch.float32,
                spk: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.embedding(x)
        if spk is not None:
            h = h + self.spk_proj(spk)[:, None, :]
        h = time_mask(h, lengths)
        for conv in self.convs:
            h = time_mask(self.dropout(conv(h)), lengths)
        h = self.rnn(h, lengths=lengths, compute_dtype=compute_dtype)
        return self.lin(h)[..., 0] / alpha


class ForwardTacotron(nn.Module):

    def __init__(self, embed_dims: int = 256, series_embed_dims: int = 64,
                 num_chars: int = len(phonemes),
                 durpred_conv_dims: int = 256, durpred_rnn_dims: int = 64,
                 durpred_dropout: float = 0.5,
                 pitch_conv_dims: int = 256, pitch_rnn_dims: int = 128,
                 pitch_dropout: float = 0.5, pitch_strength: float = 1.0,
                 energy_conv_dims: int = 256, energy_rnn_dims: int = 64,
                 energy_dropout: float = 0.5, energy_strength: float = 1.0,
                 rnn_dims: int = 512, prenet_dims: int = 256,
                 prenet_k: int = 16, postnet_num_highways: int = 4,
                 prenet_dropout: float = 0.5, postnet_dims: int = 256,
                 postnet_k: int = 8, prenet_num_highways: int = 4,
                 postnet_dropout: float = 0.0, n_mels: int = 80,
                 n_speakers: int = 1, speaker_embed_dims: int = 64) -> None:
        super().__init__()
        self.n_speakers = n_speakers
        spk_dims = speaker_embed_dims if n_speakers > 1 else None
        self.pitch_strength = pitch_strength
        self.energy_strength = energy_strength
        self.rnn_dims_series = (durpred_rnn_dims, pitch_rnn_dims,
                                energy_rnn_dims)
        self.register_buffer('step', torch.zeros(1, dtype=torch.long))
        self.embedding = nn.Embedding(num_chars, embed_dims)
        self.prenet = CBHG(K=prenet_k, in_channels=embed_dims,
                           channels=prenet_dims,
                           proj_channels=[prenet_dims, embed_dims],
                           num_highways=prenet_num_highways,
                           dropout=prenet_dropout)
        self.dur_pred = SeriesPredictor(num_chars, series_embed_dims,
                                        durpred_conv_dims, durpred_rnn_dims,
                                        durpred_dropout, spk_dims)
        self.pitch_pred = SeriesPredictor(num_chars, series_embed_dims,
                                          pitch_conv_dims, pitch_rnn_dims,
                                          pitch_dropout, spk_dims)
        self.energy_pred = SeriesPredictor(num_chars, series_embed_dims,
                                           energy_conv_dims, energy_rnn_dims,
                                           energy_dropout, spk_dims)
        self.pitch_proj = nn.Conv1d(1, 2 * prenet_dims, 3, padding=1)
        self.energy_proj = nn.Conv1d(1, 2 * prenet_dims, 3, padding=1)
        self.lstm = BiRNN('lstm', 2 * prenet_dims, rnn_dims)
        self.lin = nn.Linear(2 * rnn_dims, n_mels)
        self.postnet = CBHG(K=postnet_k, in_channels=n_mels,
                            channels=postnet_dims,
                            proj_channels=[postnet_dims, n_mels],
                            num_highways=postnet_num_highways,
                            dropout=postnet_dropout)
        self.post_proj = nn.Linear(2 * postnet_dims, n_mels, bias=False)
        if n_speakers > 1:
            self.speaker_embedding = nn.Embedding(n_speakers,
                                                  speaker_embed_dims)
            self.speaker_proj = nn.Linear(speaker_embed_dims,
                                          2 * prenet_dims, bias=False)
        self.eval()

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> 'ForwardTacotron':
        model_config = dict(config['forward_tacotron']['model'])
        model_config['num_chars'] = len(phonemes)
        model_config['n_mels'] = config['dsp']['num_mels']
        return cls(**model_config)

    # ------------------------------------------------ teacher-forced
    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward of training (JAX `__call__`). batch: x
        (B, Tx) int, mel (B, Tm, M), mel_len (B,), dur, pitch, energy
        (B, Tx). The predictors and the encoder run unmasked over the
        padded batch, the encoding is expanded by the ground-truth
        durations to Tm frames, the decoder BiLSTM is cut at mel_len and
        the postnet runs over the padded mel, as the reference does on
        padded batches. Every recurrence computes in the dtype of its
        input (`ops/rnn.py:follow_dtype`): float32, or bfloat16 when the
        parameters and the batch are cast to it (`train/common.py`'s
        mixed precision), and the predictions come back in that dtype.
        `generator`, the trainers' step generator that every TTS model is
        handed, draws nothing here: the dropouts are `nn.Dropout`, on the
        global RNG. A multi-speaker model reads the batch's `speaker` (B,)
        ids (0 where absent). Returns mel, mel_post, dur, pitch, energy."""
        del generator
        x, mel_len = batch['x'], batch['mel_len']
        spk = speaker_emb(self, batch.get('speaker'), x.shape[0], x.device)
        out = {name: pred(x, compute_dtype=None, spk=spk) for name, pred in
               (('dur', self.dur_pred), ('pitch', self.pitch_pred),
                ('energy', self.energy_pred))}
        h = self._encode(x, batch['pitch'], batch['energy'], None, None,
                         spk)
        h, _ = length_regulate(h, batch['dur'], batch['mel'].shape[1])
        y = self.lstm(h, lengths=mel_len, pad_value=PADDING_VALUE,
                      compute_dtype=None)
        out['mel'] = self.lin(y)
        out['mel_post'] = self.post_proj(self.postnet(out['mel'],
                                                      compute_dtype=None))
        return out

    # ---------------------------------------------------------- series
    def _series_fusable(self) -> bool:
        dims = [p.convs[0].conv.out_channels for p in self._preds()]
        return len(set(dims)) == 1

    def _preds(self):
        return [self.dur_pred, self.pitch_pred, self.energy_pred]

    @torch.no_grad()
    def predict_series(self, x: torch.Tensor, alpha: Knob = 1.0,
                       pitch_scale: Knob = 1.0, energy_scale: Knob = 1.0,
                       x_len: Optional[torch.Tensor] = None,
                       compute_dtype: torch.dtype = torch.bfloat16,
                       speaker: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
        """dur/pitch/energy series (B, T). The three predictors run as one
        6-stream grouped BiGRU when their conv widths agree. `speaker`
        (B,) ids pick the voice of a multi-speaker model (0 where None)."""
        if self._series_fusable():
            return self.predict_series_fused(x, alpha, pitch_scale,
                                             energy_scale, x_len,
                                             compute_dtype, speaker)
        kw = dict(lengths=x_len, compute_dtype=compute_dtype,
                  spk=speaker_emb(self, speaker, x.shape[0], x.device))
        dur = self._dur_floor(x, self.dur_pred(x, alpha=alpha, **kw), x_len)
        return {'dur': dur,
                'pitch': self.pitch_pred(x, **kw) * pitch_scale,
                'energy': self.energy_pred(x, **kw) * energy_scale}

    @staticmethod
    def _dur_floor(x: torch.Tensor, dur_hat: torch.Tensor,
                   x_len: Optional[torch.Tensor]) -> torch.Tensor:
        """All durations become 2 when the batch's total is <= 0."""
        dur_valid = dur_hat
        if x_len is not None:
            dur_valid = torch.where(pad_mask(x_len, x.shape[1]), dur_hat,
                                    torch.zeros_like(dur_hat))
        total = dur_valid.to(torch.int32).sum()
        return torch.where(total <= 0, torch.full_like(dur_hat, 2.0), dur_hat)

    @torch.no_grad()
    def predict_series_fused(self, x: torch.Tensor, alpha: Knob = 1.0,
                             pitch_scale: Knob = 1.0,
                             energy_scale: Knob = 1.0,
                             x_len: Optional[torch.Tensor] = None,
                             compute_dtype: torch.dtype = torch.bfloat16,
                             speaker: Optional[torch.Tensor] = None
                             ) -> Dict[str, torch.Tensor]:
        """Stacked embedding gather, grouped convolutions and one
        6-stream BiGRU (3 predictors x 2 directions, gate blocks
        zero-padded to the widest H), then a per-group linear head. A
        speaker's three `spk_proj`s are concatenated in the stacked
        embedding's layout and added before the convolutions."""
        preds = self._preds()
        G = len(preds)
        B, T = x.shape
        h_groups = self.rnn_dims_series
        H = max(h_groups)
        table = torch.cat([p.embedding.weight for p in preds], dim=-1)
        h = table[x]
        spk = speaker_emb(self, speaker, x.shape[0], x.device)
        if spk is not None:
            h = h + torch.cat([p.spk_proj(spk) for p in preds],
                              dim=-1)[:, None, :]
        h = time_mask(h, x_len)
        for i in range(3):
            convs = [p.convs[i] for p in preds]
            weight = torch.cat([c.conv.weight for c in convs], dim=0)
            h = F.relu(F.conv1d(h.transpose(1, 2), weight, padding=2,
                                groups=G)).transpose(1, 2)
            bn = [c.bnorm for c in convs]
            mean = torch.cat([b.running_mean for b in bn])
            var = torch.cat([b.running_var for b in bn])
            scale = torch.cat([b.weight for b in bn])
            bias = torch.cat([b.bias for b in bn])
            h = (h - mean) * torch.rsqrt(var + 1e-5) * scale + bias
            h = time_mask(h, x_len)
        h = h.reshape(B, T, G, -1)

        def stack(reverse, key, pad_cols):
            ws = []
            for p, hg in zip(preds, h_groups):
                w = pad_gru_gates(p.rnn.direction(reverse)[key], hg, H)
                if pad_cols and hg != H:
                    w = F.pad(w, (0, H - hg))
                ws.append(w)
            return torch.stack(ws)

        def both(key, pad_cols=False):
            return torch.stack([stack(False, key, pad_cols),
                                stack(True, key, pad_cols)])

        y = grouped_birnn('gru', both('w_ih'), both('w_hh', True),
                          both('b_ih'), both('b_hh'), h, lengths=x_len,
                          compute_dtype=compute_dtype)    # (B, T, G, 2, H)
        w_out = []
        for p, hg in zip(preds, h_groups):
            k = p.lin.weight[0]
            w_out.append(torch.stack([F.pad(k[:hg], (0, H - hg)),
                                      F.pad(k[hg:], (0, H - hg))]))
        b_out = torch.cat([p.lin.bias for p in preds])
        out = torch.einsum('btgch,gch->btg', y, torch.stack(w_out)) + b_out
        dur = self._dur_floor(x, out[..., 0] / alpha, x_len)
        return {'dur': dur, 'pitch': out[..., 1] * pitch_scale,
                'energy': out[..., 2] * energy_scale}

    # ---------------------------------------------------------- decode
    def _encode(self, x, pitch, energy, lengths, compute_dtype, spk=None):
        h = time_mask(self.embedding(x), lengths)
        h = self.prenet(h, lengths=lengths, compute_dtype=compute_dtype)
        for series, proj, strength in (
                (pitch, self.pitch_proj, self.pitch_strength),
                (energy, self.energy_proj, self.energy_strength)):
            s = time_mask(series[..., None], lengths)
            h = h + proj(s.transpose(1, 2)).transpose(1, 2) * strength
        if spk is not None:
            h = h + self.speaker_proj(spk)[:, None, :]
        return h

    def _decode(self, h, mel_lens, compute_dtype):
        y = self.lstm(h, lengths=mel_lens, pad_value=PADDING_VALUE,
                      compute_dtype=compute_dtype)
        mel = self.lin(y)
        post = self.postnet(time_mask(mel, mel_lens), lengths=mel_lens,
                            compute_dtype=compute_dtype)
        return {'mel': mel, 'mel_post': self.post_proj(post)}

    @torch.no_grad()
    def generate_from_series(self, x: torch.Tensor, dur: torch.Tensor,
                             pitch: torch.Tensor, energy: torch.Tensor,
                             max_t: int,
                             x_len: Optional[torch.Tensor] = None,
                             compute_dtype: torch.dtype = torch.bfloat16,
                             speaker: Optional[torch.Tensor] = None
                             ) -> Dict[str, torch.Tensor]:
        """Encode, expand to a `max_t` bucket and decode; `mel_len` (B,)
        is the true length of each mel."""
        h = self._encode(x, pitch, energy, x_len, compute_dtype,
                         speaker_emb(self, speaker, x.shape[0], x.device))
        if x_len is not None:
            dur = torch.where(pad_mask(x_len, x.shape[1]), dur,
                              torch.zeros_like(dur))
            h = time_mask(h, x_len)
        h, mel_len = length_regulate(h, dur, max_t)
        out = self._decode(h, mel_len, compute_dtype)
        out.update(pitch=pitch, energy=energy, mel_len=mel_len)
        return out

    @torch.no_grad()
    def generate(self, x: torch.Tensor, max_t: int, alpha: Knob = 1.0,
                 pitch_scale: Knob = 1.0, energy_scale: Knob = 1.0,
                 x_len: Optional[torch.Tensor] = None,
                 compute_dtype: torch.dtype = torch.bfloat16,
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
