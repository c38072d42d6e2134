"""Tacotron teacher: autoregressive seq2seq with location-sensitive
attention, teacher-forced.

Mirrors `forwardtacotron_tpu/models/tacotron.py` (the reference's
models/tacotron.py). Its role in the pipeline is the attention matrix
from which the student's durations are extracted (`align/`), and
optionally ground-truth-aligned mels. Module and buffer names are the
reference's `state_dict` keys (`encoder.embedding`, `encoder.pre_net`,
`encoder.cbhg`, `encoder_proj`, `decoder.prenet`, `decoder.attn_net.conv`
/ `L` / `W` / `v`, `decoder.attn_rnn`, `decoder.rnn_input`,
`decoder.res_rnn1` / `res_rnn2`, `decoder.mel_proj`, `postnet`,
`post_proj`, and the `step`, `decoder.r` and `stop_threshold` buffers).

- The two CBHG BiGRUs (encoder over the padded text, postnet over the
  whole mel, both without lengths, as the reference's padded batches) go
  through the BiRNN kernels: #2/#3 under autograd, #1 otherwise.
- The decoder is a Python loop of one step per r frames, in ordinary
  PyTorch ops (the JAX package's `lax.scan` has no Pallas kernel): GRU
  attention cell, LSA over every text position (padding included, no
  mask, as the reference), two residual LSTM cells, the mel projection.
  The prenet of every step runs over the whole teacher-forced sequence
  at once (go frame, then mel[:, t·r - 1]).
- Train mode is the module's mode (`train()`): batch statistics in the
  batch norms, and prenet dropout (p = `PreNet.p`, 0.5), CBHG dropout
  (0.5) and zoneout of both LSTM cells' h (keep the old h with
  probability `Decoder.zoneout`, 0.1; c is updated) drawn from the
  `generator` that `forward` is given. Train mode needs one; eval mode
  draws nothing.
- `generate` is the free-running synthesis of `gen_tacotron`: the same
  decoder step in eval mode, fed its own last frame, until the reference's
  stop criterion; the two CBHG BiGRUs run kernel #1.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from forwardtacotron_tpu_torch.models.layers import (CBHG, dropout,
                                                     speaker_emb)
from forwardtacotron_tpu_torch.text.symbols import phonemes

MAX_R = 20        # the largest reduction factor mel_proj is sized for
# `generate` reads its stop flag from the device every this many steps (a
# read each step would wait for the device each step)
STOP_CHECK_EVERY = 8


class PreNet(nn.Module):

    def __init__(self, in_dims: int, fc1_dims: int = 256,
                 fc2_dims: int = 128, p: float = 0.5) -> None:
        super().__init__()
        self.fc1 = nn.Linear(in_dims, fc1_dims)
        self.fc2 = nn.Linear(fc1_dims, fc2_dims)
        self.p = p

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(F.relu(self.fc1(x)), self.p, generator)
        return dropout(F.relu(self.fc2(x)), self.p, generator)


class Encoder(nn.Module):
    """embedding -> prenet -> CBHG(K, channels, proj [channels, channels])."""

    def __init__(self, embed_dims: int, num_chars: int, cbhg_channels: int,
                 K: int, num_highways: int) -> None:
        super().__init__()
        self.embedding = nn.Embedding(num_chars, embed_dims)
        self.pre_net = PreNet(embed_dims)
        self.cbhg = CBHG(K=K, in_channels=self.pre_net.fc2.out_features,
                         channels=cbhg_channels,
                         proj_channels=[cbhg_channels, cbhg_channels],
                         num_highways=num_highways, dropout=0.5)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.pre_net(self.embedding(x), generator)
        return self.cbhg(h, generator=generator)


class LSA(nn.Module):
    """Location-sensitive attention: a conv over the cumulative and the
    previous attention, added to the projected query and encoder output;
    the softmax runs over every text position."""

    def __init__(self, attn_dims: int, kernel_size: int = 31,
                 filters: int = 32) -> None:
        super().__init__()
        self.conv = nn.Conv1d(2, filters, kernel_size,
                              padding=(kernel_size - 1) // 2, bias=False)
        self.L = nn.Linear(filters, attn_dims)
        self.W = nn.Linear(attn_dims, attn_dims)
        self.v = nn.Linear(attn_dims, 1, bias=False)

    def forward(self, encoder_seq_proj: torch.Tensor, query: torch.Tensor,
                cumulative: torch.Tensor, prev_attn: torch.Tensor
                ) -> torch.Tensor:
        processed_query = self.W(query)[:, None, :]              # (B, 1, D)
        location = torch.stack([cumulative, prev_attn], dim=1)   # (B, 2, T)
        processed_loc = self.L(self.conv(location).transpose(1, 2))
        u = self.v(torch.tanh(processed_query + encoder_seq_proj
                              + processed_loc))[..., 0]          # (B, T)
        return torch.softmax(u, dim=1)


class Decoder(nn.Module):

    zoneout = 0.1

    def __init__(self, n_mels: int, encoder_dims: int, decoder_dims: int,
                 lstm_dims: int) -> None:
        super().__init__()
        self.register_buffer('r', torch.tensor(1, dtype=torch.int))
        self.prenet = PreNet(n_mels)
        self.attn_net = LSA(decoder_dims)
        self.attn_rnn = nn.GRUCell(decoder_dims + decoder_dims // 2,
                                   decoder_dims)
        self.rnn_input = nn.Linear(2 * encoder_dims + decoder_dims,
                                   lstm_dims)
        self.res_rnn1 = nn.LSTMCell(lstm_dims, lstm_dims)
        self.res_rnn2 = nn.LSTMCell(lstm_dims, lstm_dims)
        self.mel_proj = nn.Linear(lstm_dims, n_mels * MAX_R, bias=False)

    def _zoneout(self, h: torch.Tensor, h_next: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        if generator is None or self.zoneout == 0:
            return h_next
        keep_old = torch.rand(h.shape, generator=generator,
                              device=h.device) < self.zoneout
        return torch.where(keep_old, h, h_next)

    def step(self, encoder_seq: torch.Tensor, encoder_seq_proj: torch.Tensor,
             prenet_out: torch.Tensor, state: Tuple[torch.Tensor, ...],
             generator: Optional[torch.Generator]):
        """One decoder step from this step's prenet output: returns
        (mels (B, n_mels·MAX_R), attention scores (B, Tx), state)."""
        (attn_h, r1_h, r1_c, r2_h, r2_c, context, cumulative,
         prev_attn) = state
        attn_h = self.attn_rnn(torch.cat([context, prenet_out], dim=-1),
                               attn_h)
        scores = self.attn_net(encoder_seq_proj, attn_h, cumulative,
                               prev_attn)
        cumulative = cumulative + scores
        context = torch.bmm(scores[:, None, :], encoder_seq)[:, 0]
        x = self.rnn_input(torch.cat([context, attn_h], dim=-1))
        r1_h_next, r1_c = self.res_rnn1(x, (r1_h, r1_c))
        r1_h = self._zoneout(r1_h, r1_h_next, generator)
        x = x + r1_h
        r2_h_next, r2_c = self.res_rnn2(x, (r2_h, r2_c))
        r2_h = self._zoneout(r2_h, r2_h_next, generator)
        x = x + r2_h
        state = (attn_h, r1_h, r1_c, r2_h, r2_c, context, cumulative, scores)
        return self.mel_proj(x), scores, state


class Tacotron(nn.Module):

    def __init__(self, embed_dims: int = 256, num_chars: int = len(phonemes),
                 encoder_dims: int = 128, decoder_dims: int = 256,
                 n_mels: int = 80, postnet_dims: int = 128,
                 encoder_k: int = 16, lstm_dims: int = 512,
                 postnet_k: int = 8, num_highways: int = 4,
                 dropout: float = 0.5, stop_threshold: float = -11.0,
                 n_speakers: int = 1, speaker_embed_dims: int = 64) -> None:
        """`dropout` is kept for the config's sake: as in the JAX package,
        the prenets and CBHGs use their own rate of 0.5. `n_speakers` > 1
        adds a speaker embedding, projected (no bias) onto the encoder's
        output; 1 adds no parameter."""
        super().__init__()
        self.n_speakers = n_speakers
        self.n_mels = n_mels
        self.encoder_dims = encoder_dims
        self.decoder_dims = decoder_dims
        self.lstm_dims = lstm_dims
        self.encoder = Encoder(embed_dims, num_chars, encoder_dims,
                               encoder_k, num_highways)
        self.encoder_proj = nn.Linear(2 * encoder_dims, decoder_dims,
                                      bias=False)
        if n_speakers > 1:
            self.speaker_embedding = nn.Embedding(n_speakers,
                                                  speaker_embed_dims)
            self.speaker_proj = nn.Linear(speaker_embed_dims,
                                          2 * encoder_dims, bias=False)
        self.decoder = Decoder(n_mels, encoder_dims, decoder_dims, lstm_dims)
        self.postnet = CBHG(K=postnet_k, in_channels=n_mels,
                            channels=postnet_dims,
                            proj_channels=[256, n_mels],
                            num_highways=num_highways, dropout=0.5)
        self.post_proj = nn.Linear(2 * postnet_dims, n_mels, bias=False)
        self.register_buffer('step', torch.zeros(1, dtype=torch.long))
        self.register_buffer('stop_threshold', torch.tensor(
            float(stop_threshold), dtype=torch.float32))

    def _condition_encoder(self, encoder_seq: torch.Tensor,
                           speaker: Optional[torch.Tensor]) -> torch.Tensor:
        """The encoder's output plus the projected speaker embedding (as
        it is for a single-speaker model); a missing id is speaker 0."""
        emb = speaker_emb(self, speaker, encoder_seq.shape[0],
                          encoder_seq.device)
        if emb is None:
            return encoder_seq
        return encoder_seq + self.speaker_proj(emb)[:, None, :]

    def _init_state(self, B: int, Tx: int, like: torch.Tensor):
        def z(*shape):
            return like.new_zeros(shape)
        return (z(B, self.decoder_dims), z(B, self.lstm_dims),
                z(B, self.lstm_dims), z(B, self.lstm_dims),
                z(B, self.lstm_dims), z(B, 2 * self.encoder_dims),
                z(B, Tx), z(B, Tx))

    def forward(self, x: torch.Tensor, mel: torch.Tensor, r: int,
                generator: Optional[torch.Generator] = None,
                speaker: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Teacher-forced forward. x (B, Tx) token ids; mel (B, T_mel,
        n_mels) time-major with T_mel a multiple of r; `speaker` (B,) ids
        condition a multi-speaker teacher's encoder. Returns (mel_out
        (B, T_mel, n_mels), linear (B, T_mel, n_mels), attention
        (B, T_mel // r, Tx))."""
        B, Tx = x.shape
        T_mel = mel.shape[1]
        if T_mel % r != 0:
            raise ValueError(f'mel length {T_mel} is not a multiple of r={r}')
        if self.training and generator is None:
            raise ValueError('train mode draws dropout and zoneout from a '
                             'torch.Generator: pass `generator`')
        gen = generator if self.training else None
        steps = T_mel // r
        encoder_seq = self._condition_encoder(self.encoder(x, gen), speaker)
        encoder_seq_proj = self.encoder_proj(encoder_seq)

        # teacher forcing: the go frame, then the last frame of each step
        prenet_in = torch.cat([mel.new_zeros((B, 1, self.n_mels)),
                               mel[:, r - 1:(steps - 1) * r:r]], dim=1)
        prenet_out = self.decoder.prenet(prenet_in, gen)
        state = self._init_state(B, Tx, encoder_seq)
        mels, scores = [], []
        for t in range(steps):
            m, s, state = self.decoder.step(encoder_seq, encoder_seq_proj,
                                            prenet_out[:, t], state, gen)
            mels.append(m)
            scores.append(s)
        # (B, steps, n_mels·MAX_R) -> (B, steps·r, n_mels)
        mels = torch.stack(mels, dim=1).reshape(B, steps, self.n_mels,
                                                MAX_R)[..., :r]
        mel_out = mels.transpose(2, 3).reshape(B, steps * r, self.n_mels)
        linear = self.post_proj(self.postnet(mel_out, generator=gen))
        return mel_out, linear, torch.stack(scores, dim=1)

    @torch.no_grad()
    def generate(self, x: torch.Tensor, steps: int = 2000, r: int = 1,
                 speaker: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
        """Free-running synthesis in eval mode (the JAX package's
        `Tacotron.generate`). x (B, Tx) token ids; at most `steps` frames,
        a multiple of r. Each step feeds the last of its r frames to the
        next; the run stops after the first step whose r frames are all
        below `stop_threshold` for every item, once more than 10 frames are
        out. The flag lives on the device and is read every
        STOP_CHECK_EVERY steps; the steps run past it are zeroed, so the
        buffers are those of a loop that stopped there. The postnet runs
        over the whole buffer, zeros included, as in JAX. Returns (mel (B,
        steps, n_mels), linear (B, steps, n_mels), attention (B, steps //
        r, Tx), n_valid): n_valid frames are valid."""
        if steps % r != 0:
            raise ValueError(f'steps={steps} is not a multiple of r={r}')
        was_training = self.training
        self.eval()
        try:
            B, Tx = x.shape
            n_steps = steps // r
            encoder_seq = self._condition_encoder(self.encoder(x), speaker)
            encoder_seq_proj = self.encoder_proj(encoder_seq)
            mel_buf = encoder_seq.new_zeros((B, n_steps, self.n_mels * MAX_R))
            attn_buf = encoder_seq.new_zeros((B, n_steps, Tx))
            state = self._init_state(B, Tx, encoder_seq)
            prenet_in = encoder_seq.new_zeros((B, self.n_mels))
            # the first step after which the run stops (n_steps: none yet)
            stop = torch.full((), n_steps, dtype=torch.long, device=x.device)
            for t in range(n_steps):
                m, s, state = self.decoder.step(
                    encoder_seq, encoder_seq_proj,
                    self.decoder.prenet(prenet_in), state, None)
                mel_buf[:, t] = m
                attn_buf[:, t] = s
                frames = m.reshape(B, self.n_mels, MAX_R)[..., :r]
                prenet_in = frames[..., -1]
                if (t + 1) * r > 10:
                    done = (frames < self.stop_threshold).all() \
                        & (stop == n_steps)
                    stop = torch.where(done, t + 1, stop)
                if (t + 1) % STOP_CHECK_EVERY == 0 \
                        and int(stop) < n_steps:
                    break
            n_valid = int(stop)
            mel_buf[:, n_valid:] = 0.0
            attn_buf[:, n_valid:] = 0.0
            mels = mel_buf.reshape(B, n_steps, self.n_mels, MAX_R)[..., :r]
            mel_out = mels.transpose(2, 3).reshape(B, n_steps * r,
                                                   self.n_mels)
            linear = self.post_proj(self.postnet(mel_out))
            return mel_out, linear, attn_buf, n_valid * r
        finally:
            self.train(was_training)

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> 'Tacotron':
        model_config = dict(config['tacotron']['model'])
        model_config['num_chars'] = len(phonemes)
        model_config['n_mels'] = config['dsp']['num_mels']
        return cls(**model_config)
