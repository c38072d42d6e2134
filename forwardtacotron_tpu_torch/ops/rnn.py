"""Bidirectional GRU/LSTM in the torch parameter layout.

- GRU gates are ordered r|z|n, with the reset gate applied to the
  hidden projection plus its bias (`n = tanh(gi_n + r * (W_hn h + b_hn))`);
  LSTM gates are ordered i|f|g|o.
- Variable lengths follow pack_padded_sequence: the forward direction
  updates while t < len, the backward direction starts at each
  sequence's true end, and padded outputs are filled with `pad_value`.
- The input projection gi = x W_ihᵀ + b_ih of the whole sequence is one
  matmul; only the hidden recurrence runs step by step. That recurrence
  is `birnn_recurrence`: the plain version of the CUDA kernel in
  `kernels/birnn.py`, which `grouped_birnn` reaches through the kernel's
  wrapper (the kernel for CUDA tensors, this function for CPU ones).
- `gru` runs one unidirectional recurrence as a single stream of the
  same kernels (WaveRNN's teacher-forced GRUs).
- `compute_dtype=None` (the training forwards) follows the input: a
  bfloat16 x runs the recurrence in bfloat16 (gi, W_hh and the stash;
  the state stays float32), anything else in float32, and y comes back
  in x's dtype (`kernels/birnn.py:641,679` of the JAX package).
- Under autograd (grad mode on and an input that requires grad) the
  recurrence is `BiRNNTrain` instead: the training forward and BPTT
  kernels of `kernels/birnn_train.py`, whose plain versions are
  `birnn_train_forward` and `birnn_train_backward`.

Parameter dicts: {'w_ih': (NG*H, D), 'w_hh': (NG*H, H), 'b_ih': (NG*H,),
'b_hh': (NG*H,)} with NG = 3 (GRU) or 4 (LSTM).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from forwardtacotron_tpu_torch.ops.masking import pad_mask

Params = Dict[str, torch.Tensor]


def n_gates(cell: str) -> int:
    if cell not in ('gru', 'lstm'):
        raise ValueError(f'unknown cell {cell!r}')
    return 4 if cell == 'lstm' else 3


def follow_dtype(x: torch.Tensor,
                 compute_dtype: Optional[torch.dtype]) -> torch.dtype:
    """`compute_dtype`, or where it is None the recurrence's dtype for
    input x: bfloat16 for bfloat16 x, float32 otherwise."""
    if compute_dtype is not None:
        return compute_dtype
    return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


def gru_from_gates(gi: torch.Tensor, gh: torch.Tensor, h: torch.Tensor
                   ) -> torch.Tensor:
    """GRU update from input gates gi and hidden gates gh = W_hh h + b_hh
    (both (..., 3H))."""
    H = h.shape[-1]
    r = torch.sigmoid(gi[..., :H] + gh[..., :H])
    z = torch.sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
    n = torch.tanh(gi[..., 2 * H:] + r * gh[..., 2 * H:])
    return (1.0 - z) * n + z * h


def stream_active(t: int, n_steps: int, n_streams: int,
                  lengths: torch.Tensor) -> torch.Tensor:
    """(S, B) bool: is stream s at step t inside its sequence? Even
    streams run forward (active iff t < len); odd streams run over the
    time-reversed input (active iff n_steps - len <= t)."""
    fwd = t < lengths
    bwd = t >= n_steps - lengths
    return torch.stack([fwd if s % 2 == 0 else bwd
                        for s in range(n_streams)])


def _recurrence(cell, gi, w_hh, b_hh, lengths, compute_dtype, stash: bool):
    T, B, S, _ = gi.shape
    H = w_hh.shape[-1]
    lstm = n_gates(cell) == 4
    w = w_hh.float()
    b = b_hh.float()[:, None, :]
    h = gi.new_zeros((S, B, H), dtype=torch.float32)
    c = torch.zeros_like(h)
    ys, stashes = [], []
    for t in range(T):
        hq = h.to(compute_dtype).float()
        gh = torch.einsum('sbh,sgh->sbg', hq, w) + b
        g = gi[t].float().transpose(0, 1)                 # (S, B, NG*H)
        if lstm:
            gates = g + gh
            i = torch.sigmoid(gates[..., :H])
            f = torch.sigmoid(gates[..., H:2 * H])
            gg = torch.tanh(gates[..., 2 * H:3 * H])
            o = torch.sigmoid(gates[..., 3 * H:])
            c_new = f * c + i * gg
            h_new = o * torch.tanh(c_new)
            saved = (i, f, gg, o, c)
        else:
            r = torch.sigmoid(g[..., :H] + gh[..., :H])
            z = torch.sigmoid(g[..., H:2 * H] + gh[..., H:2 * H])
            n = torch.tanh(g[..., 2 * H:] + r * gh[..., 2 * H:])
            h_new = (1.0 - z) * n + z * h
            saved = (r, z, n, gh[..., 2 * H:], h)
        if stash:
            stashes.append(torch.stack(saved, dim=2))     # (S, B, 5, H)
        active = stream_active(t, T, S, lengths)[..., None]
        h = torch.where(active, h_new, h)
        if lstm:
            c = torch.where(active, c_new, c)
        ys.append(h)
    y = torch.stack(ys).permute(0, 2, 1, 3).contiguous()
    if not stash:
        return y, None
    st = torch.stack(stashes).transpose(1, 2).to(compute_dtype).contiguous()
    return y, st


def birnn_recurrence(cell: str, gi: torch.Tensor, w_hh: torch.Tensor,
                     b_hh: torch.Tensor, lengths: torch.Tensor,
                     compute_dtype: torch.dtype = torch.float32
                     ) -> torch.Tensor:
    """Plain version of the BiRNN kernel: S independent recurrences
    ("streams") advanced together.

    gi (T, B, S, NG*H) input gates in `compute_dtype`, odd streams
    time-reversed; w_hh (S, NG*H, H) in `compute_dtype`; b_hh (S, NG*H)
    float32 (zeros for LSTM, whose b_hh is folded into gi); lengths (B,)
    int. The hidden state is float32 and is rounded to `compute_dtype`
    before each product, which accumulates in float32, exactly as the
    kernel does. Returns y (T, B, S, H) float32: the state after each
    step (held, not updated, at inactive steps)."""
    return _recurrence(cell, gi, w_hh, b_hh, lengths, compute_dtype,
                       stash=False)[0]


def birnn_train_forward(cell: str, gi: torch.Tensor, w_hh: torch.Tensor,
                        b_hh: torch.Tensor, lengths: torch.Tensor,
                        compute_dtype: torch.dtype = torch.float32):
    """Plain version of the training forward kernel: `birnn_recurrence`
    (same arguments, same y) that also returns the stash (T, B, S, 5, H)
    in `compute_dtype`: per stream and step the values the backward needs,
    GRU r, z, n, gh_n (the hidden n-gate with its bias), h_prev; LSTM i,
    f, g, o, c_prev. Inactive steps stash what the step computed; the
    backward ignores them."""
    return _recurrence(cell, gi, w_hh, b_hh, lengths, compute_dtype,
                       stash=True)


def birnn_train_backward(cell: str, stash: torch.Tensor, dy: torch.Tensor,
                         w_hh: torch.Tensor, lengths: torch.Tensor,
                         compute_dtype: torch.dtype = torch.float32):
    """Plain version of the BPTT kernel: one reversed walk over the steps
    of every stream.

    stash (T, B, S, 5, H) from the training forward; dy (T, B, S, H)
    float32, the gradient of y; w_hh and lengths as in the forward.
    Returns (dgi, dgh), each (T, B, S, NG*H) in `compute_dtype`: the
    gradients of the input gates gi and of the hidden gates
    gh = W_hh h + b_hh. They differ only in the GRU n gate, where the
    reset gate scales the hidden path (dgh_n = dgi_n * r); for LSTM they
    are one tensor. At inactive steps both are zero and dh (and dc) pass
    through unchanged. dgh is rounded to `compute_dtype` before its
    product with W_hh, which accumulates in float32."""
    T, B, S, _, H = stash.shape
    lstm = n_gates(cell) == 4
    w = w_hh.float()
    dh = dy.new_zeros((S, B, H), dtype=torch.float32)
    dc = torch.zeros_like(dh)
    dgis, dghs = [None] * T, [None] * T
    for t in reversed(range(T)):
        parts = stash[t].float().transpose(0, 1).unbind(2)   # 5 x (S, B, H)
        dh = dh + dy[t].float().transpose(0, 1)
        active = stream_active(t, T, S, lengths)[..., None]
        if lstm:
            i, f, g, o, c_prev = parts
            tc = torch.tanh(f * c_prev + i * g)
            dct = dh * o * (1.0 - tc * tc) + dc
            dpre = torch.cat([dct * g * i * (1.0 - i),
                              dct * c_prev * f * (1.0 - f),
                              dct * i * (1.0 - g * g),
                              dh * tc * o * (1.0 - o)], dim=-1)
            dgi_t = dgh_t = torch.where(active, dpre, torch.zeros_like(dpre))
            dh_prev = torch.einsum('sbg,sgh->sbh',
                                   dgh_t.to(compute_dtype).float(), w)
            dc = torch.where(active, dct * f, dc)
        else:
            r, z, n, gh_n, h_prev = parts
            dpre_n = dh * (1.0 - z) * (1.0 - n * n)
            dpre_r = dpre_n * gh_n * r * (1.0 - r)
            dpre_z = dh * (h_prev - n) * z * (1.0 - z)
            zero = torch.zeros_like(dpre_n)
            dgi_t = torch.cat([torch.where(active, v, zero)
                               for v in (dpre_r, dpre_z, dpre_n)], dim=-1)
            dgh_t = torch.cat([torch.where(active, v, zero)
                               for v in (dpre_r, dpre_z, dpre_n * r)], dim=-1)
            dh_prev = dh * z + torch.einsum(
                'sbg,sgh->sbh', dgh_t.to(compute_dtype).float(), w)
        dh = torch.where(active, dh_prev, dh)
        dgis[t], dghs[t] = dgi_t, dgh_t
    dgi = torch.stack(dgis).transpose(1, 2).to(compute_dtype).contiguous()
    if lstm:
        return dgi, dgi
    dgh = torch.stack(dghs).transpose(1, 2).to(compute_dtype).contiguous()
    return dgi, dgh


def _valid_steps(n_steps: int, n_streams: int,
                 lengths: torch.Tensor) -> torch.Tensor:
    """(T, B, S) bool: `stream_active` for every step at once."""
    ts = torch.arange(n_steps, device=lengths.device)[:, None]
    fwd = ts < lengths[None, :]
    bwd = ts >= n_steps - lengths[None, :]
    return torch.stack([fwd if s % 2 == 0 else bwd
                        for s in range(n_streams)], dim=2)


class BiRNNTrain(torch.autograd.Function):
    """The BiRNN recurrence under autograd: (gi, w_hh, b_hh) -> y, with the
    arguments and result of `birnn_recurrence`.

    The forward runs the training forward kernel (#2,
    `kernels/birnn_train.py:train_forward`) and keeps its stash; the
    backward runs the BPTT kernel (#3, `train_backward`), then forms
    dW_hh = sum over steps and lanes of dghᵀ h_prev and db_hh = sum of dgh
    as whole-sequence products, as the JAX package's `birnn_train` does
    outside Pallas. h_prev is stash slot 4 for GRU; for LSTM it is rebuilt
    as o*tanh(f*c_prev + i*g), zeroed at inactive steps and shifted one
    step. The boundary is the recurrence alone: autograd differentiates
    the input projection and the stream flips around it
    (`grouped_birnn`). CPU tensors take the plain versions."""

    @staticmethod
    def forward(ctx, cell, gi, w_hh, b_hh, lengths, compute_dtype):
        from forwardtacotron_tpu_torch.kernels.birnn_train import (
            train_forward)
        y, stash = train_forward(cell, gi, w_hh, b_hh, lengths,
                                 compute_dtype)
        ctx.save_for_backward(stash, w_hh, lengths)
        ctx.cell, ctx.compute_dtype = cell, compute_dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        from forwardtacotron_tpu_torch.kernels.birnn_train import (
            train_backward)
        stash, w_hh, lengths = ctx.saved_tensors
        dgi, dgh = train_backward(ctx.cell, stash, dy.float().contiguous(),
                                  w_hh, lengths, ctx.compute_dtype)
        need_w, need_b = ctx.needs_input_grad[2:4]
        dw = db = None
        if need_w or need_b:
            dgh = dgh.float()
            db = dgh.sum(dim=(0, 1))
        if need_w:
            T, _, S = stash.shape[:3]
            st = stash.float()
            if ctx.cell == 'lstm':
                i, f, g, o, c_prev = st.unbind(3)
                h = o * torch.tanh(f * c_prev + i * g)
                h = torch.where(_valid_steps(T, S, lengths)[..., None], h,
                                torch.zeros_like(h))
                h_prev = torch.cat([torch.zeros_like(h[:1]), h[:-1]])
            else:
                h_prev = st[:, :, :, 4]
            dw = torch.einsum('tbsg,tbsh->sgh', dgh, h_prev).to(w_hh.dtype)
        return None, dgi, dw, db, None, None


def grouped_birnn(cell: str, w_ih: torch.Tensor, w_hh: torch.Tensor,
                  b_ih: torch.Tensor, b_hh: torch.Tensor,
                  x_groups: torch.Tensor,
                  lengths: Optional[torch.Tensor] = None,
                  compute_dtype: Optional[torch.dtype] = torch.float32
                  ) -> torch.Tensor:
    """G independent bidirectional RNNs in one recurrence.

    w_ih (2, G, NG*H, D) with direction 0 = forward; w_hh (2, G, NG*H, H);
    b_ih/b_hh (2, G, NG*H); x_groups (B, T, G, D). Returns (B, T, G, 2, H)
    per-group [forward, backward] features in x's dtype, zero at
    t >= lengths. `compute_dtype` None follows x (`follow_dtype`)."""
    from forwardtacotron_tpu_torch.kernels.birnn import recurrence
    compute_dtype = follow_dtype(x_groups, compute_dtype)
    B, T, G, _ = x_groups.shape
    H = w_hh.shape[-1]
    GH = w_ih.shape[-2]
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32,
                             device=x_groups.device)
    lengths = lengths.to(device=x_groups.device, dtype=torch.int32)
    gi = torch.einsum('btgd,cghd->btcgh', x_groups, w_ih) \
        + b_ih[None, None]                                # (B, T, 2, G, GH)
    if cell == 'lstm':
        gi = gi + b_hh[None, None]
        b_rec = torch.zeros((2 * G, GH), dtype=torch.float32,
                            device=x_groups.device)
    else:
        b_rec = b_hh.transpose(0, 1).reshape(2 * G, GH).float()
    # stream s = 2g + d; the backward stream walks reversed time
    gi = torch.stack([gi[:, :, 0], gi[:, :, 1].flip(1)], dim=3)
    gi = gi.transpose(0, 1).reshape(T, B, 2 * G, GH)
    gi = gi.to(compute_dtype).contiguous()
    w = w_hh.transpose(0, 1).reshape(2 * G, GH, H).to(compute_dtype)
    args = (cell, gi, w.contiguous(), b_rec.contiguous(), lengths,
            compute_dtype)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args[1:4]):
        y = BiRNNTrain.apply(*args)                       # kernels #2, #3
    else:
        y = recurrence(*args)                             # kernel #1
    # y: (T, B, 2G, H), float32 from the kernels; autograd turns a
    # bfloat16 dy back into float32 exactly
    y = y.to(x_groups.dtype).reshape(T, B, G, 2, H)
    y = torch.stack([y[:, :, :, 0], y[:, :, :, 1].flip(0)], dim=3)
    y = y.permute(1, 0, 2, 3, 4)                          # (B, T, G, 2, H)
    valid = pad_mask(lengths, T)[:, :, None, None, None]
    return torch.where(valid, y, torch.zeros_like(y))


def grouped_bigru(w_ih, w_hh, b_ih, b_hh, x_groups, lengths=None,
                  compute_dtype: Optional[torch.dtype] = torch.float32
                  ) -> torch.Tensor:
    return grouped_birnn('gru', w_ih, w_hh, b_ih, b_hh, x_groups, lengths,
                         compute_dtype)


def mask_outputs(y: torch.Tensor, lengths: Optional[torch.Tensor],
                 pad_value: float) -> torch.Tensor:
    if lengths is None:
        return y
    mask = pad_mask(lengths.to(y.device), y.shape[1])[:, :, None]
    return torch.where(mask, y, torch.full_like(y, pad_value))


def birnn(cell: str, params_fwd: Params, params_bwd: Params,
          x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
          pad_value: float = 0.0,
          compute_dtype: Optional[torch.dtype] = torch.float32
          ) -> torch.Tensor:
    """Bidirectional RNN over x (B, T, D) -> (B, T, 2H) = [fwd, bwd]."""
    def stack(k):
        return torch.stack([params_fwd[k], params_bwd[k]])[:, None]
    y = grouped_birnn(cell, stack('w_ih'), stack('w_hh'), stack('b_ih'),
                      stack('b_hh'), x[:, :, None, :], lengths,
                      compute_dtype)
    y = torch.cat([y[:, :, 0, 0], y[:, :, 0, 1]], dim=-1)
    return mask_outputs(y, lengths, pad_value)


def bigru(params_fwd: Params, params_bwd: Params, x: torch.Tensor,
          lengths: Optional[torch.Tensor] = None, pad_value: float = 0.0,
          compute_dtype: Optional[torch.dtype] = torch.float32
          ) -> torch.Tensor:
    return birnn('gru', params_fwd, params_bwd, x, lengths, pad_value,
                 compute_dtype)


def bilstm(params_fwd: Params, params_bwd: Params, x: torch.Tensor,
           lengths: Optional[torch.Tensor] = None, pad_value: float = 0.0,
           compute_dtype: Optional[torch.dtype] = torch.float32
           ) -> torch.Tensor:
    return birnn('lstm', params_fwd, params_bwd, x, lengths, pad_value,
                 compute_dtype)


def gru(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Unidirectional GRU over x (B, T, D) -> (B, T, H) from a zero state
    (the JAX package's `ops/rnn.py:gru` without lengths), in x's dtype:
    bfloat16 x runs the recurrence in bfloat16 (`follow_dtype`), anything
    else in float32. The input projection of the whole sequence is one
    product, and the recurrence runs as one stream (S=1) of the BiRNN
    kernels. Under autograd that is `BiRNNTrain` (kernels #2 and #3),
    under no_grad the inference kernel #1, and CPU tensors take their
    plain versions."""
    from forwardtacotron_tpu_torch.kernels.birnn import recurrence
    compute_dtype = follow_dtype(x, None)
    B, T, _ = x.shape
    gi = torch.matmul(x, params['w_ih'].T) + params['b_ih']   # (B, T, 3H)
    lengths = torch.full((B,), T, dtype=torch.int32, device=x.device)
    args = ('gru', gi.transpose(0, 1)[:, :, None].to(compute_dtype)
            .contiguous(),
            params['w_hh'][None].to(compute_dtype).contiguous(),
            params['b_hh'][None].float().contiguous(), lengths,
            compute_dtype)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args[1:4]):
        y = BiRNNTrain.apply(*args)                       # kernels #2, #3
    else:
        y = recurrence(*args)                             # kernel #1
    return y[:, :, 0].transpose(0, 1).to(x.dtype)         # (B, T, H)


def pad_gru_gates(w: torch.Tensor, h_group: int, h_common: int,
                  n: int = 3) -> torch.Tensor:
    """Zero-pad the per-gate blocks of a stacked-gate tensor
    (n*h_group, ...) to (n*h_common, ...)."""
    if h_group == h_common:
        return w
    w = w.reshape((n, h_group) + tuple(w.shape[1:]))
    pad = w.new_zeros((n, h_common - h_group) + tuple(w.shape[2:]))
    return torch.cat([w, pad], dim=1).reshape(
        (n * h_common,) + tuple(w.shape[2:]))
