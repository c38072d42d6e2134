"""PyTorch/CUDA port of ForwardTacotron: inference, data preparation,
the Tacotron teacher and student training.

Inference: text -> phoneme ids -> ForwardTacotron mel -> waveform
(`gen_forward`, `serve_forward`). Data: wavs and an LJSpeech
`metadata.csv` -> mels, F0 and the split (`preprocess`) -> the Tacotron
teacher trained and its attention turned into durations, pitch and
energy (`train_tacotron`). Training: the ForwardTacotron student on that
dataset (`train_forward`). The sequential recurrences of these paths
(the bidirectional GRU/LSTM, its training forward and backward through
time, and the WaveRNN autoregressive sampler) are hand-written CUDA
kernels for Hopper (`csrc/`). Every entry point takes
an explicit `device`, which defaults to ``'cuda'``; the plain PyTorch
versions of the kernels run only for tensors that lie on the CPU.
"""
import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. Asking for CUDA on a machine
    without it raises instead of silently running on the CPU."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA device requested but torch.cuda is not '
                           "available; pass device='cpu' explicitly")
    return device
