"""train_mfu: the whole training step's share of the card's peak, in %:
the model FLOPs of the window's steps from their batches' shapes
(perfbench/harness/flops.py) over the window's length times the peak of
the fastest arithmetic the configuration lets the step use (cuDNN's
TF32 when it is on: 495 TFLOP/s; else float32's 67). Layer:
train/common.py:train_step."""
from perfbench.harness.flops import PEAK_FLOPS
from perfbench.harness.train_steps import model_flops


def read(ctx):
    if not ctx.get('window_steps'):
        return None
    return 100.0 * model_flops(ctx, ctx['shapes']) / (
        ctx['window_s'] * PEAK_FLOPS[ctx['peak']])
