"""gan_train_mfu: the GAN training step's share of the card's peak, in %:
the model FLOPs of the window's steps (perfbench/harness/gan_flops.py:
3 G + 4.5 D of the generator's and the discriminators' forwards at the
cell's batch and segment, the work train.py's step needs) over the window's length times the peak of the
fastest arithmetic the step may use (cuDNN's TF32 when it is on: 495
TFLOP/s; else float32's 67). Layer: train/hifigan_trainer.py."""
from perfbench.harness.flops import PEAK_FLOPS


def read(ctx):
    if ctx.get('kind') != 'gan' or not ctx.get('window_steps'):
        return None
    return 100.0 * ctx['window_steps'] * ctx['step_flops'] / (
        ctx['window_s'] * PEAK_FLOPS[ctx['peak']])
