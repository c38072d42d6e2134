"""birnn_train_roofline.train: kernels #2 and #3 against their roofline,
in %: the summed bounds of the traced steps' launches, from each step's
batch shapes (perfbench/harness/flops.py, chip_smoke.py's arithmetic),
over the summed device time of the kernels named train_fwd* and
train_bwd* in the profiler's trace. Layer: kernels/birnn_train.py with
csrc/birnn_train.cu."""
from perfbench.harness.flops import forward_tacotron_kernel_bound_s
from perfbench.harness.trace import kernel_seconds


def read(ctx):
    trace = ctx.get('trace')
    if trace is None or ctx.get('kind') != 'forward_tacotron':
        return None
    spent = kernel_seconds(trace, ('train_fwd', 'train_bwd'))
    if spent <= 0:
        return None
    m = ctx['cfg']['forward_tacotron']['model']
    bound = sum(forward_tacotron_kernel_bound_s(m, ctx['batch_size'], tx,
                                                tm, lens)
                for tx, tm, lens in ctx['traced_shapes'])
    return 100.0 * bound / spent
