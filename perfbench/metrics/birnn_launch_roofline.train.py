"""birnn_launch_roofline.train: kernels #2 and #3 against their roofline,
in %, from the launches the port recorded: the traced steps' spans
`ftt.kernels.birnn_train_fwd` / `_bwd` (read from the port's span store,
`utils/profiling.py:spans`, through perfbench/harness/spans.py), each
bounded by `birnn_train_bounds` at the cell, T, B, H, S and lengths it
was given (the lengths read from the launch's device tensor after the
run), summed, over the device time of the kernels named train_fwd* and
train_bwd* in the profiler's trace of the same steps. None where a launch
is not float32 (the bounds' arithmetic is float32's). Layer:
kernels/birnn_train.py with csrc/birnn_train.cu."""
from perfbench.harness.flops import birnn_train_bounds
from perfbench.harness.spans import traced_spans
from perfbench.harness.trace import kernel_seconds

FWD, BWD = 'ftt.kernels.birnn_train_fwd', 'ftt.kernels.birnn_train_bwd'


def read(ctx):
    trace = ctx.get('trace')
    got = traced_spans(ctx)
    if trace is None or got is None:
        return None
    launches = [s for s in got[0] if s.name in (FWD, BWD)]
    if not launches or any(s.attrs['dtype'] != 'float32' for s in launches):
        return None
    spent = kernel_seconds(trace, ('train_fwd', 'train_bwd'))
    if spent <= 0:
        return None
    bound = 0.0
    for s in launches:
        a = s.attrs
        fwd, bwd = birnn_train_bounds(a['cell'], a['T'], a['B'], a['H'],
                                      a['lengths'].tolist(), a['S'])
        bound += fwd if s.name == FWD else bwd
    return 100.0 * bound / spent
