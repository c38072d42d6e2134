"""update_host_ms.train: the host time of `apply_update` (the reductions,
the clip, Adam's step, the EMA), in ms: the mean over the traced steps of
the port's `ftt.train.update` spans in each. Host clock
(`time.perf_counter_ns`), read from the port's span store
(`utils/profiling.py:spans`, through perfbench/harness/spans.py).
Layer: train/common.py."""
from perfbench.harness.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, 'ftt.train.update')
