"""forward_host_ms.train: the host time of the forward and the loss
(`accumulate`'s `micro_loss`), in ms: the mean over the traced steps of
the port's `ftt.train.forward` spans summed in each. Host clock
(`time.perf_counter_ns`), read from the port's span store
(`utils/profiling.py:spans`, through perfbench/harness/spans.py).
Layer: models/, ops/."""
from perfbench.harness.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, 'ftt.train.forward')
