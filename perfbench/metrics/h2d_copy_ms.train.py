"""h2d_copy_ms.train: the host time of the batch's host-to-device copies
(`batch_to_device`; a copy from pageable memory blocks the host), in ms:
the mean over the traced steps of the port's `ftt.data.to_device` spans
in each. Host clock (`time.perf_counter_ns`), read from the port's span
store (`utils/profiling.py:spans`, through perfbench/harness/spans.py).
Layer: data/."""
from perfbench.harness.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, 'ftt.data.to_device')
