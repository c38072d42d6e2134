"""loader_wait_ms.train: the consumer's wait for the loader's next batch
(`Prefetcher`'s queue over `BucketBatcher`), in ms: the mean over the
traced steps of the port's `ftt.data.next` spans in each. Host clock
(`time.perf_counter_ns`), read from the port's span store
(`utils/profiling.py:spans`, through perfbench/harness/spans.py).
Layer: data/."""
from perfbench.harness.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, 'ftt.data.next')
