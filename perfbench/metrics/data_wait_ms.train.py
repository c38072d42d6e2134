"""data_wait_ms.train: the host's mean wait, in ms a step over the
window's steps, for the next batch from the port's loader (`Prefetcher`
over `BucketBatcher`) and its copy to the card (`batch_to_device`); host
clock around the harness's own calls. Layer: data/."""


def read(ctx):
    waits = ctx.get('data_wait_s')
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
