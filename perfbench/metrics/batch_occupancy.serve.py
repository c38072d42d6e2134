"""batch_occupancy.serve: the mean size of the batches `TTSServer` formed
in the window (its `batch_sizes`), over `max_batch`, in %. Layer:
serving.py's batcher."""


def read(ctx):
    sizes = ctx.get('batch_sizes')
    if not sizes:
        return None
    return 100.0 * sum(sizes) / len(sizes) / ctx['max_batch']
