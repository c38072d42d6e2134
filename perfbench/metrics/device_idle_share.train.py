"""device_idle_share.train: the share of the traced slice's wall time in
which no kernel ran on the card, in %: 1 - the union of the kernel
intervals (torch.profiler, CUPTI) over the slice. Layer: the device."""


def read(ctx):
    trace = ctx.get('trace')
    if trace is None or trace['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - trace['busy_s'] / trace['window_s'])
