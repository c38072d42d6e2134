"""gan_disc_update_ms.train: the card time of the GAN step's first half,
the discriminators' update (`ftt.gan.disc_update` around `disc_step`), in
ms a step: the union of the intervals of the work on the card launched
while that span was open, on any host thread, matched through the
profiler's link from each kernel to its launch call
(perfbench/harness/span_kernels.py), over the host-traced steps. None
where the spans or the links are missing. Layer:
train/hifigan_trainer.py."""


def read(ctx):
    halves = ctx.get('gan_halves')
    if not halves or not ctx.get('gan_traced_steps'):
        return None
    seconds = halves['seconds'].get('ftt.gan.disc_update')
    return None if seconds is None else \
        1e3 * seconds / ctx['gan_traced_steps']
