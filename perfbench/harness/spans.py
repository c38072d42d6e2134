"""What the per-layer readers take from the port's spans: the store that
`forwardtacotron_tpu_torch/utils/profiling.py` fills while a profiler
records (`annotate`) and returns from `spans()`.

Every reader reads the same steps: the spans whose `step` is below
N = len(ctx['traced_shapes']), the traced slice's first N steps, which
record the card's activity alone and give `ctx['trace']` its busy and
kernel times. A program without the store, or a store that holds fewer
than those N steps, gives nothing (None), never a number.

`Span.step` counts the `ftt.train.step` spans the process has recorded
and is never reset, so steps 0..N-1 are the traced slice's only while no
`train_step` ran under a profiler before the slice. The harness profiles
nothing before it; a set-up or warm-up that did would be read in the
slice's place, and this selection could not tell."""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

def traced_spans(ctx: Dict[str, Any]) -> Optional[Tuple[List[Any], int]]:
    """(the spans of the traced steps, N), or None."""
    n = len(ctx.get('traced_shapes') or ())
    if n == 0:
        return None
    from forwardtacotron_tpu_torch.utils import profiling
    read = getattr(profiling, 'spans', None)
    step = getattr(profiling, 'STEP_SPAN', None)
    if read is None or step is None:
        return None
    spans = [s for s in read() if s.step < n]
    if {s.step for s in spans if s.name == step} != set(range(n)):
        return None
    return spans, n


def mean_ms(ctx: Dict[str, Any], name: str) -> Optional[float]:
    """The spans named `name` summed within each traced step, their mean
    over the N steps, in ms."""
    got = traced_spans(ctx)
    if got is None:
        return None
    spans, n = got
    return sum(s.end_ns - s.start_ns for s in spans if s.name == name) \
        / n / 1e6
