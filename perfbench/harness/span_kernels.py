"""The card time of the work launched inside the port's spans, from one
`torch.profiler` trace that recorded the host's operations and the
card's activity together.

A span opens a `record_function` of its name, so the trace holds it as
a host event with its interval. Each kernel, copy or fill on the card
carries the correlation id of the runtime call that launched it
(`cudaLaunchKernel`, `cuLaunchKernel`, `cudaMemcpyAsync`, ...), a host
event of the same id, on whatever thread made it: autograd's own
included. Work belongs to a span name when its launch call began inside
one of that name's intervals, and the name's card time is the union of
the intervals of its work (work that overlaps, as on cuDNN's side
streams, counts once).
"""
from __future__ import annotations

import bisect
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Sequence

# what a mirrored user annotation on the card's timeline is named
ANNOTATION_PREFIXES = ('ftt.', 'perfbench.')


class Event(NamedTuple):
    name: str
    on_card: bool
    start_ns: float
    end_ns: float
    id: int


def events_of(prof) -> List[Event]:
    """A profile's events: the card's work, and every host event."""
    out = []
    for e in prof.events():
        on_card = str(e.device_type).endswith('CUDA')
        if on_card and (getattr(e, 'is_user_annotation', False)
                        or e.name.startswith(ANNOTATION_PREFIXES)):
            continue
        out.append(Event(e.name, on_card, 1e3 * e.time_range.start,
                         1e3 * e.time_range.end, int(e.id)))
    return out


def union_ns(intervals: Iterable[Sequence[float]]) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _inside(t: float, starts: List[float], spans: List[Sequence[float]]
            ) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= spans[i][1]


def span_card_seconds(events: Sequence[Event], names: Sequence[str]
                      ) -> Optional[Dict[str, Any]]:
    """{'seconds': {name: card seconds of the work launched inside the
    name's spans, or None where none was}, 'linked': work matched to its
    launch call, 'unlinked': work without one}; None where a name has no
    span or no work is linked at all."""
    spans = {n: sorted((e.start_ns, e.end_ns) for e in events
                       if not e.on_card and e.name == n) for n in names}
    if not all(spans.values()):
        return None
    launches = {e.id: e.start_ns for e in events
                if not e.on_card and e.name.startswith('cu')}
    starts = {n: [a for a, _ in s] for n, s in spans.items()}
    work: Dict[str, List[Sequence[float]]] = {n: [] for n in names}
    linked = unlinked = 0
    for e in events:
        if not e.on_card:
            continue
        t = launches.get(e.id)
        if t is None:
            unlinked += 1
            continue
        linked += 1
        for n in names:
            if _inside(t, starts[n], spans[n]):
                work[n].append((e.start_ns, e.end_ns))
    if not linked:
        return None
    return {'seconds': {n: union_ns(w) / 1e9 if w else None
                        for n, w in work.items()},
            'linked': linked, 'unlinked': unlinked}
