"""The program's own spans of the traced window (``repro_torch.obs``), for
the readers of ``metrics/``.

The program records spans only while ``torch.profiler`` runs in its
process, which is the traced window alone, so every record belongs to it.
A record has a ``name``, its ``thread``, ``start_ns`` / ``end_ns`` on the
trace's clock, ``attrs`` and, on the card, ``device_ms``: the stream's time
between the span's two ends. A program without the recorder, a window that
recorded nothing and one whose recorder dropped any span read as None, and
so does every metric built on them.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple


def recorded() -> Optional[list]:
    try:
        from repro_torch import obs
    except ImportError:
        return None
    if obs.dropped():
        return None
    return obs.spans() or None


def solves(spans) -> int:
    """Registrations: ``register``, the root span of each."""
    return sum(s.name == "register" for s in spans)


def device_ms(spans, name: str) -> List[float]:
    return [s.device_ms for s in spans if s.name == name and s.device_ms is not None]


def device_ms_per_solve(name: str) -> Optional[float]:
    """Device milliseconds of the spans ``name`` per registration."""
    spans = recorded()
    if spans is None or not solves(spans):
        return None
    ms = device_ms(spans, name)
    return sum(ms) / solves(spans) if ms else None


def _seconds(s) -> Tuple[float, float]:
    return s.start_ns * 1e-9, s.end_ns * 1e-9


def _union(intervals: Sequence[Tuple[float, float]]):
    """Sorted disjoint (starts, ends) covering the intervals."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [a for a, _ in merged], [b for _, b in merged]


def _inside(union, t: float) -> bool:
    starts, ends = union
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ends[i]


def idle_split(run) -> Optional[Dict[str, float]]:
    """The device-idle seconds per registration of the trace's gaps, by what
    the host was doing on the solving thread when each gap opened: ``sync``
    inside a ``host.sync`` within a ``gn.step`` (the Newton loop's own reads),
    ``rest`` elsewhere inside a ``gn.step``, ``edge`` outside every
    ``gn.step`` (the images copied in, scoring, the caller). ``edge`` also
    takes the window's idle before its first and after its last device
    operation, where the caller starts the first registration's copies and
    waits on the last one's scoring, so the three add up to the window's
    idle."""
    spans = recorded()
    if run.trace is None or spans is None or not solves(spans):
        return None
    steps = defaultdict(list)
    for s in spans:
        if s.name == "gn.step":
            steps[s.thread].append(_seconds(s))
    per_thread = {th: _union(iv) for th, iv in steps.items()}
    in_steps = _union([iv for ivs in steps.values() for iv in ivs])
    syncs = _union([_seconds(s) for s in spans if s.name == "host.sync"
                    and s.thread in per_thread and _inside(per_thread[s.thread],
                                                           s.start_ns * 1e-9)])
    out = dict(sync=0.0, rest=0.0, edge=0.0)
    for a, b in run.trace.gaps:
        key = "sync" if _inside(syncs, a) else "rest" if _inside(in_steps, a) else "edge"
        out[key] += b - a
    ends = run.trace.window_s - run.trace.busy_s - sum(b - a for a, b in run.trace.gaps)
    out["edge"] += max(ends, 0.0)
    return {k: v / solves(spans) for k, v in out.items()}
