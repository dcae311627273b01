"""The program's own spans: where a registration or a server wave spends its
time, stamped on the clock of ``torch.profiler``'s trace.

    with obs.span("pcg.matvec"):
        hp = matvec(p)
    keep_going = obs.sync(bool, residual > tol)       # a host.sync span
    obs.interval("serve.wave_wait", t_put, t_get, wave_id=7)

``span(name, **attrs)`` times a block; ``interval(name, t0, t1, **attrs)``
records a wait whose two ends were read on different threads, as
``time.perf_counter()`` seconds; ``sync(fn, x)`` returns ``fn(x)``, a read of
device values to the host, timed as a ``host.sync`` span. ``spans()`` returns
the records, ``clear()`` empties them, ``dropped()`` counts the records
refused past ``CAP``.

The recorder is on only while a ``torch.profiler`` session runs in the
process (the profiler's process-wide flag): a traced run records, an untraced
one does not, and off a span costs one flag read. Kineto traces host ranges
only on the thread that started its session; these records come from every
thread (the server's three among them), each with its thread's name and the
id of the span open around it on that thread. Stamps are nanoseconds on the
Unix clock, the one kineto stamps its events with: ``perf_counter`` readings
moved by the offset between the two clocks, read once at import. On, a span also enters
``torch.profiler.record_function(name)``, so a chrome trace of the traced
thread shows it, and where CUDA is initialised it records a CUDA event on
the current stream at each end: ``device_ms``, the stream's time from the
first to the second, resolved in ``spans()`` and never on the hot path.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

#: the most records kept; later ones are counted in ``dropped()``
CAP = 1 << 17


@dataclasses.dataclass
class Span:
    name: str
    id: int
    parent: Optional[int]          # the span open around it on its thread
    thread: str
    start_ns: int                  # Unix clock, as kineto's events
    end_ns: int
    attrs: Dict[str, Any]
    device_ms: Optional[float] = None
    _events: Any = dataclasses.field(default=None, repr=False, compare=False)


_records: List[Span] = []
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> List[int]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _event():
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _offset_ns() -> int:
    """Unix clock minus ``perf_counter``, from the closest-bracketed of a
    few readings (a thread switch between two reads would skew one)."""
    best = None
    for _ in range(5):
        a = time.time_ns()
        p = time.perf_counter_ns()
        b = time.time_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2 - p)
    return best[1]


#: one offset for the process, so that equal readings stamp equal times
_OFFSET_NS = _offset_ns()


def _keep(name: str, sid: int, parent: Optional[int], t0_ns: int, t1_ns: int,
          attrs: Dict[str, Any], events=None) -> None:
    global _dropped
    rec = Span(name, sid, parent, threading.current_thread().name, t0_ns + _OFFSET_NS,
               t1_ns + _OFFSET_NS, attrs, _events=events)
    with _lock:
        if len(_records) < CAP:
            _records.append(rec)
        else:
            _dropped += 1


class _Open:
    """A span being timed (the recorder on)."""

    __slots__ = ("name", "attrs", "id", "parent", "t0", "rf", "ev0")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.ev0 = _event()
        self.rf = torch.profiler.record_function(self.name)
        self.t0 = time.perf_counter_ns()
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        t1 = time.perf_counter_ns()
        ev1 = _event() if self.ev0 is not None else None
        _stack().pop()
        _keep(self.name, self.id, self.parent, self.t0, t1, self.attrs,
              (self.ev0, ev1) if ev1 is not None else None)
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, **attrs):
    """A context manager timing its block as the span ``name``."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, attrs)


def sync(fn: Callable[[Any], Any], x):
    """``fn(x)``, a read of device values to the host (``bool``, ``float``,
    a ``.cpu()`` copy), timed as a ``host.sync`` span; the value read is
    returned unchanged."""
    if not _profiler._is_profiler_enabled:
        return fn(x)
    with _Open("host.sync", {}):
        return fn(x)


def interval(name: str, t0: float, t1: float, **attrs) -> None:
    """Record ``name`` from ``t0`` to ``t1``, ``time.perf_counter()``
    seconds read by the caller (on any threads), without a device interval."""
    if not _profiler._is_profiler_enabled:
        return
    stack = _stack()
    _keep(name, next(_ids), stack[-1] if stack else None, round(t0 * 1e9),
          round(t1 * 1e9), attrs)


def spans() -> List[Span]:
    """The records so far, in the order they closed, device intervals
    resolved (each waits for its second event)."""
    with _lock:
        out = list(_records)
    for s in out:
        if s._events is not None:
            e0, e1 = s._events
            e1.synchronize()
            s.device_ms = e0.elapsed_time(e1)
            s._events = None
    return out


def dropped() -> int:
    """Records refused because ``CAP`` were kept."""
    return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0
