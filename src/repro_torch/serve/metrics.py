"""Serve-side instrumentation: per-request latency, per-wave utilization
(port of ``repro.serve.metrics``, plain Python).

The server records one dict per completed request and one per executed wave;
:meth:`ServeStats.summary` reduces them to the SLO numbers the benchmarks
persist (p50/p99 latency, pairs/sec, mean wave utilization, warm-vs-cold
Newton iteration counts). Thread-safe: the batcher, solver and collector
threads all append under one lock.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Linear-interpolated percentile (numpy-free so the hot path stays
    dependency-light); ``q`` in [0, 100]. None for an empty sample."""
    xs = sorted(float(v) for v in values)
    if not xs:
        return None
    if len(xs) == 1:
        return xs[0]
    pos = (q / 100.0) * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


def _mean(xs: Sequence[float]) -> Optional[float]:
    xs = list(xs)
    return (sum(xs) / len(xs)) if xs else None


class ServeStats:
    """Counters + raw per-request / per-wave records."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests: List[Dict] = []
        self.waves: List[Dict] = []
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.warm_hits = 0
        self.t_first_submit: Optional[float] = None
        self.t_last_done: Optional[float] = None

    def record_submit(self, t: float):
        with self._lock:
            self.submitted += 1
            if self.t_first_submit is None or t < self.t_first_submit:
                self.t_first_submit = t

    def record_request(self, rec: Dict, t_done: float):
        with self._lock:
            self.requests.append(rec)
            self.completed += 1
            if rec.get("warm_started"):
                self.warm_hits += 1
            if self.t_last_done is None or t_done > self.t_last_done:
                self.t_last_done = t_done

    def record_failure(self, n: int = 1):
        with self._lock:
            self.failed += n

    def record_wave(self, rec: Dict):
        with self._lock:
            self.waves.append(rec)

    def summary(self) -> Dict:
        """SLO reduction of everything recorded so far."""
        with self._lock:
            reqs = list(self.requests)
            waves = list(self.waves)
            submitted, completed, failed = (self.submitted, self.completed,
                                            self.failed)
            warm_hits = self.warm_hits
            span = None
            if self.t_first_submit is not None and self.t_last_done is not None:
                span = max(self.t_last_done - self.t_first_submit, 1e-9)
        lat = [r["latency_s"] for r in reqs]
        warm_iters = [r["iters"] for r in reqs if r.get("warm_started")]
        cold_iters = [r["iters"] for r in reqs if not r.get("warm_started")]
        return dict(
            submitted=submitted,
            completed=completed,
            failed=failed,
            warm_hits=warm_hits,
            waves=len(waves),
            latency_p50_s=percentile(lat, 50),
            latency_p99_s=percentile(lat, 99),
            latency_mean_s=_mean(lat),
            queue_mean_s=_mean([r["queue_s"] for r in reqs]),
            solve_mean_s=_mean([r["solve_s"] for r in reqs]),
            pairs_per_sec=(completed / span) if span else None,
            utilization_mean=_mean([w["utilization"] for w in waves]),
            wave_real_mean=_mean([w["real"] for w in waves]),
            iters_mean_warm=_mean(warm_iters),
            iters_mean_cold=_mean(cold_iters),
        )
