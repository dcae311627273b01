"""Request / result records of the registration server (port of
``repro.serve.request``).

A :class:`Request` is one registration job: the fixed/moving pair plus the
per-request options the server buckets on (the grid is the image shape, the
solver variant and the distance measure are explicit). ``subject`` is the
warm-start cache key: requests tagged with the same subject start
Gauss-Newton from the prior visit's velocity field. ``m0`` and ``m1`` are
numpy arrays or tensors on either device.

A :class:`RequestResult` is what the request's future resolves to: the
velocity (a numpy array), the quality and work numbers of the solve, the
warm-start provenance, and the per-request latency breakdown (queue wait,
device solve, result materialization).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..core import measures as _meas
from ..core import registration as _reg


@dataclass(frozen=True)
class Request:
    """One registration job: transport ``m0`` (moving) onto ``m1`` (fixed)."""

    m0: Any                        # (N1, N2, N3)
    m1: Any                        # (N1, N2, N3)
    subject: Optional[str] = None  # warm-start cache key (None = never cached)
    variant: str = "fd8-cubic"     # Table-6 solver variant (a bucketing key)
    measure: str = "ssd"           # distance measure (a bucketing key)

    def __post_init__(self):
        shape0 = getattr(self.m0, "shape", None)
        shape1 = getattr(self.m1, "shape", None)
        if shape0 is None or shape1 is None or tuple(shape0) != tuple(shape1):
            raise ValueError(f"m0 {shape0} and m1 {shape1} shapes differ")
        if getattr(self.m0, "ndim", 0) != 3:
            raise ValueError(
                f"expected one (N1, N2, N3) pair per request, got {shape0}")
        if self.variant not in _reg.VARIANTS:
            raise ValueError(
                f"unknown variant {self.variant!r}; choose from "
                f"{sorted(_reg.VARIANTS)}")
        if not isinstance(self.measure, str):
            # Requests are wire-shaped records: the bucketing key stays a
            # plain string.
            raise ValueError("Request.measure must be a string name")
        _meas.resolve(self.measure)  # raises on unknown names

    @property
    def grid(self) -> Tuple[int, int, int]:
        return tuple(int(n) for n in self.m0.shape)


@dataclass
class RequestResult:
    """Resolution of one request's future."""

    request_id: int
    subject: Optional[str]
    variant: str
    grid: Tuple[int, int, int]
    v: np.ndarray                  # (3, N1, N2, N3) stationary velocity
    mismatch_rel: float            # ||m(1) - m1|| / ||m1 - m0||
    iters: int                     # accepted Newton steps
    matvecs: int                   # Hessian matvecs spent in PCG
    gnorm0: float                  # gradient norm at the starting iterate
    rel_grad: float
    converged: bool
    warm_started: bool             # v0 came from the warm-start cache
    cache_visits: int = 0          # prior visits of this subject in the cache
    # wave provenance (utilization accounting)
    wave_id: int = -1
    wave_real: int = 0             # real requests in the wave
    wave_padded: int = 0           # wave width after padding
    # latency breakdown (seconds)
    # submit -> the end of its wave's assembly; leaves out the wave's wait in
    # the solver's queue, which the span ``serve.wave_wait`` measures
    queue_s: float = 0.0
    solve_s: float = 0.0           # device solve (shared by the wave)
    collect_s: float = 0.0         # result materialization
    latency_s: float = 0.0         # submit -> future resolution

    def to_dict(self) -> Dict:
        """JSON-safe record (the velocity array is reported as its shape)."""
        d = dict(self.__dict__)
        d["v"] = list(np.asarray(self.v).shape)
        d["grid"] = list(self.grid)
        return d
