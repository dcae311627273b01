"""Request queue with grid/variant/measure bucketing and dynamic batching
(port of ``repro.serve.batching``, plain Python).

Only *compatible* requests can share a batched Newton-step wave: same grid
shape (arrays stack), same solver variant and same distance measure (one
batch step — mixed-measure streams never share a wave). The queue
keeps one FIFO bucket per :class:`BucketKey`; the batcher thread repeatedly
asks for the next wave, which is formed from the bucket whose head request
has waited longest, and dispatched as soon as it is full (``max_batch``) or
its head has waited ``max_wait_s`` — the classic dynamic-batching latency /
utilization trade.

Single-consumer by design: exactly one batcher thread calls
:meth:`next_wave` (producers are unrestricted).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, NamedTuple, Optional, Tuple

from .request import Request


class BucketKey(NamedTuple):
    grid: Tuple[int, int, int]
    variant: str
    measure: str = "ssd"


@dataclass
class PendingRequest:
    """A submitted request waiting in the queue, with its future."""
    request_id: int
    request: Request
    future: "object"               # concurrent.futures.Future
    t_submit: float                # time.perf_counter() at submit

    @property
    def key(self) -> BucketKey:
        return BucketKey(grid=self.request.grid,
                         variant=self.request.variant,
                         measure=self.request.measure)


class RequestQueue:
    def __init__(self):
        self._buckets: Dict[BucketKey, Deque[PendingRequest]] = {}
        self._cv = threading.Condition()
        self._closed = False

    def put(self, pending: PendingRequest):
        with self._cv:
            if self._closed:
                raise RuntimeError("request queue is closed")
            self._buckets.setdefault(pending.key, deque()).append(pending)
            self._cv.notify_all()

    def close(self):
        """Stop accepting; queued requests still drain through next_wave."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    @property
    def drained(self) -> bool:
        with self._cv:
            return self._closed and not self._buckets

    def depth(self) -> int:
        with self._cv:
            return sum(len(b) for b in self._buckets.values())

    def next_wave(self, max_batch: int, max_wait_s: float,
                  poll_s: float = 0.05) -> Optional[List[PendingRequest]]:
        """Block (bounded by ``poll_s`` when idle) for the next wave.

        Returns None when nothing is queued within ``poll_s`` — the caller
        re-checks its stop flag and calls again — or when closed and empty.
        """
        with self._cv:
            if not self._buckets:
                if self._closed:
                    return None
                self._cv.wait(poll_s)
                if not self._buckets:
                    return None
            # Oldest-head bucket first: FIFO fairness across buckets.
            key = min(self._buckets,
                      key=lambda k: self._buckets[k][0].t_submit)
            bucket = self._buckets[key]
            deadline = bucket[0].t_submit + max_wait_s
            # Hold the wave open for stragglers of the same bucket until it
            # is full or the head's batching window closes.
            while len(bucket) < max_batch and not self._closed:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cv.wait(min(remaining, poll_s))
            take = min(max_batch, len(bucket))
            wave = [bucket.popleft() for _ in range(take)]
            if not bucket:
                del self._buckets[key]
            return wave
