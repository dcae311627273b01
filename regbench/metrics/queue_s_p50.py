"""Median seconds the window's answered requests waited from submit to
their wave's dispatch (``RequestResult.queue_s``)."""

import statistics


def read(run):
    if not run.requests:
        return None
    return statistics.median(r["queue_s"] for r in run.requests)
