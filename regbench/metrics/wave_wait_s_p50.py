"""Median over the window's answered requests of the seconds their wave
waited, assembled, for the solver thread: the program's ``serve.wave_wait``
span of the request's wave."""

import statistics

from regbench import spans as S


def read(run):
    spans = S.recorded()
    if spans is None:
        return None
    wait = {s.attrs["wave_id"]: (s.end_ns - s.start_ns) * 1e-9
            for s in spans if s.name == "serve.wave_wait"}
    xs = [wait[r["wave_id"]] for r in run.requests if r["wave_id"] in wait]
    return statistics.median(xs) if xs else None
