"""The window's registrations' counted least work (``regbench.counts``, at
each solve's own gradient, matvec and line-search counts) as a share of
what the H100 could do in the traced window: the larger of bytes over the
HBM bandwidth and operations over the fp32 rate, in %."""

from regbench import counts


def read(run):
    if run.trace is None or not run.solves:
        return None
    bound = sum(counts.total(counts.registration(run.grid, run.nt, s["evals"], s["matvecs"],
                                                 s["ls"])).bound_s() for s in run.solves)
    return 100.0 * bound / run.trace.window_s
