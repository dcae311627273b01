"""Counted least work of the FD8 derivatives and the B-spline prefilters of
the window's registrations (each operation's input read once, output
written once) over the device time of the kernels ``layers/fd8/`` and
``layers/prefilter/`` name, in % of the bound. Nothing is read when either
kind's kernels do not appear in the trace: that kind's work is then done by
kernels the layer does not name, and a share without it would mislead."""

from regbench import counts


def read(run):
    if run.trace is None or not run.solves:
        return None
    kinds = ("fd8", "prefilter")
    if not all(run.trace.matched(run.layers[k]["kernels"]) for k in kinds):
        return None
    t = sum(run.trace.seconds(run.layers[k]["kernels"]) for k in kinds)
    work = counts.Work()
    for s in run.solves:
        w = counts.registration(run.grid, run.nt, s["evals"], s["matvecs"], s["ls"])
        work = work + w["fd8"] + w["prefilter"]
    return 100.0 * work.bound_s() / t
