"""Counted least work of every interpolation pass of the window's
registrations (coordinates read once per pass, each field read once and
written once) over the device time of the kernels ``layers/interp/``
names, in % of the bound."""

from regbench import counts


def read(run):
    if run.trace is None or not run.solves:
        return None
    t = run.trace.seconds(run.layers["interp"]["kernels"])
    if t <= 0:
        return None
    work = counts.Work()
    for s in run.solves:
        work = work + counts.registration(run.grid, run.nt, s["evals"], s["matvecs"],
                                          s["ls"])["interp"]
    return 100.0 * work.bound_s() / t
