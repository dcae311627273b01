"""Reads of device values to the host per registration (the PCG residual
tests, the Armijo tests, the driver's reads of each step, scoring's): the
program's ``host.sync`` spans counted."""

from regbench import spans as S


def read(run):
    spans = S.recorded()
    if spans is None or not S.solves(spans):
        return None
    return sum(s.name == "host.sync" for s in spans) / S.solves(spans)
