"""Device milliseconds per registration of the interpolation plan builds
(every plan: the transports', RK2's mid-point plans, the line-search
trials', scoring's): the program's ``plan.build`` spans."""

from regbench import spans as S


def read(run):
    return S.device_ms_per_solve("plan.build")
