"""Device milliseconds per registration of the gradient evaluations (state
and adjoint transport, body force): the program's ``gn.gradient`` spans."""

from regbench import spans as S


def read(run):
    return S.device_ms_per_solve("gn.gradient")
