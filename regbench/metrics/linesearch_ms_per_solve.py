"""Device milliseconds per registration of the Armijo line searches, from
the first trial objective to the chosen step: the program's
``gn.line_search`` spans."""

from regbench import spans as S


def read(run):
    return S.device_ms_per_solve("gn.line_search")
