"""Mean device milliseconds of one PCG Hessian matvec: the device intervals
of the program's ``pcg.matvec`` spans."""

from regbench import spans as S


def read(run):
    spans = S.recorded()
    ms = S.device_ms(spans, "pcg.matvec") if spans is not None else []
    return sum(ms) / len(ms) if ms else None
