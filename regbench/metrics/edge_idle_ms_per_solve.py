"""Device-idle milliseconds per registration of the traced window's gaps
that open outside every ``gn.step``: the images copied in, scoring, the
caller between registrations (``regbench.spans.idle_split``)."""

from regbench import spans as S


def read(run):
    split = S.idle_split(run)
    return 1e3 * split["edge"] if split is not None else None
