"""Device-idle milliseconds per registration of the traced window's gaps
that open while the Newton loop waits on one of its own reads: a
``host.sync`` span inside a ``gn.step`` (``regbench.spans.idle_split``)."""

from regbench import spans as S


def read(run):
    split = S.idle_split(run)
    return 1e3 * split["sync"] if split is not None else None
