"""SSD: D = 0.5 ||mf - m1||^2; lambda(1) = m1 - mf; lt(1) = -mt(1)."""

from .. import claire as C


def value(mf, m1):
    r = mf - m1
    return 0.5 * C.inner(r, r)


def terminal(mf, m1):
    return m1 - mf


def gn_terminal(mt1, mf, m1):
    return -mt1
