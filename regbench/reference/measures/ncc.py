"""Squared normalised cross-correlation of the zero-mean images f = P mf and
g = P m1 (P subtracts the domain mean): D = 1 - a^2 / (b c) with a = <f, g>,
b = ||f||^2, c = ||g||^2.

lambda(1) = -dD/dmf = (2a / (bc)) (g - (a / b) f); the Gauss-Newton part of
its Hessian keeps the term of d(a^2 / (bc)) that is quadratic in da:
H u = (2 a^2 / (b^2 c)) (Pu - (<g, Pu> / c) g), and lt(1) = -H mt(1).
"""

import torch

from .. import claire as C

EPS = 1e-12


def _zero_mean(f):
    return f - torch.mean(f)


def _moments(mf, m1):
    f, g = _zero_mean(mf), _zero_mean(m1)
    a = C.inner(f, g)
    return f, g, a, torch.clamp(C.inner(f, f), min=EPS), torch.clamp(C.inner(g, g), min=EPS)


def value(mf, m1):
    _, _, a, b, c = _moments(mf, m1)
    return 1.0 - a * a / (b * c)


def terminal(mf, m1):
    f, g, a, b, c = _moments(mf, m1)
    return (2.0 * a / (b * c)) * (g - (a / b) * f)


def gn_terminal(mt1, mf, m1):
    _, g, a, b, c = _moments(mf, m1)
    u = _zero_mean(mt1)
    return -(2.0 * a * a / (b * b * c)) * (u - (C.inner(g, u) / c) * g)
