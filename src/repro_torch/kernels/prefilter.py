"""Cubic B-spline prefilter as three K1 passes (port of
``repro.kernels.prefilter``).

The truncated inverse B-spline filter h_n = -6 z1^{|n|+1} / (1 - z1^2),
z1 = sqrt(3) - 2, |n| <= 7, applied along each axis with periodic wrap.
Leading dimensions are a batch: one launch per axis filters a whole stack.
"""

from __future__ import annotations

import math

import torch

from .pencil import stencil_axis

_Z1 = math.sqrt(3.0) - 2.0
RADIUS = 7

#: (c0, c1, ..., c7) — symmetric taps of the truncated inverse-B-spline filter.
PREFILTER_TAPS = tuple(
    -6.0 * _Z1 ** (n + 1) / (1.0 - _Z1 * _Z1) for n in range(RADIUS + 1)
)


def prefilter3d(f: torch.Tensor) -> torch.Tensor:
    """B-spline coefficients of ``(N1,N2,N3)`` or a stack ``(B,N1,N2,N3)``."""
    out = f
    for axis in range(3):
        out = stencil_axis(out, axis, PREFILTER_TAPS, symmetric=True, scale=1.0)
    return out
