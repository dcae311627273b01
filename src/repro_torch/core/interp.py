"""Scattered-data interpolation on periodic 3D grids (port of
``repro.core.interp``).

Methods (the paper's kernel family): ``linear`` (8 taps), ``cubic_lagrange``
(64 taps on the field), ``cubic_bspline`` (64 taps on coefficients from the
15-point FIR prefilter). Query points ``q`` are ``(3, *out_shape)`` in index
units, with periodic wrap.

Two paths: plan-free ``interp_field`` (kernel K4 on the card), and plans,
``build_plan`` once per footpoint set (``build_plan_kernel``) then
``apply_plan`` (kernel K2). Each kernel takes its plain version on the CPU.
``weight_dtype`` (None or ``torch.bfloat16``) is the mixed-precision scheme
of the paper: only the basis weights are downcast, the field keeps its
dtype, accumulation is fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from .. import obs
from ..kernels import interp3d as _k
from ..kernels import plan as _kp
from ..kernels import prefilter as _pf

# ---------------------------------------------------------------------------
# B-spline prefilter: the truncated inverse filter
#   h_n = -6 z1^{|n|+1} / (1 - z1^2),  z1 = sqrt(3) - 2,  |n| <= 7,
# applied along each axis with periodic wrap (kernel K1, three passes).
# ---------------------------------------------------------------------------

_Z1 = math.sqrt(3.0) - 2.0
PREFILTER_RADIUS = 7
PREFILTER_TAPS = tuple(
    -6.0 * _Z1 ** (abs(n) + 1) / (1.0 - _Z1 * _Z1)
    for n in range(-PREFILTER_RADIUS, PREFILTER_RADIUS + 1)
)


def prefilter_fir(f: torch.Tensor) -> torch.Tensor:
    """15-point separable FIR prefilter over the trailing three axes; leading
    axes are a batch filtered in the same passes."""
    return _pf.prefilter3d(f)


def prefilter_fft(f: torch.Tensor) -> torch.Tensor:
    """Exact periodic prefilter (spectral division by the B-spline symbol)
    over the trailing three axes; the oracle of the truncated FIR."""
    shape = tuple(f.shape[-3:])
    sym = []
    for n in shape:
        k = np.fft.fftfreq(n, d=1.0 / n)
        sym.append((4.0 + 2.0 * np.cos(2.0 * np.pi * k / n)) / 6.0)
    s1 = torch.tensor(sym[0], dtype=torch.float32, device=f.device).reshape(-1, 1, 1)
    s2 = torch.tensor(sym[1], dtype=torch.float32, device=f.device).reshape(1, -1, 1)
    s3 = torch.tensor(sym[2][: shape[2] // 2 + 1], dtype=torch.float32,
                      device=f.device).reshape(1, 1, -1)
    fh = torch.fft.rfftn(f, dim=(-3, -2, -1))
    return torch.fft.irfftn(fh / (s1 * s2 * s3), s=shape, dim=(-3, -2, -1)).to(f.dtype)


def prefilter_for(f: torch.Tensor, method: str) -> torch.Tensor:
    """Interpolation coefficients for ``method`` (identity unless B-spline)."""
    if method == "cubic_bspline":
        return prefilter_fir(f)
    return f


# ---------------------------------------------------------------------------
# Basis weights (beside their kernels in ``repro_torch.kernels.interp3d``)
# ---------------------------------------------------------------------------

lagrange_weights = _k.lagrange_weights
bspline_weights = _k.bspline_weights
linear_weights = _k.linear_weights

METHODS = ("linear", "cubic_lagrange", "cubic_bspline")


# ---------------------------------------------------------------------------
# Plan-free evaluation: kernel K4 on the card, its plain version on the CPU.
# ---------------------------------------------------------------------------


def interp_linear(f: torch.Tensor, q: torch.Tensor, weight_dtype=None) -> torch.Tensor:
    return _k.interp3d(f, q, "linear", weight_dtype)


def interp_cubic_lagrange(f: torch.Tensor, q: torch.Tensor,
                          weight_dtype=None) -> torch.Tensor:
    return _k.interp3d(f, q, "cubic_lagrange", weight_dtype)


def interp_cubic_bspline(f: torch.Tensor, q: torch.Tensor, prefiltered: bool = False,
                         weight_dtype=None, prefilter: str = "fir") -> torch.Tensor:
    if not prefiltered:
        f = prefilter_fir(f) if prefilter == "fir" else prefilter_fft(f)
    return _k.interp3d(f, q, "cubic_bspline", weight_dtype)


def interp_field(f: torch.Tensor, q: torch.Tensor, method: str = "cubic_bspline",
                 prefiltered: bool = False, weight_dtype=None) -> torch.Tensor:
    """Interpolate ``f`` ``(..., N1, N2, N3)`` at index-unit query points
    ``q`` ``(3, *out_shape)``; ``prefiltered`` marks B-spline coefficients.
    ``weight_dtype`` (None or ``torch.bfloat16``) rounds the weights only."""
    if method == "linear":
        return interp_linear(f, q, weight_dtype)
    if method == "cubic_lagrange":
        return interp_cubic_lagrange(f, q, weight_dtype)
    if method == "cubic_bspline":
        return interp_cubic_bspline(f, q, prefiltered, weight_dtype)
    raise ValueError(f"unknown interpolation method: {method}")


# ---------------------------------------------------------------------------
# Plans: build once per footpoint set, apply many times.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class InterpPlan:
    """Precomputed tensor-product interpolation plan.

    idx     : three int32 tensors (support, *out_shape) — per-axis flat index
              contributions, periodic wrap and row strides baked in (idx[0]
              premultiplied by N2*N3, idx[1] by N3).
    weights : three tensors (support, *out_shape) — per-axis basis weights.
    """

    idx: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    weights: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    method: str
    field_shape: Tuple[int, int, int]

    @property
    def support(self) -> int:
        return _k.BASES[self.method].support

    @property
    def out_shape(self):
        return tuple(self.idx[0].shape[1:])


def build_plan(q: torch.Tensor, method: str = "cubic_bspline", weight_dtype=None,
               shape=None, wrap=(True, True, True)) -> InterpPlan:
    """Build an :class:`InterpPlan` for query points ``q`` (index units).

    ``shape`` is the source-field shape (default ``q.shape[1:]``). ``wrap``
    selects per axis a periodic index wrap (floor-mod) or, where False, a
    clamp into the field: the slab-parallel solve's x1 axis is a
    halo-extended, non-periodic slab. K2 and K3 take either plan unchanged,
    since the wrap or clamp is baked into the flat indices. ``weight_dtype``
    downcasts the weights only (fp32 when None). One kernel on the card
    (``kernels/plan.py``), its plain version on the CPU.
    """
    shape = tuple(int(n) for n in (shape if shape is not None else q.shape[1:]))
    with obs.span("plan.build"):
        idx, w = _kp.build_plan(q, method, weight_dtype, shape, wrap)
        return InterpPlan(idx, w, method, shape)


def apply_plan(plan: InterpPlan, coef: torch.Tensor) -> torch.Tensor:
    """Evaluate ``coef`` ``(..., N1, N2, N3)`` through a prebuilt plan (fp32
    accumulation; kernel K2 on the card, its plain version on the CPU).
    Returns ``coef.shape[:-3] + plan.out_shape`` in float32."""
    return _k.apply_plan(coef, plan)


def interp_vector(w: torch.Tensor, q: torch.Tensor, method: str = "cubic_bspline",
                  prefiltered: bool = False, weight_dtype=None) -> torch.Tensor:
    """Interpolate a vector field through one shared plan; output
    ``(3, *q.shape[1:])``."""
    coef = w if prefiltered else prefilter_for(w, method)
    plan = build_plan(q, method=method, weight_dtype=weight_dtype, shape=w.shape[-3:])
    return apply_plan(plan, coef)
