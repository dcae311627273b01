"""Interpolation on periodic 3D grids through prebuilt plans (port of
``repro.core.interp``).

Methods (the paper's kernel family): ``linear`` (8 taps), ``cubic_lagrange``
(64 taps on the field), ``cubic_bspline`` (64 taps on coefficients from the
15-point FIR prefilter). Query points ``q`` are ``(3, *out_shape)`` in index
units; periodic wrap is baked into the plan.

Only the plan path is ported: ``build_plan`` once per footpoint set, then
``apply_plan`` (kernel K2 on the card, its plain version on the CPU). The
plan-free ``interp_field`` family is queued with its kernel (ROADMAP B4).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..kernels import interp3d as _k
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


def prefilter_for(f: torch.Tensor, method: str) -> torch.Tensor:
    """Interpolation coefficients for ``method`` (identity unless B-spline)."""
    if method == "cubic_bspline":
        return prefilter_fir(f)
    return f


# ---------------------------------------------------------------------------
# Basis weights
# ---------------------------------------------------------------------------


def lagrange_weights(t: torch.Tensor):
    """Cubic Lagrange basis at nodes {-1, 0, 1, 2} evaluated at t in [0,1)."""
    w0 = -t * (t - 1.0) * (t - 2.0) / 6.0
    w1 = (t + 1.0) * (t - 1.0) * (t - 2.0) / 2.0
    w2 = -(t + 1.0) * t * (t - 2.0) / 2.0
    w3 = (t + 1.0) * t * (t - 1.0) / 6.0
    return (w0, w1, w2, w3)


def bspline_weights(t: torch.Tensor):
    """Uniform cubic B-spline basis at offsets {-1, 0, 1, 2} for t in [0,1)."""
    t2 = t * t
    t3 = t2 * t
    w0 = (1.0 - 3.0 * t + 3.0 * t2 - t3) / 6.0
    w1 = (4.0 - 6.0 * t2 + 3.0 * t3) / 6.0
    w2 = (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) / 6.0
    w3 = t3 / 6.0
    return (w0, w1, w2, w3)


def linear_weights(t: torch.Tensor):
    return (1.0 - t, t)


#: method -> (weight_fn, taps per axis, base index offset from floor(q))
_METHOD_TABLE = {
    "linear": (linear_weights, 2, 0),
    "cubic_lagrange": (lagrange_weights, 4, -1),
    "cubic_bspline": (bspline_weights, 4, -1),
}

METHODS = ("linear", "cubic_lagrange", "cubic_bspline")


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
        return _METHOD_TABLE[self.method][1]

    @property
    def out_shape(self):
        return tuple(self.idx[0].shape[1:])


def build_plan(q: torch.Tensor, method: str = "cubic_bspline",
               shape=None) -> InterpPlan:
    """Build an :class:`InterpPlan` for query points ``q`` (index units).

    ``shape`` is the source-field shape (default ``q.shape[1:]``). Indices
    wrap periodically with floor-mod; weights are fp32 (the JAX package's
    ``weight_dtype`` downcast is ROADMAP A11).
    """
    if method not in _METHOD_TABLE:
        raise ValueError(f"unknown interpolation method: {method}")
    weight_fn, support, base_offset = _METHOD_TABLE[method]
    shape = tuple(int(n) for n in (shape if shape is not None else q.shape[1:]))
    n1, n2, n3 = shape
    qf = torch.floor(q)
    t = q - qf
    # Footpoints are negative near the low edge: floor, then floor-mod.
    base = qf.to(torch.int32) + base_offset
    tap = torch.arange(support, dtype=torch.int32, device=q.device).reshape(
        (support,) + (1,) * (q.dim() - 1))

    def _tap_idx(b, n):
        return torch.remainder(b[None] + tap, n)

    idx1 = _tap_idx(base[0], n1) * (n2 * n3)
    idx2 = _tap_idx(base[1], n2) * n3
    idx3 = _tap_idx(base[2], n3)
    w = tuple(torch.stack(weight_fn(t[a]), dim=0) for a in range(3))
    return InterpPlan((idx1, idx2, idx3), w, method, shape)


def apply_plan(plan: InterpPlan, coef: torch.Tensor) -> torch.Tensor:
    """Evaluate ``coef`` ``(..., N1, N2, N3)`` through a prebuilt plan (fp32
    accumulation; kernel K2 on the card, its plain version on the CPU).
    Returns ``coef.shape[:-3] + plan.out_shape`` in float32."""
    return _k.apply_plan(coef, plan)


def interp_vector(w: torch.Tensor, q: torch.Tensor, method: str = "cubic_bspline",
                  prefiltered: bool = False) -> torch.Tensor:
    """Interpolate a vector field through one shared plan; output
    ``(3, *q.shape[1:])``."""
    coef = w if prefiltered else prefilter_for(w, method)
    plan = build_plan(q, method=method, shape=w.shape[-3:])
    return apply_plan(plan, coef)
