"""Semi-Lagrangian machinery (port of ``repro.core.semilag``): backward
characteristic tracing (RK2) and the transport steps used by the four PDE
solves.

The JAX ``backend=`` switch is gone: the B-spline prefilter (K1), the plan
gather (K2) and plan-free interpolation (K4) dispatch on the device of their
input. A step with a ``plan`` gathers through it; without one it
interpolates at the footpoints (``use_plan=False``). With ``shard``
(slab-parallel solve) every step is slab-local and goes through a halo plan
(``repro_torch.distributed.halo``), built here when none is given, as in JAX.
"""

from __future__ import annotations

import torch

from ..distributed import halo as _halo
from . import grid as _grid
from . import interp as _interp

#: The Pallas halo-tile interpolation kernel's static CFL bound (voxels),
#: ``repro.core.semilag.PALLAS_DISPLACEMENT_BOUND``: per-step footpoint
#: displacement |q - x| stays below it in the solver's regime. K4 wraps
#: globally and needs no such bound; the value is kept to state the regime.
DISPLACEMENT_BOUND = 6


def build_plan(foot: torch.Tensor, method: str, weight_dtype=None,
               shape=None) -> _interp.InterpPlan:
    """Interpolation plan for footpoints ``foot`` (built once per velocity
    iterate, reused by every SL step and Hessian matvec)."""
    return _interp.build_plan(foot, method=method, weight_dtype=weight_dtype,
                              shape=shape)


def trace_characteristic(v: torch.Tensor, dt: float, method: str = "cubic_bspline",
                         sign: float = 1.0, weight_dtype=None, shard=None) -> torch.Tensor:
    """RK2 (midpoint) backward trace  X(x) = x - sign*dt*v(x - sign*(dt/2)*v(x)),
    returned in index units, shape (3, N1, N2, N3). The midpoint velocity is
    gathered through a plan whatever ``use_plan`` says, as in JAX. With
    ``shard``, ``v`` is an x1 slab and the footpoints are global coordinates
    of the local grid points."""
    if shard is not None:
        return _halo.trace_characteristic(v, dt, method, sign, weight_dtype, shard)
    shape = tuple(v.shape[-3:])
    h = torch.tensor(_grid.spacing(shape), dtype=v.dtype,
                     device=v.device).reshape(3, 1, 1, 1)
    x_idx = _grid.index_coords(shape, dtype=v.dtype, device=v.device)
    q_mid = x_idx - sign * (0.5 * dt) * v / h
    v_coef = _interp.prefilter_for(v, method)
    plan_mid = build_plan(q_mid, method, weight_dtype, shape=shape)
    v_mid = _interp.apply_plan(plan_mid, v_coef)
    return x_idx - sign * dt * v_mid / h


def sl_step(f: torch.Tensor, foot: torch.Tensor, method: str = "cubic_bspline",
            weight_dtype=None, plan: _interp.InterpPlan | None = None,
            shard=None) -> torch.Tensor:
    """One SL advection step f_new(x) = f(X(x)): through ``plan`` when given
    (its weight dtype is baked in), else interpolated at ``foot``. ``f`` may
    be a stack ``(K, N1, N2, N3)``: one prefilter and one gather for all."""
    if shard is not None:
        if plan is None:
            plan = _halo.build_plan(foot, method, weight_dtype, shard)
        return _halo.apply_plan(plan, f, method, shard)
    coef = _interp.prefilter_for(f, method)
    if plan is not None:
        return _interp.apply_plan(plan, coef)
    return _interp.interp_field(coef, foot, method, prefiltered=True,
                                weight_dtype=weight_dtype)


def sl_step_many(fs: torch.Tensor, foot: torch.Tensor, method: str = "cubic_bspline",
                 weight_dtype=None, plan: _interp.InterpPlan | None = None,
                 shard=None) -> torch.Tensor:
    """Advect stacked fields ``(K, N1, N2, N3)`` in one prefilter + gather;
    without a plan the K fields share one K4 launch (they share ``foot``)."""
    return sl_step(fs, foot, method, weight_dtype, plan=plan, shard=shard)


def sl_step_with_source(f: torch.Tensor, source_t0: torch.Tensor,
                        source_coeff_t1: torch.Tensor, foot: torch.Tensor,
                        dt: float, method: str = "cubic_bspline", weight_dtype=None,
                        plan: _interp.InterpPlan | None = None,
                        shard=None) -> torch.Tensor:
    """SL step for d f/dt = s along characteristics (Heun / RK2):
    f_adv = f(X), k1 = s_t0(X), k2 = c * (f_adv + dt*k1),
    f_new = f_adv + dt/2 * (k1 + k2)."""
    f_adv, k1 = sl_step_many(torch.stack([f, source_t0]), foot, method,
                             weight_dtype, plan=plan, shard=shard)
    f_pred = f_adv + dt * k1
    k2 = source_coeff_t1 * f_pred
    return f_adv + 0.5 * dt * (k1 + k2)
