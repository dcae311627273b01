"""Semi-Lagrangian machinery (port of ``repro.core.semilag``, plan path):
backward characteristic tracing (RK2) and the transport steps used by the
four PDE solves.

The JAX ``backend=`` switch is gone: the B-spline prefilter (K1) and the plan
gather (K2) dispatch on the device of their input. Plan-free steps (the
``use_plan=False`` path of the JAX package) are queued with their kernel
(ROADMAP B4) and raise here.
"""

from __future__ import annotations

import torch

from . import grid as _grid
from . import interp as _interp


def _require_plan(plan) -> _interp.InterpPlan:
    if plan is None:
        raise NotImplementedError(
            "plan-free semi-Lagrangian steps (use_plan=False) are not ported "
            "yet (ROADMAP B4); pass a plan")
    return plan


def build_plan(foot: torch.Tensor, method: str, shape=None) -> _interp.InterpPlan:
    """Interpolation plan for footpoints ``foot`` (built once per velocity
    iterate, reused by every SL step and Hessian matvec)."""
    return _interp.build_plan(foot, method=method, shape=shape)


def trace_characteristic(v: torch.Tensor, dt: float, method: str = "cubic_bspline",
                         sign: float = 1.0) -> torch.Tensor:
    """RK2 (midpoint) backward trace  X(x) = x - sign*dt*v(x - sign*(dt/2)*v(x)),
    returned in index units, shape (3, N1, N2, N3)."""
    shape = tuple(v.shape[-3:])
    h = torch.tensor(_grid.spacing(shape), dtype=v.dtype,
                     device=v.device).reshape(3, 1, 1, 1)
    x_idx = _grid.index_coords(shape, dtype=v.dtype, device=v.device)
    q_mid = x_idx - sign * (0.5 * dt) * v / h
    v_coef = _interp.prefilter_for(v, method)
    plan_mid = build_plan(q_mid, method, shape=shape)
    v_mid = _interp.apply_plan(plan_mid, v_coef)
    return x_idx - sign * dt * v_mid / h


def sl_step(f: torch.Tensor, foot: torch.Tensor, method: str = "cubic_bspline",
            plan: _interp.InterpPlan | None = None) -> torch.Tensor:
    """One SL advection step f_new(x) = f(X(x)) through the plan of ``foot``."""
    plan = _require_plan(plan)
    return _interp.apply_plan(plan, _interp.prefilter_for(f, method))


def sl_step_many(fs: torch.Tensor, foot: torch.Tensor, method: str = "cubic_bspline",
                 plan: _interp.InterpPlan | None = None) -> torch.Tensor:
    """Advect stacked fields ``(K, N1, N2, N3)`` in one prefilter + gather."""
    return sl_step(fs, foot, method, plan=plan)


def sl_step_with_source(f: torch.Tensor, source_t0: torch.Tensor,
                        source_coeff_t1: torch.Tensor, foot: torch.Tensor,
                        dt: float, method: str = "cubic_bspline",
                        plan: _interp.InterpPlan | None = None) -> torch.Tensor:
    """SL step for d f/dt = s along characteristics (Heun / RK2):
    f_adv = f(X), k1 = s_t0(X), k2 = c * (f_adv + dt*k1),
    f_new = f_adv + dt/2 * (k1 + k2)."""
    f_adv, k1 = sl_step_many(torch.stack([f, source_t0]), foot, method, plan=plan)
    f_pred = f_adv + dt * k1
    k2 = source_coeff_t1 * f_pred
    return f_adv + 0.5 * dt * (k1 + k2)
