"""Reduced gradient (3): g(v) = beta*A v + int_0^1 lambda grad(m) dt (port of
``repro.core.gradient``)."""

from __future__ import annotations

import dataclasses

import torch

from . import derivatives as _deriv
from . import measures as _meas
from . import spectral as _spec
from . import transport as _tr


@dataclasses.dataclass
class GradientState:
    """Everything computed while evaluating g(v) that later stages reuse:
    the per-Newton-step invariants (plans, trajectory gradients, div v)
    consumed by every PCG Hessian matvec at this iterate."""

    g: torch.Tensor            # reduced gradient (3, N1,N2,N3)
    m_traj: torch.Tensor       # state trajectory (nt+1, N1,N2,N3)
    lam_traj: torch.Tensor     # adjoint trajectory (nt+1, N1,N2,N3)
    foot_fwd: torch.Tensor     # footpoints for forward solves
    foot_adj: torch.Tensor     # footpoints for backward solves
    divv: torch.Tensor         # div v
    j_mismatch: torch.Tensor
    j_reg: torch.Tensor
    plan_fwd: object = None    # InterpPlan for forward solves
    plan_adj: object = None    # InterpPlan for backward solves
    grad_m_traj: object = None  # (nt+1, 3, N1,N2,N3) cached grad(m_traj)
    measure_cache: object = None


def evaluate(m0: torch.Tensor, m1: torch.Tensor, v: torch.Tensor, beta: float,
             gamma: float, cfg: _tr.TransportConfig) -> GradientState:
    foot_fwd = _tr.footpoints(v, cfg, sign=1.0)
    foot_adj = _tr.footpoints(v, cfg, sign=-1.0)
    divv = _deriv.div(v, scheme=cfg.deriv)
    plan_fwd = _tr.interp_plan(foot_fwd, cfg)
    plan_adj = _tr.interp_plan(foot_adj, cfg)

    m_traj = _tr.solve_state(m0, v, cfg, foot=foot_fwd, plan=plan_fwd)
    meas = _meas.resolve(cfg.measure)
    m_final = m_traj[-1]
    lam1 = meas.terminal_adjoint(m_final, m1, cfg)
    lam_traj = _tr.solve_adjoint(lam1, v, cfg, foot_adj=foot_adj, divv=divv,
                                 plan_adj=plan_adj)

    grad_m_traj = _tr.grad_traj(m_traj, cfg)
    body = _tr.body_force(lam_traj, m_traj, cfg, grad_m_traj=grad_m_traj)
    g = _spec.apply_regop(v, beta, gamma) + body

    return GradientState(
        g=g,
        m_traj=m_traj,
        lam_traj=lam_traj,
        foot_fwd=foot_fwd,
        foot_adj=foot_adj,
        divv=divv,
        j_mismatch=meas.value(m_final, m1, cfg),
        j_reg=_spec.reg_energy(v, beta, gamma),
        plan_fwd=plan_fwd,
        plan_adj=plan_adj,
        grad_m_traj=grad_m_traj,
        measure_cache=meas.make_cache(m_final, m1, cfg),
    )
