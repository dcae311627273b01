"""Gauss-Newton Hessian matvec (port of ``repro.core.hessian``):

    H vt = beta*A vt + int_0^1 lt grad(m) dt,

with the incremental state  d mt/dt + v.grad mt + vt.grad m = 0, mt(0) = 0,
and the incremental adjoint  -d lt/dt - div(lt v) = 0, lt(1) = -H_D mt(1).

The matvec reuses the per-Newton-step invariants of ``GradientState``. With
``cfg.use_fused_matvec`` the two transports run through kernel K3
(``kernels.interp3d.apply_plan_fused``): each step gathers the stacked
[field, source] coefficients through the plan and applies the RK2 update in
the same kernel. The two contractions over the cached trajectory gradients
(einsums in JAX, left to XLA) are PyTorch broadcast products and sums.
"""

from __future__ import annotations

import torch

from ..kernels import interp3d as _k
from . import gradient as _grad
from . import interp as _interp
from . import measures as _meas
from . import spectral as _spec
from . import transport as _tr


def _matvec_fused(vt: torch.Tensor, gs: _grad.GradientState, v: torch.Tensor,
                  beta: float, gamma: float, cfg: _tr.TransportConfig) -> torch.Tensor:
    nt = int(cfg.nt)
    dt = 1.0 / nt
    # -vt.grad(m_j) for all time steps in one contraction (the JAX einsum
    # "c...,tc...->t..."). Written as a broadcast product and sum: on the card
    # torch.einsum lowers both contractions to batched cuBLAS gemv calls that
    # took ~19 ms each at 256^3 (PERF.md, PR 11).
    sources = -torch.sum(vt[None] * gs.grad_m_traj, dim=1)

    mt = torch.zeros_like(gs.m_traj[0])
    for j in range(nt):
        coefs = _interp.prefilter_for(torch.stack([mt, sources[j]]), cfg.interp)
        mt = _k.apply_plan_fused(coefs, gs.plan_fwd, sources[j + 1],
                                 "inc_state", dt)

    meas = _meas.resolve(cfg.measure)
    lt1 = meas.gn_terminal(mt, gs.m_traj[-1], None, cfg, cache=gs.measure_cache)

    # Incremental adjoint: RK2 with source (div v) * lam, the predictor
    # substituted into the epilogue.
    divv = gs.divv
    lam = lt1
    traj = [lt1]
    for j in range(nt):
        coefs = _interp.prefilter_for(torch.stack([lam, divv * lam]), cfg.interp)
        lam = _k.apply_plan_fused(coefs, gs.plan_adj, divv, "inc_adjoint", dt)
        traj.append(lam)
    lam_traj = torch.stack(traj[::-1])

    w = torch.full((nt + 1,), dt, dtype=lam_traj.dtype, device=lam_traj.device)
    w[0] = 0.5 * dt
    w[-1] = 0.5 * dt
    # Trapezoid body force, the JAX einsum "t,t...,tc...->c...".
    body = torch.sum(w.reshape(-1, 1, 1, 1, 1) * lam_traj[:, None] * gs.grad_m_traj,
                     dim=0)
    return _spec.apply_regop(vt, beta, gamma) + body


def matvec(vt: torch.Tensor, gs: _grad.GradientState, v: torch.Tensor,
           beta: float, gamma: float, cfg: _tr.TransportConfig) -> torch.Tensor:
    if (cfg.use_fused_matvec and gs.plan_fwd is not None
            and gs.plan_adj is not None and gs.grad_m_traj is not None):
        return _matvec_fused(vt, gs, v, beta, gamma, cfg)
    mt1 = _tr.solve_inc_state(vt, v, gs.m_traj, cfg, foot=gs.foot_fwd,
                              plan=gs.plan_fwd, grad_m_traj=gs.grad_m_traj)
    meas = _meas.resolve(cfg.measure)
    lt1 = meas.gn_terminal(mt1, gs.m_traj[-1], None, cfg, cache=gs.measure_cache)
    lt_traj = _tr.solve_adjoint(lt1, v, cfg, foot_adj=gs.foot_adj,
                                divv=gs.divv, plan_adj=gs.plan_adj)
    body = _tr.body_force(lt_traj, gs.m_traj, cfg, grad_m_traj=gs.grad_m_traj)
    return _spec.apply_regop(vt, beta, gamma) + body
