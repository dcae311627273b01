"""Gauss-Newton Hessian matvec (port of ``repro.core.hessian``):

    H vt = beta*A vt + int_0^1 lt grad(m) dt,

with the incremental state  d mt/dt + v.grad mt + vt.grad m = 0, mt(0) = 0,
and the incremental adjoint  -d lt/dt - div(lt v) = 0, lt(1) = -H_D mt(1).

The matvec reuses the per-Newton-step invariants of ``GradientState``;
without plans (``use_plan=False``) the transports interpolate at the stored
footpoints (K4) and recompute the trajectory gradients. With
``cfg.use_fused_matvec`` the two transports run through kernel K3
(``kernels.interp3d.apply_plan_fused``): each step gathers the stacked
[field, source] coefficients through the plan and applies the RK2 update in
the same kernel. The two contractions over the trajectory gradients
(einsums in JAX, left to XLA), the incremental state's sources and the
trapezoid body force with ``beta A vt`` added, run through the kernel pair
of ``kernels.contract`` on every path. With ``cfg.shard`` the plans live in
the halo-extended slab's frame, so the fused path gathers from
halo-extended coefficients (K3 on the slab path); the contractions are
pointwise and take the slab's own fields.
"""

from __future__ import annotations

import torch

from ..distributed import halo as _halo
from ..kernels import contract as _ct
from ..kernels import interp3d as _k
from . import gradient as _grad
from . import interp as _interp
from . import measures as _meas
from . import spectral as _spec
from . import transport as _tr


def _fused_coefficients(stack: torch.Tensor, cfg: _tr.TransportConfig) -> torch.Tensor:
    """Interpolation coefficients of a stacked field in the plan's frame
    (the halo-extended slab when sharded)."""
    if cfg.shard is not None:
        return _halo.sl_coefficients(stack, cfg.interp, cfg.shard)
    return _interp.prefilter_for(stack, cfg.interp)


def _matvec_fused(vt: torch.Tensor, gs: _grad.GradientState, v: torch.Tensor,
                  beta: float, gamma: float, cfg: _tr.TransportConfig) -> torch.Tensor:
    nt = int(cfg.nt)
    dt = 1.0 / nt
    # -vt.grad(m_j) for all time steps in one contraction (the JAX einsum
    # "c...,tc...->t...").
    sources = _ct.traj_sources(vt, gs.grad_m_traj)

    mt = torch.zeros_like(gs.m_traj[0])
    for j in range(nt):
        coefs = _fused_coefficients(torch.stack([mt, sources[j]]), cfg)
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
        coefs = _fused_coefficients(torch.stack([lam, divv * lam]), cfg)
        lam = _k.apply_plan_fused(coefs, gs.plan_adj, divv, "inc_adjoint", dt)
        traj.append(lam)

    # beta A vt + the trapezoid body force (the JAX einsum "t,t...,tc...->c..."),
    # the adjoint fields in forward time order.
    return _ct.traj_body_force(traj[::-1], gs.grad_m_traj, dt,
                               a=_spec.apply_regop(vt, beta, gamma, shard=cfg.shard))


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
    return _tr.body_force(lt_traj, gs.m_traj, cfg, grad_m_traj=gs.grad_m_traj,
                          regop=lambda: _spec.apply_regop(vt, beta, gamma, shard=cfg.shard))
