"""Transport solves: state, adjoint, incremental state, incremental adjoint
(port of ``repro.core.transport``).

All four PDEs are solved with the semi-Lagrangian scheme of ``semilag``. The
velocity is stationary, so each solve's footpoints (and, with ``use_plan``,
its interpolation plan) are built once and reused for all ``nt`` steps.
``lax.scan`` becomes a Python loop over the steps.

Shapes: scalar fields (N1,N2,N3); trajectories (nt+1, N1,N2,N3); velocities
(3, N1,N2,N3).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..distributed import halo as _halo
from ..kernels import contract as _ct
from . import derivatives as _deriv
from . import semilag as _sl


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """Numerical knobs shared by all transport solves.

    interp           : "linear" | "cubic_lagrange" | "cubic_bspline"
    deriv            : "fd8" | "fft"
    nt               : number of SL time steps (paper default 4)
    weight_dtype     : None (fp32) or torch.bfloat16: mixed-precision
                       interpolation weights (the data stays fp32)
    use_plan         : build interpolation plans once per solve / Newton step
                       (K2/K3); ``False`` interpolates at the footpoints in
                       every step (K4) and recomputes trajectory gradients
    measure          : distance-measure spec ("ssd" | "ncc" | "ngf" or a
                       ``measures.DistanceMeasure``)
    use_fused_matvec : run the PCG Hessian matvec through the fused
                       gather+epilogue kernel K3 (requires ``use_plan``)
    shard            : ``repro_torch.distributed.halo.ShardInfo`` or None.
                       When set, every solve runs on the rank's x1 slab: FD8
                       and SL interpolation exchange halos, spectral
                       operators all-gather, inner products all-reduce
                       (``repro_torch.distributed``)

    The JAX config's ``backend`` is dropped: kernels dispatch on the device
    of their tensors.
    """

    interp: str = "cubic_bspline"
    deriv: str = "fd8"
    nt: int = 4
    weight_dtype: object = None
    use_plan: bool = True
    measure: object = "ssd"
    use_fused_matvec: bool = False
    shard: object = None


def _dt(cfg: TransportConfig) -> float:
    return 1.0 / float(cfg.nt)


def footpoints(v: torch.Tensor, cfg: TransportConfig, sign: float = 1.0) -> torch.Tensor:
    """Characteristic footpoints; sign=+1 for forward solves, -1 for
    backward (adjoint) solves."""
    return _sl.trace_characteristic(v, _dt(cfg), method=cfg.interp, sign=sign,
                                    weight_dtype=cfg.weight_dtype, shard=cfg.shard)


def interp_plan(foot: torch.Tensor, cfg: TransportConfig):
    """Interpolation plan for fixed footpoints (None when plans are off);
    sharded, in the halo-extended slab's frame."""
    if not cfg.use_plan:
        return None
    if cfg.shard is not None:
        return _halo.build_plan(foot, cfg.interp, cfg.weight_dtype, cfg.shard)
    return _sl.build_plan(foot, cfg.interp, cfg.weight_dtype, shape=foot.shape[-3:])


def grad_traj(m_traj: torch.Tensor, cfg: TransportConfig) -> torch.Tensor:
    """Spatial gradients of a trajectory, shape (nt+1, 3, N1, N2, N3): one
    batched derivative per axis over the whole stack (sharded: one stacked
    halo exchange)."""
    return _deriv.grad(m_traj, scheme=cfg.deriv, shard=cfg.shard)


def solve_state(m0: torch.Tensor, v: torch.Tensor, cfg: TransportConfig,
                foot: torch.Tensor | None = None, plan=None) -> torch.Tensor:
    """dm/dt + v . grad m = 0, m(0) = m0; returns the trajectory (nt+1, ...)."""
    if foot is None and plan is None:
        foot = footpoints(v, cfg, sign=1.0)
    if plan is None:
        plan = interp_plan(foot, cfg)
    traj = [m0]
    m = m0
    for _ in range(cfg.nt):
        m = _sl.sl_step(m, foot, cfg.interp, cfg.weight_dtype, plan=plan,
                        shard=cfg.shard)
        traj.append(m)
    return torch.stack(traj)


def solve_adjoint(lam1: torch.Tensor, v: torch.Tensor, cfg: TransportConfig,
                  foot_adj: torch.Tensor | None = None,
                  divv: torch.Tensor | None = None, plan_adj=None) -> torch.Tensor:
    """-dl/dt - div(l v) = 0, l(1) = lam1, solved in reversed pseudo-time as
    SL advection along -v with source (div v) * l. Returns the trajectory in
    forward time order: traj[j] = lambda(t_j)."""
    if foot_adj is None and plan_adj is None:
        foot_adj = footpoints(v, cfg, sign=-1.0)
    if plan_adj is None:
        plan_adj = interp_plan(foot_adj, cfg)
    if divv is None:
        divv = _deriv.div(v, scheme=cfg.deriv, shard=cfg.shard)
    dt = _dt(cfg)
    traj_rev = [lam1]
    lam = lam1
    for _ in range(cfg.nt):
        src0 = divv * lam
        lam = _sl.sl_step_with_source(lam, src0, divv, foot_adj, dt, cfg.interp,
                                      cfg.weight_dtype, plan=plan_adj,
                                      shard=cfg.shard)
        traj_rev.append(lam)
    # traj_rev[j] = lambda at t_{nt-j}; reorder to forward time.
    return torch.stack(traj_rev[::-1])


def solve_inc_state(vt: torch.Tensor, v: torch.Tensor, m_traj: torch.Tensor,
                    cfg: TransportConfig, foot: torch.Tensor | None = None,
                    plan=None, grad_m_traj: torch.Tensor | None = None) -> torch.Tensor:
    """d mt/dt + v . grad mt = -vt . grad m, mt(0) = 0; returns mt(1).
    RK2 along characteristics: mt_{j+1} = mt_j(X) + dt/2 (s_j(X) + s_{j+1})."""
    if foot is None and plan is None:
        foot = footpoints(v, cfg, sign=1.0)
    if plan is None:
        plan = interp_plan(foot, cfg)
    dt = _dt(cfg)
    if grad_m_traj is None:
        # Plan-free path: the trajectory's gradients are recomputed per call.
        grad_m_traj = grad_traj(m_traj, cfg)
    sources = _ct.traj_sources(vt, grad_m_traj)
    mt = torch.zeros_like(m_traj[0])
    for j in range(cfg.nt):
        mt_adv, s0_adv = _sl.sl_step_many(torch.stack([mt, sources[j]]), foot,
                                          cfg.interp, cfg.weight_dtype, plan=plan,
                                          shard=cfg.shard)
        mt = mt_adv + 0.5 * dt * (s0_adv + sources[j + 1])
    return mt


def solve_inc_adjoint(mt1: torch.Tensor, v: torch.Tensor, cfg: TransportConfig,
                      foot_adj: torch.Tensor | None = None,
                      divv: torch.Tensor | None = None, plan_adj=None) -> torch.Tensor:
    """Incremental adjoint: the adjoint operator with lt(1) = -mt(1)."""
    return solve_adjoint(-mt1, v, cfg, foot_adj=foot_adj, divv=divv,
                         plan_adj=plan_adj)


def body_force(lam_traj: torch.Tensor, m_traj: torch.Tensor, cfg: TransportConfig,
               grad_m_traj: torch.Tensor | None = None,
               regop: Callable[[], torch.Tensor] | None = None) -> torch.Tensor:
    """Trapezoidal  int_0^1 lambda grad m dt  over the stored trajectories,
    plus ``regop()`` where given (the gradient's and the matvec's
    regularisation term A v). With cached trajectory gradients the term goes
    into the ``traj_body_force`` launch; gradients computed here (plan-free)
    are freed first and the term is added after it: A v's FFT temporaries
    beside them would raise a plan-free solve's peak memory."""
    lam = lam_traj.unbind(0)
    if grad_m_traj is not None:
        return _ct.traj_body_force(lam, grad_m_traj, _dt(cfg),
                                   a=None if regop is None else regop())
    body = _ct.traj_body_force(lam, grad_traj(m_traj, cfg), _dt(cfg))
    return body if regop is None else body.add_(regop())
