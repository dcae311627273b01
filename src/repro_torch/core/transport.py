"""Transport solves: state, adjoint, incremental state, incremental adjoint
(port of ``repro.core.transport``, plan path).

All four PDEs are solved with the semi-Lagrangian scheme of ``semilag``. The
velocity is stationary, so each solve's footpoints and interpolation plan are
built once and reused for all ``nt`` steps. ``lax.scan`` becomes a Python
loop over the steps.

Shapes: scalar fields (N1,N2,N3); trajectories (nt+1, N1,N2,N3); velocities
(3, N1,N2,N3).
"""

from __future__ import annotations

import dataclasses

import torch

from . import derivatives as _deriv
from . import semilag as _sl


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """Numerical knobs shared by all transport solves.

    interp           : "linear" | "cubic_lagrange" | "cubic_bspline"
    deriv            : "fd8" | "fft"
    nt               : number of SL time steps (paper default 4)
    use_plan         : must be True; the plan-free path is ROADMAP B4
    measure          : distance-measure spec (only "ssd" is ported; NCC/NGF
                       are ROADMAP A12)
    use_fused_matvec : run the PCG Hessian matvec through the fused
                       gather+epilogue kernel K3

    The JAX config's ``backend`` is dropped (kernels dispatch on the device of
    their tensors), and so are ``shard`` (the slab path is ROADMAP A18) and
    ``weight_dtype`` (plan weights are fp32; bf16 weights are ROADMAP A11).
    """

    interp: str = "cubic_bspline"
    deriv: str = "fd8"
    nt: int = 4
    use_plan: bool = True
    measure: object = "ssd"
    use_fused_matvec: bool = False


def _dt(cfg: TransportConfig) -> float:
    return 1.0 / float(cfg.nt)


def footpoints(v: torch.Tensor, cfg: TransportConfig, sign: float = 1.0) -> torch.Tensor:
    """Characteristic footpoints; sign=+1 for forward solves, -1 for
    backward (adjoint) solves."""
    return _sl.trace_characteristic(v, _dt(cfg), method=cfg.interp, sign=sign)


def interp_plan(foot: torch.Tensor, cfg: TransportConfig):
    """Interpolation plan for fixed footpoints."""
    if not cfg.use_plan:
        raise NotImplementedError(
            "use_plan=False is not ported yet (ROADMAP B4)")
    return _sl.build_plan(foot, cfg.interp, shape=foot.shape[-3:])


def grad_traj(m_traj: torch.Tensor, cfg: TransportConfig) -> torch.Tensor:
    """Spatial gradients of a trajectory, shape (nt+1, 3, N1, N2, N3): one
    batched derivative per axis over the whole stack."""
    return _deriv.grad(m_traj, scheme=cfg.deriv)


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
        m = _sl.sl_step(m, foot, cfg.interp, plan=plan)
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
        divv = _deriv.div(v, scheme=cfg.deriv)
    dt = _dt(cfg)
    traj_rev = [lam1]
    lam = lam1
    for _ in range(cfg.nt):
        src0 = divv * lam
        lam = _sl.sl_step_with_source(lam, src0, divv, foot_adj, dt, cfg.interp,
                                      plan=plan_adj)
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
        grad_m_traj = grad_traj(m_traj, cfg)
    sources = -torch.sum(vt[None] * grad_m_traj, dim=1)
    mt = torch.zeros_like(m_traj[0])
    for j in range(cfg.nt):
        mt_adv, s0_adv = _sl.sl_step_many(torch.stack([mt, sources[j]]), foot,
                                          cfg.interp, plan=plan)
        mt = mt_adv + 0.5 * dt * (s0_adv + sources[j + 1])
    return mt


def solve_inc_adjoint(mt1: torch.Tensor, v: torch.Tensor, cfg: TransportConfig,
                      foot_adj: torch.Tensor | None = None,
                      divv: torch.Tensor | None = None, plan_adj=None) -> torch.Tensor:
    """Incremental adjoint: the adjoint operator with lt(1) = -mt(1)."""
    return solve_adjoint(-mt1, v, cfg, foot_adj=foot_adj, divv=divv,
                         plan_adj=plan_adj)


def body_force(lam_traj: torch.Tensor, m_traj: torch.Tensor, cfg: TransportConfig,
               grad_m_traj: torch.Tensor | None = None) -> torch.Tensor:
    """Trapezoidal  int_0^1 lambda grad m dt  over the stored trajectories."""
    dt = _dt(cfg)
    nt1 = m_traj.shape[0]
    w = torch.full((nt1,), dt, dtype=m_traj.dtype, device=m_traj.device)
    w[0] = 0.5 * dt
    w[-1] = 0.5 * dt
    if grad_m_traj is None:
        grad_m_traj = grad_traj(m_traj, cfg)
    acc = torch.zeros((3,) + tuple(m_traj.shape[1:]), dtype=m_traj.dtype,
                      device=m_traj.device)
    for t in range(nt1):
        acc = acc + w[t] * lam_traj[t][None] * grad_m_traj[t]
    return acc
