"""Gauss-Newton-Krylov driver, single pair (port of
``repro.core.gauss_newton``).

One Newton step: gradient evaluation (state + adjoint solves) -> PCG on
H vt = -g (preconditioner (beta*A)^-1, Eisenstat-Walker forcing) -> Armijo
backtracking line search -> v update. The JAX step is one jitted computation
with device while-loops; here PCG and the line search are host loops over
the same fp32 arithmetic, so the iteration counts match. The batched driver
is ROADMAP A14.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Dict, List

import numpy as np
import torch

from . import gradient as _grad
from . import grid as _grid
from . import hessian as _hess
from . import objective as _obj
from . import pcg as _pcg
from . import transport as _tr


@dataclasses.dataclass
class NewtonStepStats:
    v_new: torch.Tensor
    gnorm: torch.Tensor         # ||g(v)||_L2 at the incoming iterate
    j_total: torch.Tensor       # J(v) at the incoming iterate
    j_mismatch: torch.Tensor
    j_reg: torch.Tensor
    pcg_iters: int              # Hessian matvecs spent in PCG
    pcg_residual: torch.Tensor
    alpha: torch.Tensor         # accepted line-search step
    ls_evals: int               # objective evaluations in the line search


@dataclasses.dataclass(frozen=True)
class GNConfig:
    beta: float = 5e-4          # target regularization weight (paper default)
    gamma: float = 1e-4         # divergence penalty (paper default)
    tol_rel_grad: float = 5e-2  # relative gradient stopping tolerance
    max_newton: int = 50
    max_pcg: int = 500
    forcing_max: float = 0.5    # Eisenstat-Walker cap
    ls_max: int = 12            # Armijo backtracking trials
    ls_c1: float = 1e-4
    continuation: bool = False  # beta-continuation ladder (decade steps)
    beta_init: float = 1.0
    cont_reduce: float = 10.0
    cont_tol: float = 2.5e-1


def _f32(x: float) -> float:
    """Round a host scalar to fp32, as the JAX driver passes beta, gamma and
    eta to its step as ``jnp.float32``."""
    return float(np.float32(x))


def newton_step(m0: torch.Tensor, m1: torch.Tensor, v: torch.Tensor, beta: float,
                gamma: float, eta: float, cfg: _tr.TransportConfig,
                gn: GNConfig) -> NewtonStepStats:
    """One Newton step at ``v`` (``beta, gamma, eta`` rounded to fp32)."""
    beta, gamma, eta = _f32(beta), _f32(gamma), _f32(eta)
    gs = _grad.evaluate(m0, m1, v, beta, gamma, cfg)
    gnorm = _grid.norm_l2(gs.g)

    mv = partial(_hess.matvec, gs=gs, v=v, beta=beta, gamma=gamma, cfg=cfg)
    precond = _pcg.make_reg_preconditioner(beta, gamma)
    sol = _pcg.solve(mv, -gs.g, precond, tol=eta, max_iters=gn.max_pcg)
    vt = sol.x

    # Armijo backtracking: J(v + a*vt) <= J(v) + c1*a*<g, vt>.
    j0 = gs.j_mismatch + gs.j_reg
    gdotp = _grid.inner(gs.g, vt)

    def trial_obj(a):
        # The trial velocity moves the footpoints: solve_state builds one
        # plan per trial, shared by its nt SL steps.
        return _obj.objective(m0, m1, v + a * vt, beta, gamma, cfg)

    a = torch.tensor(1.0, dtype=v.dtype, device=v.device)
    j_trial = trial_obj(a)
    k = 0
    while bool(j_trial > j0 + gn.ls_c1 * a * gdotp) and k < gn.ls_max:
        a = 0.5 * a
        j_trial = trial_obj(a)
        k += 1
    # If the search direction failed entirely, fall back to a small
    # preconditioned gradient step (keeps the iteration alive).
    v_new = v + a * vt if k < gn.ls_max else v - 0.1 * precond(gs.g)
    return NewtonStepStats(
        v_new=v_new,
        gnorm=gnorm,
        j_total=j0,
        j_mismatch=gs.j_mismatch,
        j_reg=gs.j_reg,
        pcg_iters=sol.iters,
        pcg_residual=sol.rel_residual,
        alpha=a,
        ls_evals=k + 1,
    )


@dataclasses.dataclass
class GNResult:
    v: torch.Tensor
    iters: int
    matvecs: int
    gnorm0: float
    gnorm: float
    rel_grad: float
    converged: bool
    history: List[Dict[str, float]]
    wall_time_s: float


def solve(m0: torch.Tensor, m1: torch.Tensor, cfg: _tr.TransportConfig,
          gn: GNConfig = GNConfig(), v0: torch.Tensor | None = None,
          gnorm_ref: float | None = None, eta0: float | None = None,
          verbose: bool = False) -> GNResult:
    """Run the Gauss-Newton-Krylov solver g(v) = 0 for v.

    ``gnorm_ref`` fixes the reference of the relative-gradient stopping test
    (warm starts); ``eta0`` overrides the PCG forcing term of the first step.
    """
    shape = tuple(m0.shape)
    v = v0 if v0 is not None else torch.zeros((3,) + shape, dtype=m0.dtype,
                                              device=m0.device)

    if gn.continuation and gn.beta_init > gn.beta:
        betas = []
        b = gn.beta_init
        while b > gn.beta * (1.0 + 1e-12):
            betas.append(b)
            b /= gn.cont_reduce
        betas.append(gn.beta)
    else:
        betas = [gn.beta]

    history: List[Dict[str, float]] = []
    total_matvecs = 0
    total_iters = 0
    gnorm0_global = gnorm_ref
    gnorm_last = None
    t0 = time.perf_counter()

    for level, beta in enumerate(betas):
        is_target = level == len(betas) - 1
        tol = gn.tol_rel_grad if is_target else gn.cont_tol
        budget = gn.max_newton - total_iters if is_target else max(
            2, (gn.max_newton - total_iters) // 4)
        gnorm0_level = gnorm_ref
        prev_gnorm = None
        for _ in range(max(budget, 1)):
            # Eisenstat-Walker superlinear forcing: eta = min(cap, sqrt(g/g0)).
            if gnorm0_level is None or prev_gnorm is None:
                eta = min(gn.forcing_max, eta0) if eta0 is not None else gn.forcing_max
            else:
                eta = float(min(gn.forcing_max, (prev_gnorm / gnorm0_level) ** 0.5))
            stats = newton_step(m0, m1, v, beta, gn.gamma, eta, cfg, gn)
            gnorm = float(stats.gnorm)
            if gnorm0_level is None:
                gnorm0_level = gnorm
            if gnorm0_global is None:
                gnorm0_global = gnorm
            rel = gnorm / gnorm0_level if gnorm0_level > 0 else 0.0
            history.append(dict(
                level=level,
                beta=beta,
                gnorm=gnorm,
                rel_grad=rel,
                j=float(stats.j_total),
                j_mismatch=float(stats.j_mismatch),
                j_reg=float(stats.j_reg),
                pcg_iters=int(stats.pcg_iters),
                alpha=float(stats.alpha),
                ls_evals=int(stats.ls_evals),
            ))
            if verbose:
                h = history[-1]
                print(f"[GN] lvl={level} beta={beta:.1e} it={total_iters:3d} "
                      f"J={h['j']:.4e} mis={h['j_mismatch']:.4e} |g|rel={rel:.3e} "
                      f"pcg={h['pcg_iters']} a={h['alpha']:.3f}")
            gnorm_last = gnorm
            # The step's PCG ran whether or not the update is accepted.
            total_matvecs += int(stats.pcg_iters)
            if rel <= tol:
                break
            v = stats.v_new
            prev_gnorm = gnorm
            total_iters += 1
            if total_iters >= gn.max_newton:
                break
        if total_iters >= gn.max_newton:
            break

    rel_final = (gnorm_last / gnorm0_global
                 if (gnorm0_global and gnorm0_global > 0) else 0.0)
    return GNResult(
        v=v,
        iters=total_iters,
        matvecs=total_matvecs,
        gnorm0=gnorm0_global or 0.0,
        gnorm=gnorm_last or 0.0,
        rel_grad=rel_final,
        converged=rel_final <= gn.tol_rel_grad,
        history=history,
        wall_time_s=time.perf_counter() - t0,
    )
