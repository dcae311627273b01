"""First-order (gradient descent) LDDMM baseline, the PyCA-like comparator of
the paper's Table 8 (port of ``repro.core.baseline_gd``).

The formulation and transport of the Gauss-Newton solver, with the update of
preconditioned steepest descent

    v <- v - eta * (beta*A)^-1 g(v)

(the smoothed, Sobolev gradient of PyCA-style codes), normalised to move at
most ``eta`` voxels, and halved when the objective does not decrease. No
Hessian solves. ``beta`` and ``gamma`` are rounded to fp32, as the JAX
package's jitted step takes them.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List

import torch

from . import gauss_newton as _gn
from . import gradient as _grad
from . import grid as _grid
from . import pcg as _pcg
from . import transport as _tr


@dataclasses.dataclass
class GDResult:
    v: torch.Tensor
    iters: int
    gnorm0: float
    gnorm: float
    rel_grad: float
    history: List[Dict[str, float]]
    wall_time_s: float


def solve(m0: torch.Tensor, m1: torch.Tensor, cfg: _tr.TransportConfig,
          beta: float = 5e-4, gamma: float = 1e-4, eta: float = 0.5,
          max_iters: int = 100, tol_rel_grad: float = 5e-2,
          v0: torch.Tensor | None = None, verbose: bool = False) -> GDResult:
    """Descend on J(v) from ``v0`` (zero) for at most ``max_iters``
    evaluations, until the gradient norm falls to ``tol_rel_grad`` of the
    first one. A rejected step (objective up, or not finite) reverts and
    halves the step; the history keeps the accepted evaluations."""
    beta, gamma = _gn._f32(beta), _gn._f32(gamma)
    v = v0 if v0 is not None else torch.zeros((3,) + tuple(m0.shape), dtype=m0.dtype,
                                              device=m0.device)
    precond = _pcg.make_reg_preconditioner(beta, gamma)
    h_min = min(2.0 * math.pi / n for n in v.shape[-3:])

    history: List[Dict[str, float]] = []
    gnorm0 = None
    gnorm = 0.0
    j_prev = None
    step = eta
    v_prev = v
    t0 = time.perf_counter()
    for k in range(max_iters):
        gs = _grad.evaluate(m0, m1, v, beta, gamma, cfg)
        gnorm = float(_grid.norm_l2(gs.g))
        j = float(gs.j_mismatch + gs.j_reg)
        if (j != j) or (j_prev is not None and j > j_prev):
            # the smoothed-gradient step overshot: revert and halve
            v = v_prev
            step *= 0.5
            if step < 1e-6:
                break
            continue
        if gnorm0 is None:
            gnorm0 = gnorm
        rel = gnorm / gnorm0 if gnorm0 > 0 else 0.0
        history.append(dict(iter=k, j=j, gnorm=gnorm, rel_grad=rel, eta=step))
        if verbose:
            print(f"[GD] it={k:3d} J={j:.4e} |g|rel={rel:.3e} eta={step:.3f}")
        if rel <= tol_rel_grad:
            break
        j_prev = j
        v_prev = v
        d = precond(gs.g)
        dmax = float(torch.max(torch.sqrt(torch.sum(d * d, dim=0))))
        v = v - (step * h_min / max(dmax, 1e-12)) * d
    rel_final = gnorm / gnorm0 if (gnorm0 and gnorm0 > 0) else 0.0
    return GDResult(v=v, iters=len(history), gnorm0=gnorm0 or 0.0, gnorm=gnorm,
                    rel_grad=rel_final, history=history,
                    wall_time_s=time.perf_counter() - t0)
