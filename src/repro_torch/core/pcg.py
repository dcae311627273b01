"""Preconditioned conjugate gradient for H vt = -g (port of
``repro.core.pcg``).

Preconditioner: the spectral inverse of the regularization operator,
(beta*A)^-1 with the identity on the zero mode. The JAX ``while_loop``
becomes a host loop; the stopping test (``rnorm > tol*bnorm``, fp32) and the
breakdown guards are the same, so the iteration counts match. With ``shard``
(slab-parallel solve) every inner product is all-reduced over the slab
group, so the stopping test reads the same scalars on every rank and every
rank runs the same number of iterations.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import torch

from .. import obs
from . import grid as _grid
from . import spectral as _spec


@dataclasses.dataclass
class PCGResult:
    x: torch.Tensor
    iters: int                # number of matvecs performed
    rel_residual: torch.Tensor


def solve(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
          precond: Callable[[torch.Tensor], torch.Tensor], tol: float,
          max_iters: int = 500, shard=None) -> PCGResult:
    """Solve  M^-1 H x = M^-1 b  to  ||r|| <= tol * ||b||  (L2 on the grid)."""
    with obs.span("pcg.solve"):
        inner = partial(_grid.inner, shape=b.shape[-3:], shard=shard)
        x = torch.zeros_like(b)
        r = b
        z = precond(r)
        p = z
        rz = inner(r, z)
        bnorm = torch.sqrt(inner(b, b))
        k = 0
        while obs.sync(bool, residual(r, inner) > tol * bnorm) and k < max_iters:
            with obs.span("pcg.matvec"):
                hp = matvec(p)
            x, r = update(x, r, p, hp, rz, inner)
            z = precond(r)
            p, rz = direction(r, z, p, rz, inner)
            k += 1
        rel = residual(r, inner) / torch.where(bnorm > 0, bnorm, 1.0)
        return PCGResult(x=x, iters=k, rel_residual=rel)


def residual(r: torch.Tensor, inner) -> torch.Tensor:
    return torch.sqrt(inner(r, r))


def update(x, r, p, hp, rz, inner):
    """An iteration's step along ``p`` given ``hp = H p``: the new ``x, r``."""
    php = inner(p, hp)
    # Guard against breakdown (H is SPD up to roundoff).
    alpha = rz / torch.where(php > 0, php, 1.0)
    alpha = torch.where(php > 0, alpha, 0.0)
    return x + alpha * p, r - alpha * hp


def direction(r, z, p, rz, inner):
    """An iteration's next search direction from ``z = M^-1 r``: the new
    ``p, rz``."""
    rz_new = inner(r, z)
    beta_cg = rz_new / torch.where(rz != 0.0, rz, 1.0)
    return z + beta_cg * p, rz_new


def make_reg_preconditioner(beta: float, gamma: float, shard=None
                            ) -> Callable[[torch.Tensor], torch.Tensor]:
    """(beta*A)^-1 spectral preconditioner."""

    def precond(r: torch.Tensor) -> torch.Tensor:
        return _spec.apply_inv_regop(r, beta, gamma, zero_mean_identity=True,
                                     shard=shard)

    return precond
