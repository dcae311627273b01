"""Slab-parallel registration of one pair (port of the slab parts of
``repro.distributed.claire_dist``).

One registration is spread over the ranks of a ``torch.distributed`` group:
fields are cut into x1 slabs, one per rank. JAX wraps its unmodified Newton
step in a ``shard_map`` and injects it into the outer driver; here every
rank runs the unmodified host loop of ``core.gauss_newton`` (SPMD) with a
``halo.ShardInfo`` in ``TransportConfig.shard``: FD8 and SL interpolation
exchange halos, spectral operators all-gather, inner products all-reduce.
Every host-side decision reads all-reduced scalars, so every rank takes the
same branch and issues the same collectives.

The ensemble x slab mode (``solve_ensemble_slab``) needs the batched Newton
driver, which is not ported yet (ROADMAP A14).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import gauss_newton as _gn
from ..core import transport as _tr
from . import halo as _halo


def _validate_slab(shape, nshards: int, halo: int) -> None:
    if shape[0] % nshards != 0:
        raise ValueError(f"grid x1 extent {shape[0]} not divisible by the slab "
                         f"group's {nshards} ranks")
    if halo < 1:
        raise ValueError(f"halo must be >= 1, got {halo}")


def halo_sl_step(f: torch.Tensor, foot: torch.Tensor, group=None,
                 method: str = "cubic_bspline", halo: int = 8) -> torch.Tensor:
    """One SL advection step of this rank's slab ``f`` ``(N1/P, N2, N3)`` at
    its footpoints ``foot`` ``(3, N1/P, N2, N3)`` (global index units),
    with an explicit halo exchange on the x1 axis. Per-step displacement
    must satisfy ``|foot - x| <= halo - 2``.

    The B-spline prefilter is exact (the exchange covers the prefilter
    radius on top of the interpolation halo) and the gather goes through a
    plan built in the extended slab's frame, the path the slab solve reuses
    across SL steps and Hessian matvecs.
    """
    shard = _halo.ShardInfo.of_group(group, halo=halo)
    plan = _halo.build_plan(foot, method, None, shard)
    return _halo.apply_plan(plan, f, method, shard)


def solve_slab(m0: torch.Tensor, m1: torch.Tensor, cfg: _tr.TransportConfig,
               gn: _gn.GNConfig = _gn.GNConfig(), *, group=None, halo: int = 6,
               compress: str = "none", v0: torch.Tensor | None = None,
               gnorm_ref: float | None = None, eta0: float | None = None,
               verbose: bool = False) -> _gn.GNResult:
    """Gauss-Newton-Krylov solve of one pair, x1-sliced over ``group``.

    Called on every rank with the *global* images (and warm start ``v0``);
    each rank solves on its slab. Returns the result with the gathered
    (global) velocity on every rank. Matches ``gauss_newton.solve`` on one
    device to floating-point reduction noise.
    """
    shard = _halo.ShardInfo.of_group(group, halo=halo, compress=compress)
    _validate_slab(tuple(m0.shape), shard.nshards, halo)
    n_loc = m0.shape[0] // shard.nshards

    def local(f):
        return None if f is None else _halo.slice_local(f, n_loc, shard)

    res = _gn.solve(local(m0), local(m1), dataclasses.replace(cfg, shard=shard), gn,
                    v0=local(v0), gnorm_ref=gnorm_ref, eta0=eta0, verbose=verbose)
    return dataclasses.replace(res, v=_halo.gather_full(res.v, shard))
