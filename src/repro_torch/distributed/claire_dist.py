"""Slab-parallel registration (port of the slab parts of
``repro.distributed.claire_dist``).

One registration is spread over the ranks of a ``torch.distributed`` group:
fields are cut into x1 slabs, one per rank. JAX wraps its unmodified Newton
step in a ``shard_map`` and injects it into the outer driver; here every
rank runs the unmodified host loop of ``core.gauss_newton`` (SPMD) with a
``halo.ShardInfo`` in ``TransportConfig.shard``: FD8 and SL interpolation
exchange halos, spectral operators all-gather, inner products all-reduce.
Every host-side decision reads all-reduced scalars, so every rank takes the
same branch and issues the same collectives.

``ensemble_newton_step`` is the population-study step: one Newton step of
every pair of a batch, the pairs independent (JAX vmaps the single-pair
step; the port runs each pair's step in turn), with no collective.
``ensemble_shardings`` / ``slab_shardings`` give JAX's layouts of the
ensemble and the slab step as specs (``sharding.P``) over a mesh, and
``ensemble_input_specs`` / ``slab_input_specs`` their inputs' shapes.

``solve_slab`` solves one pair over a slab group. ``solve_ensemble_slab``
solves a batch over an (ensemble, slab) layout of ranks
(``group.ensemble_slab_groups``): the pairs are split over the ensemble
index, each share is solved by ``gauss_newton.solve_batch`` over its slab
group with the slab step (:func:`make_slab_step`), and the velocities and
per-pair results are gathered over both groups at the end.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..core import gauss_newton as _gn
from ..core import transport as _tr
from ..launch.mesh import axis_size
from ..models.api import TensorSpec
from . import group as _group
from . import halo as _halo
from .sharding import P


# ---------------------------------------------------------------------------
# Ensemble (population study) parallelism
# ---------------------------------------------------------------------------


def ensemble_newton_step(cfg: _tr.TransportConfig, gn: _gn.GNConfig):
    """The Newton step of a batch of independent pairs,
    ``step(m0, m1, v, beta, gamma, eta)``: ``m0, m1`` ``(B, N1, N2, N3)``,
    ``v`` ``(B, 3, N1, N2, N3)``, ``beta, gamma, eta`` shared scalars.
    Returns the stats stacked on a leading batch axis, every pair stepped
    (``gauss_newton._make_batch_step`` with every pair active): pair ``b``'s
    entries and ``v_new[b]`` are those of ``make_step`` on that pair alone."""
    bstep = _gn._make_batch_step(cfg, gn)

    def batch_step(m0, m1, v, beta, gamma, eta):
        if m0.dim() != 4 or tuple(m1.shape) != tuple(m0.shape):
            raise ValueError(f"expected batched images m0, m1 (B, N1, N2, N3) of one shape, "
                             f"got {tuple(m0.shape)} and {tuple(m1.shape)}")
        bsz = m0.shape[0]
        if tuple(v.shape) != (bsz, 3) + tuple(m0.shape[1:]):
            raise ValueError(f"expected velocities {(bsz, 3) + tuple(m0.shape[1:])}, "
                             f"got {tuple(v.shape)}")
        return bstep(m0, m1, v, beta, gamma, np.full(bsz, float(eta)),
                     np.ones(bsz, dtype=bool))

    return batch_step


def ensemble_shardings(mesh, batch: int):
    """(image spec, velocity spec) of the ensemble step: the pair axis over
    every mesh axis that divides it, in (pod, data, model) order (pairs need
    no communication, so ``model`` is free for them too)."""
    entry: tuple = ()
    size = 1
    for a in ("pod", "data", "model"):
        if a in mesh.axis_names and batch % (size * mesh.shape[a]) == 0:
            entry += (a,)
            size *= mesh.shape[a]
    # one axis is named alone, as JAX's PartitionSpec canonicalises it
    spec0 = (entry[0] if len(entry) == 1 else entry) if entry else None
    return P(spec0, None, None, None), P(spec0, None, None, None, None)


def ensemble_input_specs(grid_shape, batch: int):
    n1, n2, n3 = grid_shape
    f32 = torch.float32
    return dict(m0=TensorSpec((batch, n1, n2, n3), f32),
                m1=TensorSpec((batch, n1, n2, n3), f32),
                v=TensorSpec((batch, 3, n1, n2, n3), f32))


# ---------------------------------------------------------------------------
# Slab (grid) parallelism
# ---------------------------------------------------------------------------


def slab_shardings(mesh, grid_shape):
    """(image spec, velocity spec) of the slab step: x1 over ``model`` where
    it divides."""
    m = "model" if grid_shape[0] % axis_size(mesh, "model") == 0 else None
    return P(m, None, None), P(None, m, None, None)


def slab_input_specs(grid_shape):
    n1, n2, n3 = grid_shape
    f32 = torch.float32
    return dict(m0=TensorSpec((n1, n2, n3), f32), m1=TensorSpec((n1, n2, n3), f32),
                v=TensorSpec((3, n1, n2, n3), f32))


def slab_axis_name(mesh) -> str:
    """The mesh axis carrying the x1 slabs: ``slab`` if present, else
    ``model``, else the last axis."""
    for name in ("slab", "model"):
        if name in mesh.axis_names:
            return name
    return mesh.axis_names[-1]


def ensemble_axis_name(mesh):
    """The mesh axis over independent registrations: ``ensemble`` if
    present, else ``data``, else None (a pure slab mesh)."""
    for name in ("ensemble", "data"):
        if name in mesh.axis_names:
            return name
    return None


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


def make_slab_step(cfg: _tr.TransportConfig, gn: _gn.GNConfig, shard: _halo.ShardInfo):
    """The unmodified Newton step on this rank's slab: the slab semantics
    enter only through ``TransportConfig.shard``. Signature of
    ``gauss_newton.make_step``, so it goes into ``solve(step_fn=)`` and,
    through ``_make_batch_step(step_fn=)``, into ``solve_batch``."""
    return _gn.make_step(dataclasses.replace(cfg, shard=shard), gn)


#: JAX's name of the slab step (there GSPMD shards the single-pair step by
#: its inputs' shardings; here the shard enters through the config)
slab_newton_step = make_slab_step


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

    res = _gn.solve(local(m0), local(m1), cfg, gn, v0=local(v0), gnorm_ref=gnorm_ref,
                    eta0=eta0, verbose=verbose, step_fn=make_slab_step(cfg, gn, shard))
    return dataclasses.replace(res, v=_halo.gather_full(res.v, shard))


def _pad_history(history, length: int):
    """A share's history padded to ``length`` evaluations: a pair that has
    stopped repeats its last entry, no longer active (what the batched step
    reports for a frozen pair)."""
    if not history:
        return history
    last = dict(history[-1], active=np.zeros_like(history[-1]["active"]))
    return list(history) + [last] * (length - len(history))


def solve_ensemble_slab(m0: torch.Tensor, m1: torch.Tensor, cfg: _tr.TransportConfig,
                        gn: _gn.GNConfig = _gn.GNConfig(), *, groups=None, halo: int = 6,
                        compress: str = "none", v0: torch.Tensor | None = None,
                        gnorm_ref=None, verbose: bool = False) -> _gn.BatchGNResult:
    """A batch of registrations on an (ensemble, slab) layout of ranks:
    ``groups`` is a ``group.EnsembleSlabGroups``. Called on every rank with
    the *global* batch ``(B, N1, N2, N3)``; ensemble index e solves pairs
    ``e*B/E .. (e+1)*B/E - 1`` with ``solve_batch`` over its slab group, each
    pair's grid in x1 slabs. Returns the result of all B pairs on every rank:
    velocities gathered over the slab group, then over the ensemble group,
    and the per-pair counts and histories gathered over the ensemble group
    (a share that stopped early repeats its last entry, inactive).
    """
    if not isinstance(groups, _group.EnsembleSlabGroups):
        raise ValueError(f"the layout {groups!r} has no ensemble group; pass "
                         "repro_torch.distributed.group.ensemble_slab_groups(E, S)")
    if m0.ndim != 4:
        raise ValueError(f"expected batched images (B, N1, N2, N3), got {tuple(m0.shape)}")
    shard = _halo.ShardInfo.of_group(groups.slab, halo=halo, compress=compress)
    _validate_slab(tuple(m0.shape[1:]), shard.nshards, halo)
    bsz, n_e = m0.shape[0], groups.ensemble_size
    if bsz % n_e != 0:
        raise ValueError(f"batch {bsz} not divisible by the ensemble group's {n_e} ranks")
    e = dist.get_rank(groups.ensemble)
    per = bsz // n_e
    pairs = slice(e * per, (e + 1) * per)
    n_loc = m0.shape[1] // shard.nshards

    def local(f):
        return None if f is None else _halo.slice_local(f[pairs], n_loc, shard)

    ref = gnorm_ref
    if ref is not None and np.ndim(ref) > 0:
        ref = np.broadcast_to(np.asarray(ref, dtype=np.float64), (bsz,))[pairs]
    bstep = _gn._make_batch_step(cfg, gn, step_fn=make_slab_step(cfg, gn, shard))
    res = _gn.solve_batch(local(m0), local(m1), cfg, gn, v0=local(v0), gnorm_ref=ref,
                          verbose=verbose, step_fn=bstep)
    v_share = _halo.gather_full(res.v, shard)
    v_parts = [torch.empty_like(v_share) for _ in range(n_e)]
    dist.all_gather(v_parts, v_share.contiguous(), group=groups.ensemble)
    host = dataclasses.replace(res, v=None)
    shares = [None] * n_e
    dist.all_gather_object(shares, host, group=groups.ensemble)
    length = max(len(r.history) for r in shares)
    histories = [_pad_history(r.history, length) for r in shares]
    history = [{k: np.concatenate([h[i][k] for h in histories]) for k in histories[0][i]}
               for i in range(length)]

    def cat(field):
        return np.concatenate([getattr(r, field) for r in shares])

    return _gn.BatchGNResult(
        v=torch.cat(v_parts), iters=cat("iters"), matvecs=cat("matvecs"),
        gnorm0=cat("gnorm0"), gnorm=cat("gnorm"), rel_grad=cat("rel_grad"),
        converged=cat("converged"), history=history,
        wall_time_s=max(r.wall_time_s for r in shares))
