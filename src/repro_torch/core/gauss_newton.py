"""Gauss-Newton-Krylov driver (port of ``repro.core.gauss_newton``).

One Newton step: gradient evaluation (state + adjoint solves) -> PCG on
H vt = -g (preconditioner (beta*A)^-1, Eisenstat-Walker forcing) -> Armijo
backtracking line search -> v update. The JAX step is one jitted computation
with device while-loops; here PCG and the line search are host loops over
the same fp32 arithmetic, so the iteration counts match.

``solve`` drives one pair; ``solve_batch`` drives B independent pairs with
per-pair convergence masks. JAX vmaps its step, and its masked while-loops
give every pair its own iteration counts; the port's batched step
(``_make_batch_step``) runs each still-active pair through the single-pair
step in turn, which gives the same counts, and does not step a pair that
has converged.

Slab-parallel solves (``cfg.shard`` set, ``repro_torch.distributed``) run
this same host loop on every rank of the slab group, SPMD, where JAX injects
its step into a ``shard_map``. Each host-side decision (the PCG stop, the
Armijo accept, the Newton stop) reads scalars that are all-reduced over the
group (or computed from gathered fields), which are the same on every rank,
so every rank takes the same branch and issues the same collectives.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from .. import obs
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
    gnorm = _grid.norm_l2(gs.g, shard=cfg.shard)

    mv = partial(_hess.matvec, gs=gs, v=v, beta=beta, gamma=gamma, cfg=cfg)
    precond = _pcg.make_reg_preconditioner(beta, gamma, shard=cfg.shard)
    sol = _pcg.solve(mv, -gs.g, precond, tol=eta, max_iters=gn.max_pcg,
                     shard=cfg.shard)
    vt = sol.x

    # Armijo backtracking: J(v + a*vt) <= J(v) + c1*a*<g, vt>.
    j0 = gs.j_mismatch + gs.j_reg
    gdotp = _grid.inner(gs.g, vt, shard=cfg.shard)

    def trial_obj(a):
        # The trial velocity moves the footpoints: solve_state builds one
        # plan per trial, shared by its nt SL steps.
        return _obj.objective(m0, m1, v + a * vt, beta, gamma, cfg)

    with obs.span("gn.line_search"):
        a = torch.tensor(1.0, dtype=v.dtype, device=v.device)
        j_trial = trial_obj(a)
        k = 0
        while obs.sync(bool, j_trial > j0 + gn.ls_c1 * a * gdotp) and k < gn.ls_max:
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


def make_step(cfg: _tr.TransportConfig, gn: GNConfig) -> Callable[..., NewtonStepStats]:
    """The Newton step of one pair, ``step(m0, m1, v, beta, gamma, eta)``:
    the signature ``solve(step_fn=)`` takes."""
    return partial(newton_step, cfg=cfg, gn=gn)


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
          verbose: bool = False, step_fn=None) -> GNResult:
    """Run the Gauss-Newton-Krylov solver g(v) = 0 for v.

    ``gnorm_ref`` fixes the reference of the relative-gradient stopping test
    (warm starts); ``eta0`` overrides the PCG forcing term of the first step.
    ``step_fn`` replaces the Newton step (:func:`make_step`'s signature):
    the slab-parallel driver passes its slab step, so the outer iteration is
    shared between the single-device and the sharded solve.
    """
    shape = tuple(m0.shape)
    v = v0 if v0 is not None else torch.zeros((3,) + shape, dtype=m0.dtype,
                                              device=m0.device)
    if step_fn is None:
        step_fn = make_step(cfg, gn)

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
            # The step's span holds the driver's reads of its results: the
            # first of them waits for the step's last kernels.
            with obs.span("gn.step", step=len(history)):
                stats = step_fn(m0, m1, v, beta, gn.gamma, eta)
                gnorm = obs.sync(float, stats.gnorm)
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
                    j=obs.sync(float, stats.j_total),
                    j_mismatch=obs.sync(float, stats.j_mismatch),
                    j_reg=obs.sync(float, stats.j_reg),
                    pcg_iters=int(stats.pcg_iters),
                    alpha=obs.sync(float, stats.alpha),
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


# ---------------------------------------------------------------------------
# Batched driver: many image pairs, per-pair convergence (the population-study
# workload).
# ---------------------------------------------------------------------------

#: the per-pair scalars of a step, stacked to (B,) by the batched step
_SCALARS = ("gnorm", "j_total", "j_mismatch", "j_reg", "pcg_residual", "alpha")


def _stack_stats(rows: List[NewtonStepStats], v_new: torch.Tensor) -> NewtonStepStats:
    """Per-pair step stats stacked on a leading batch axis."""
    fields = {k: torch.stack([torch.as_tensor(getattr(r, k)) for r in rows])
              for k in _SCALARS}
    return NewtonStepStats(
        v_new=v_new, pcg_iters=torch.tensor([int(r.pcg_iters) for r in rows]),
        ls_evals=torch.tensor([int(r.ls_evals) for r in rows]), **fields)


def _row(stats: NewtonStepStats, b: int) -> NewtonStepStats:
    """Pair ``b``'s entries of batched stats (``v_new`` left out)."""
    return NewtonStepStats(
        v_new=None, pcg_iters=int(stats.pcg_iters[b]), ls_evals=int(stats.ls_evals[b]),
        **{k: getattr(stats, k)[b] for k in _SCALARS})


def _make_batch_step(cfg: _tr.TransportConfig, gn: GNConfig, donate: bool = False,
                     step_fn=None):
    """The Newton step over a leading batch axis.

    ``m0, m1`` are ``(B, N1, N2, N3)``, ``v`` is ``(B, 3, N1, N2, N3)``,
    ``eta`` and ``active`` are ``(B,)``; ``beta, gamma`` are shared. Each
    active pair runs ``step_fn`` (default :func:`make_step`) in turn. A pair
    that is not active is not stepped: its entries repeat those of ``prev``,
    the stats of the step before (JAX recomputes them at the frozen ``v``
    and the unchanged ``eta``, which gives the same numbers), and its
    velocity stays.

    ``donate=False``: ``step(m0, m1, v, beta, gamma, eta, active, prev)``
    returns the stacked stats with a new ``v_new``; the caller masks.

    ``donate=True``, the counterpart of JAX's buffer-donating step:
    ``step(m0, m1, v, beta, gamma, eta, gnorm_ref, active, prev)`` evaluates
    the relative-gradient test on the device in fp32 (``gnorm_ref`` entries
    that are not finite or ``<= 0`` fall back to this step's gradient norm),
    writes the new velocity into ``v`` in place for the pairs that advance
    and returns ``(stats, advance)`` with ``stats.v_new`` being ``v``.
    """
    step = step_fn if step_fn is not None else make_step(cfg, gn)

    def run(m0, m1, v, beta, gamma, eta, active, prev):
        rows, v_rows = [], []
        for b in range(m0.shape[0]):
            if active[b]:
                with obs.span("gn.step", lane=b):
                    rows.append(step(m0[b], m1[b], v[b], beta, gamma, float(eta[b])))
                v_rows.append(rows[-1].v_new)
            else:
                rows.append(_row(prev, b))
                v_rows.append(v[b])
        return rows, v_rows

    if not donate:
        def batch_step(m0, m1, v, beta, gamma, eta, active, prev=None):
            rows, v_rows = run(m0, m1, v, beta, gamma, eta, active, prev)
            return _stack_stats(rows, torch.stack(v_rows))

        return batch_step

    def donating_step(m0, m1, v, beta, gamma, eta, gnorm_ref, active, prev=None):
        rows, v_rows = run(m0, m1, v, beta, gamma, eta, active, prev)
        stats = _stack_stats(rows, v)
        ref = torch.as_tensor(gnorm_ref, dtype=torch.float32).to(stats.gnorm.device)
        act = torch.as_tensor(active, dtype=torch.bool).to(stats.gnorm.device)
        gnorm = stats.gnorm.to(torch.float32)
        use_ref = torch.isfinite(ref) & (ref > 0)
        gnorm0 = torch.where(use_ref, ref, gnorm)
        rel = torch.where(gnorm0 > 0, gnorm / gnorm0, 0.0)
        advance = act & (rel > gn.tol_rel_grad)
        for b, adv in enumerate(obs.sync(torch.Tensor.tolist, advance)):
            if adv:
                v[b].copy_(v_rows[b])
        return stats, advance

    return donating_step


@dataclasses.dataclass
class BatchGNResult:
    v: torch.Tensor                 # (B, 3, N1, N2, N3)
    iters: np.ndarray               # (B,) accepted Newton steps per pair
    matvecs: np.ndarray             # (B,) Hessian matvecs per pair
    gnorm0: np.ndarray              # (B,)
    gnorm: np.ndarray               # (B,) at the last evaluated iterate
    rel_grad: np.ndarray            # (B,)
    converged: np.ndarray           # (B,) bool
    history: List[Dict[str, np.ndarray]]   # per evaluation, per-pair arrays
    wall_time_s: float


def _host(x: torch.Tensor) -> np.ndarray:
    """A batch's per-pair numbers read to the host (a ``host.sync``)."""
    return obs.sync(lambda t: t.cpu().numpy(), x)


def solve_batch(m0: torch.Tensor, m1: torch.Tensor, cfg: _tr.TransportConfig,
                gn: GNConfig = GNConfig(), v0: torch.Tensor | None = None,
                gnorm_ref: Any | None = None, verbose: bool = False, step_fn=None,
                donate: bool = False) -> BatchGNResult:
    """Solve ``B`` independent registrations, ``m0, m1`` ``(B, N1, N2, N3)``.

    The outer loop mirrors :func:`solve` (Eisenstat-Walker forcing,
    relative-gradient stop) with per-pair state; converged pairs are frozen
    while the rest keep iterating, so each pair's counts and velocity are
    those of its own :func:`solve`.

    ``v0`` warm-starts, ``(B, 3, N1, N2, N3)``. ``gnorm_ref`` is the per-pair
    reference of the stopping test (a scalar or ``(B,)``); entries that are
    not finite or ``<= 0`` fall back to the pair's first gradient norm.

    ``donate=True`` runs the donating step (:func:`_make_batch_step`): the
    relative-gradient test runs on the device in fp32 and drives the
    bookkeeping, and the velocity is updated in place, so a caller's ``v0``
    is consumed. ``donate=False`` tests on the host in float64. A
    ``step_fn`` must be a batched step built with the same ``donate``.
    """
    if gn.continuation:
        raise ValueError("solve_batch does not support beta-continuation")
    if m0.ndim != 4:
        raise ValueError(f"expected batched images (B, N1, N2, N3), got {tuple(m0.shape)}")
    bsz = m0.shape[0]
    shape = tuple(m0.shape[1:])
    v = v0 if v0 is not None else torch.zeros((bsz, 3) + shape, dtype=m0.dtype,
                                              device=m0.device)
    bstep = step_fn if step_fn is not None else _make_batch_step(cfg, gn, donate=donate)

    active = np.ones(bsz, dtype=bool)
    ever_converged = np.zeros(bsz, dtype=bool)
    iters = np.zeros(bsz, dtype=np.int64)
    matvecs = np.zeros(bsz, dtype=np.int64)
    gnorm0 = None
    gnorm_last = np.zeros(bsz, dtype=np.float64)
    eta = np.full(bsz, gn.forcing_max, dtype=np.float64)
    history: List[Dict[str, np.ndarray]] = []
    stats = None
    t0 = time.perf_counter()

    for _ in range(gn.max_newton):
        if donate:
            # First step: the caller's reference (NaN where absent); the
            # device falls back to the observed gnorm, as the host does below.
            if gnorm0 is not None:
                ref_arg = gnorm0
            elif gnorm_ref is not None:
                ref_arg = np.broadcast_to(np.asarray(gnorm_ref, dtype=np.float64), (bsz,))
            else:
                ref_arg = np.full(bsz, np.nan)
            stats, adv_dev = bstep(m0, m1, v, gn.beta, gn.gamma, eta,
                                   np.asarray(ref_arg, dtype=np.float32), active, stats)
        else:
            stats = bstep(m0, m1, v, gn.beta, gn.gamma, eta, active, stats)
        gnorm = _host(stats.gnorm).astype(np.float64)
        if gnorm0 is None:
            gnorm0 = gnorm.copy()
            if gnorm_ref is not None:
                ref = np.broadcast_to(np.asarray(gnorm_ref, dtype=np.float64), (bsz,)).copy()
                use_ref = np.isfinite(ref) & (ref > 0)
                gnorm0 = np.where(use_ref, ref, gnorm0)
        rel = np.where(gnorm0 > 0, gnorm / np.where(gnorm0 > 0, gnorm0, 1.0), 0.0)
        gnorm_last = np.where(active, gnorm, gnorm_last)
        pcg = stats.pcg_iters.numpy().astype(np.int64)
        # Final-step PCG work counts, as in the unbatched accounting.
        matvecs += np.where(active, pcg, 0)
        if donate:
            # The device applied the freeze mask to v; mirror its decision.
            advance = _host(adv_dev).astype(bool) & active
            just_conv = active & ~advance
        else:
            just_conv = active & (rel <= gn.tol_rel_grad)
            advance = active & ~just_conv
            mask = torch.as_tensor(advance, device=v.device).reshape(
                (bsz,) + (1,) * (v.ndim - 1))
            v = torch.where(mask, stats.v_new, v)
        ever_converged |= just_conv
        iters += advance
        eta = np.where(
            advance,
            np.minimum(gn.forcing_max,
                       np.sqrt(np.maximum(gnorm, 0.0) / np.maximum(gnorm0, 1e-30))),
            eta)
        history.append(dict(
            gnorm=gnorm,
            rel_grad=rel,
            active=active.copy(),
            j=_host(stats.j_total).astype(np.float64),
            j_mismatch=_host(stats.j_mismatch).astype(np.float64),
            pcg_iters=pcg,
            alpha=_host(stats.alpha).astype(np.float64),
        ))
        if verbose:
            print(f"[GN-batch] it={len(history) - 1:3d} active={int(active.sum())} "
                  f"|g|rel={np.array2string(rel, precision=3)} pcg={pcg}")
        active = advance
        if not active.any():
            break

    rel_final = (np.where(gnorm0 > 0, gnorm_last / np.where(gnorm0 > 0, gnorm0, 1.0), 0.0)
                 if gnorm0 is not None else np.zeros(bsz))
    return BatchGNResult(
        v=v,
        iters=iters,
        matvecs=matvecs,
        gnorm0=gnorm0 if gnorm0 is not None else np.zeros(bsz),
        gnorm=gnorm_last,
        rel_grad=rel_final,
        converged=ever_converged | (rel_final <= gn.tol_rel_grad),
        history=history,
        wall_time_s=time.perf_counter() - t0,
    )
