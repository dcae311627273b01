"""The facade solver: dispatches a problem to the right core driver (port of
``repro.api.solver``).

    from repro_torch import api
    problem = api.RegistrationProblem.synthetic(seed=0, grid=(64, 64, 64))
    result = api.Solver(api.SolverOptions(variant="fd8-cubic")).solve(problem)
    print(result.summary())
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

from .. import device as _device
from ..core import metrics as _metrics
from ..core import registration as _reg
from .options import SolverOptions, mesh_axis_sizes
from .problem import RegistrationProblem
from .result import Result


def _build_result(mode: str, problem: RegistrationProblem, res, mesh=None) -> Result:
    """Map a core registration result onto the facade :class:`Result` (one
    construction site per mode for the one-device and sharded paths)."""
    common = dict(
        mode=mode, grid=problem.grid, v=res.v, m_warped=res.m_warped,
        mismatch_rel=res.mismatch_rel, detF=res.detF,
        iters=res.iters, matvecs=res.matvecs, rel_grad=res.rel_grad,
        converged=res.converged, wall_time_s=res.wall_time_s, mesh=mesh,
    )
    if mode == "batch":
        return Result(batch=problem.batch_size, **common)
    if mode == "multires":
        return Result(levels=res.levels, fine_iters=res.fine_iters,
                      level_results=res.level_results, **common)
    return Result(**common)


@dataclass(frozen=True)
class Solver:
    options: SolverOptions = field(default_factory=SolverOptions)

    def solve(self, problem: RegistrationProblem) -> Result:
        o = self.options
        mode = o.resolve_mode(problem.is_batched, problem.grid)
        if mode == "batch" and o.continuation:
            raise ValueError("continuation is not supported with batched solving")
        if o.mesh is not None:
            return self._solve_sharded(problem, mode)
        common = dict(
            variant=o.variant, beta=o.beta, gamma=o.gamma, nt=o.nt,
            tol_rel_grad=o.tol_rel_grad, max_newton=o.max_newton,
            device=o.device, mixed_precision=o.mixed_precision,
            use_plan=o.use_plan, use_fused_matvec=o.use_fused_matvec,
            measure=o.measure, v0=o.v0, gnorm_ref=o.gnorm_ref, verbose=o.verbose,
        )
        if mode == "batch":
            res = _reg.register_batch(problem.m0, problem.m1, **common)
        elif mode == "multires":
            res = _reg.register_multires(
                problem.m0, problem.m1, continuation=o.continuation,
                levels=o.levels, n_levels=o.n_levels, min_size=o.min_size,
                coarse_tol=o.coarse_tol, level_newton=o.level_newton,
                coarse_variant=o.coarse_variant,
                presmooth_sigma=o.presmooth_sigma, **common)
        else:
            res = _reg.register(problem.m0, problem.m1, continuation=o.continuation,
                                **common)
        return self._with_dice(problem, _build_result(mode, problem, res))

    def _solve_sharded(self, problem: RegistrationProblem, mode: str) -> Result:
        """Slab-parallel solve: the resolved mode (single / multires / batch)
        runs under ``register_sharded`` on ``options.mesh``."""
        o = self.options
        common = dict(
            group=o.mesh, variant=o.variant, beta=o.beta, gamma=o.gamma,
            nt=o.nt, tol_rel_grad=o.tol_rel_grad, max_newton=o.max_newton,
            halo=o.halo, device=o.device, mixed_precision=o.mixed_precision,
            use_plan=o.use_plan, use_fused_matvec=o.use_fused_matvec,
            halo_compression=o.halo_compression, measure=o.measure, v0=o.v0,
            gnorm_ref=o.gnorm_ref, verbose=o.verbose,
        )
        if mode == "batch":
            res = _reg.register_sharded(problem.m0, problem.m1, **common)
        elif mode == "multires":
            res = _reg.register_sharded(
                problem.m0, problem.m1, continuation=o.continuation,
                multires=True, levels=o.levels, n_levels=o.n_levels,
                min_size=o.min_size, coarse_tol=o.coarse_tol,
                level_newton=o.level_newton, coarse_variant=o.coarse_variant,
                presmooth_sigma=o.presmooth_sigma, **common)
        else:
            res = _reg.register_sharded(problem.m0, problem.m1,
                                        continuation=o.continuation, **common)
        return self._with_dice(problem, _build_result(mode, problem, res,
                                                      mesh=mesh_axis_sizes(o.mesh)))

    def _with_dice(self, problem: RegistrationProblem, result: Result) -> Result:
        """Dice of the labels before and after: ``metrics.warp_labels``
        (trilinear, kernel K4 on the card) on the result's device."""
        if problem.labels0 is None or problem.labels1 is None:
            return result
        cfg = _reg.make_transport_config(self.options.variant, nt=self.options.nt,
                                         mixed_precision=self.options.mixed_precision)
        dev = result.v.device
        labels0 = _device.as_tensor(problem.labels0, dev)
        labels1 = _device.as_tensor(problem.labels1, dev)
        if problem.is_batched:
            before, after = [], []
            for b in range(problem.batch_size):
                before.append(float(_metrics.dice(labels0[b], labels1[b])))
                warped = _metrics.warp_labels(labels0[b], result.v[b], cfg)
                after.append(float(_metrics.dice(warped, labels1[b])))
        else:
            before = float(_metrics.dice(labels0, labels1))
            warped = _metrics.warp_labels(labels0, result.v, cfg)
            after = float(_metrics.dice(warped, labels1))
        return replace(result, dice_before=before, dice_after=after)


def solve(problem: RegistrationProblem, options: Optional[SolverOptions] = None) -> Result:
    """One-call convenience: ``api.solve(problem, options)``."""
    return Solver(options or SolverOptions()).solve(problem)
