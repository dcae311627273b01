"""Multi-resolution (grid continuation): spectral restriction / prolongation
and the coarse-to-fine Gauss-Newton driver (port of ``repro.core.multires``).

The registration is solved on a pyramid of grids, coarsest first; each level
warm-starts from the spectrally prolonged velocity of the level below. The
transfers are FFT truncation / zero padding on ``torch.fft`` (cuFFT on the
card), with the Nyquist planes of the smaller grid zeroed so results stay
real. ``restrict(prolong(f))`` is the identity for coarse fields without
Nyquist content. The stopping test at warm levels is measured against the
coarsest level's initial gradient norm (``gnorm_ref``).

``solve_fn=`` replaces the per-level solver: the slab-parallel
``register_sharded`` passes one that cuts each level's (gathered) images
into slabs and solves the level slab-parallel, so restriction and
prolongation run on the gathered fields on every rank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import gauss_newton as _gn
from . import spectral as _spec
from . import transport as _tr

GridShape = Tuple[int, int, int]


# ---------------------------------------------------------------------------
# Spectral resampling
# ---------------------------------------------------------------------------


def _resample_full_axis(fh: torch.Tensor, n_out: int, axis: int) -> torch.Tensor:
    """Crop / zero-pad one full-FFT axis of a spectrum to ``n_out`` samples,
    keeping the low-frequency block without the smaller grid's Nyquist plane."""
    n_in = fh.shape[axis]
    if n_out == n_in:
        return fh
    n_small = min(n_in, n_out)
    kpos = (n_small + 1) // 2
    kneg = (n_small - 1) // 2
    pos = fh.narrow(axis, 0, kpos)
    mid_shape = list(fh.shape)
    mid_shape[axis] = n_out - kpos - kneg
    parts = [pos, torch.zeros(mid_shape, dtype=fh.dtype, device=fh.device)]
    if kneg > 0:
        parts.append(fh.narrow(axis, n_in - kneg, kneg))
    return torch.cat(parts, dim=axis)


def _resample_rfft_axis(fh: torch.Tensor, n_out: int, n_in: int,
                        axis: int = -1) -> torch.Tensor:
    """Crop / zero-pad the rfft (last) axis to the spectrum of ``n_out``
    samples (modes 0..kpos-1 survive; the Nyquist mode is dropped)."""
    if n_out == n_in:
        return fh
    kpos = (min(n_in, n_out) + 1) // 2
    kept = fh.narrow(axis, 0, min(kpos, fh.shape[axis]))
    pad_shape = list(fh.shape)
    pad_shape[axis] = n_out // 2 + 1 - kept.shape[axis]
    if pad_shape[axis] == 0:
        return kept
    return torch.cat([kept, torch.zeros(pad_shape, dtype=fh.dtype, device=fh.device)],
                     dim=axis)


def fourier_resample(f: torch.Tensor, shape_out: Sequence[int]) -> torch.Tensor:
    """Resample the trailing three axes of ``f`` to ``shape_out`` spectrally
    (scalar, vector or stacked fields); amplitude-preserving."""
    shape_in = tuple(int(n) for n in f.shape[-3:])
    shape_out = tuple(int(n) for n in shape_out)
    if shape_in == shape_out:
        return f
    dims = (-3, -2, -1)
    fh = torch.fft.rfftn(f, dim=dims)
    fh = _resample_full_axis(fh, shape_out[0], axis=f.dim() - 3)
    fh = _resample_full_axis(fh, shape_out[1], axis=f.dim() - 2)
    fh = _resample_rfft_axis(fh, shape_out[2], shape_in[2], axis=f.dim() - 1)
    scale = (shape_out[0] * shape_out[1] * shape_out[2]) / float(
        shape_in[0] * shape_in[1] * shape_in[2])
    out = torch.fft.irfftn(fh * scale, s=shape_out, dim=dims)
    return out.to(f.dtype)


def restrict(f: torch.Tensor, shape_coarse: Sequence[int]) -> torch.Tensor:
    """Spectral restriction (ideal low-pass + subsample) to a coarser grid."""
    return fourier_resample(f, shape_coarse)


def prolong(f: torch.Tensor, shape_fine: Sequence[int]) -> torch.Tensor:
    """Spectral prolongation (zero-padded FFT interpolation) to a finer grid."""
    return fourier_resample(f, shape_fine)


def default_level_shapes(shape: Sequence[int], n_levels: Optional[int] = None,
                         min_size: int = 8) -> List[GridShape]:
    """Halving pyramid, coarsest first, finest == ``shape``; stops when an
    axis would drop below ``min_size`` or after ``n_levels`` levels."""
    shape = tuple(int(n) for n in shape)
    levels: List[GridShape] = [shape]
    while (n_levels is None or len(levels) < n_levels) and \
            min(levels[-1]) // 2 >= min_size:
        levels.append(tuple(n // 2 for n in levels[-1]))
    levels.reverse()
    return levels


# ---------------------------------------------------------------------------
# Coarse-to-fine driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LevelResult:
    shape: GridShape
    iters: int
    matvecs: int
    rel_grad: float
    converged: bool
    wall_time_s: float


@dataclasses.dataclass
class MultiresResult:
    v: torch.Tensor                  # velocity on the finest grid
    levels: List[GridShape]
    level_results: List[LevelResult]
    iters: int                       # total Newton iterations (all levels)
    fine_iters: int                  # Newton iterations on the finest grid
    matvecs: int                     # total Hessian matvecs (all levels)
    rel_grad: float                  # final relative gradient (finest level)
    converged: bool
    history: List[Dict[str, float]]  # per-iteration records tagged with grid
    wall_time_s: float


def solve_multires(m0: torch.Tensor, m1: torch.Tensor, cfg: _tr.TransportConfig,
                   gn: _gn.GNConfig = _gn.GNConfig(),
                   levels: Optional[Sequence[GridShape]] = None,
                   coarse_tol: Optional[float] = None,
                   level_newton: Optional[Sequence[int]] = None,
                   level_cfgs: Optional[Sequence[_tr.TransportConfig]] = None,
                   level_weight_dtypes: Optional[Sequence] = None,
                   presmooth_sigma: float = 0.0, v0: torch.Tensor | None = None,
                   gnorm_ref: Optional[float] = None,
                   verbose: bool = False, solve_fn=None) -> MultiresResult:
    """Coarse-to-fine Gauss-Newton: solve each pyramid level, prolong, refine.

    levels              : grid shapes, coarsest first (default halving pyramid)
    coarse_tol          : relative-gradient tolerance on non-final levels
                          (default ``gn.tol_rel_grad``)
    level_newton        : per-level Newton budgets (default ``gn.max_newton``)
    level_cfgs          : per-level transport configs
    level_weight_dtypes : per-level interpolation weight dtypes layered on
                          ``cfg`` / ``level_cfgs`` (e.g. bf16 on coarse
                          levels, None = fp32 on the finest)
    presmooth_sigma     : Gaussian smoothing (voxels) of the images before
                          restriction
    v0                  : initial velocity on the finest grid, restricted to
                          warm-start the coarsest level
    gnorm_ref           : reference of the relative-gradient stopping test
                          (default: the coarsest level's initial gradient norm)
    solve_fn            : per-level solver with the signature of
                          ``gauss_newton.solve(m0, m1, cfg, gn, v0=, gnorm_ref=,
                          eta0=, verbose=)`` returning a result whose ``v`` is
                          the level's whole velocity (default: that function)
    """
    shape = tuple(int(n) for n in m0.shape)
    levels = [tuple(int(n) for n in s) for s in (levels or default_level_shapes(shape))]
    if levels[-1] != shape:
        raise ValueError(f"finest level {levels[-1]} must equal image shape {shape}")
    if level_newton is not None and len(level_newton) != len(levels):
        raise ValueError("level_newton must have one entry per level")
    if level_cfgs is not None and len(level_cfgs) != len(levels):
        raise ValueError("level_cfgs must have one entry per level")
    if level_weight_dtypes is not None:
        if len(level_weight_dtypes) != len(levels):
            raise ValueError("level_weight_dtypes must have one entry per level")
        base = list(level_cfgs) if level_cfgs is not None else [cfg] * len(levels)
        level_cfgs = [dataclasses.replace(c, weight_dtype=wd)
                      for c, wd in zip(base, level_weight_dtypes)]

    m0_s = _spec.gauss_smooth(m0, presmooth_sigma) if presmooth_sigma > 0 else m0
    m1_s = _spec.gauss_smooth(m1, presmooth_sigma) if presmooth_sigma > 0 else m1

    v = None
    level_results: List[LevelResult] = []
    history: List[Dict[str, float]] = []
    total_iters = 0
    total_matvecs = 0
    last: _gn.GNResult | None = None
    t0 = time.perf_counter()

    for li, lev in enumerate(levels):
        is_finest = li == len(levels) - 1
        if is_finest:
            m0_l, m1_l = m0, m1
        else:
            m0_l, m1_l = restrict(m0_s, lev), restrict(m1_s, lev)
        cfg_l = level_cfgs[li] if level_cfgs is not None else cfg
        tol_l = gn.tol_rel_grad if (is_finest or coarse_tol is None) else coarse_tol
        gn_l = dataclasses.replace(
            gn, tol_rel_grad=tol_l,
            max_newton=int(level_newton[li]) if level_newton is not None else gn.max_newton,
            continuation=gn.continuation and li == 0)
        if v is not None:
            v0_l = prolong(v, lev)
        elif v0 is not None:
            v0_l = fourier_resample(v0, lev)
        else:
            v0_l = None
        # First-step PCG forcing at warm levels: the coarse level's final
        # relative gradient is the best available Eisenstat-Walker estimate.
        eta0 = None
        if level_results:
            eta0 = min(gn.forcing_max, level_results[-1].rel_grad ** 0.5)
        if verbose:
            print(f"[multires] level {li}: {lev} (warm={'yes' if v0_l is not None else 'no'})")
        res = (solve_fn or _gn.solve)(m0_l, m1_l, cfg_l, gn_l, v0=v0_l,
                                      gnorm_ref=gnorm_ref, eta0=eta0, verbose=verbose)
        if gnorm_ref is None and res.gnorm0 > 0:
            gnorm_ref = res.gnorm0
        v = res.v
        last = res
        total_iters += res.iters
        total_matvecs += res.matvecs
        level_results.append(LevelResult(
            shape=lev, iters=res.iters, matvecs=res.matvecs, rel_grad=res.rel_grad,
            converged=res.converged, wall_time_s=res.wall_time_s))
        history.extend(dict(h, grid=lev) for h in res.history)

    return MultiresResult(
        v=v,
        levels=levels,
        level_results=level_results,
        iters=total_iters,
        fine_iters=level_results[-1].iters,
        matvecs=total_matvecs,
        rel_grad=last.rel_grad if last is not None else 0.0,
        converged=last.converged if last is not None else False,
        history=history,
        wall_time_s=time.perf_counter() - t0,
    )
