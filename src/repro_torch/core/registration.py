"""Public registration API: ``register``, ``register_multires``,
``register_batch`` and the slab-parallel ``register_sharded`` (port of
``repro.core.registration``).

Variant tags follow the paper's Table 6:
    fft-cubic    : FFT first derivatives + cubic Lagrange interpolation
    fft-bspline  : FFT first derivatives + cubic B-spline interpolation
    fd8-cubic    : FD8 first derivatives + cubic B-spline interpolation
    fd8-lagrange : FD8 first derivatives + cubic Lagrange interpolation
    fd8-linear   : FD8 first derivatives + trilinear interpolation

The JAX ``backend=`` argument becomes ``device=``: the entry points run on
the card unless the caller passes ``device="cpu"``, and raise when the card
is asked for and absent. Every option of the JAX entry points runs:
``mixed_precision`` (bf16 interpolation weights), ``use_plan=False``
(plan-free interpolation, kernel K4), the measures ``"ssd" | "ncc" |
"ngf"``, batches (``register_batch``) and the ensemble x slab mode of
``register_sharded``, where a ``torch.distributed`` group layout takes the
place of the JAX mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import device as _device
from .. import obs
from ..distributed import claire_dist as _dist
from ..distributed import group as _group
from . import gauss_newton as _gn
from . import measures as _meas
from . import metrics as _metrics
from . import multires as _mr
from . import objective as _obj
from . import transport as _tr

#: The paper's Table 6 variant tags -> (deriv scheme, interpolation method).
VARIANTS: Dict[str, Dict[str, str]] = {
    "fft-cubic": dict(deriv="fft", interp="cubic_lagrange"),
    "fft-bspline": dict(deriv="fft", interp="cubic_bspline"),
    "fd8-cubic": dict(deriv="fd8", interp="cubic_bspline"),
    "fd8-lagrange": dict(deriv="fd8", interp="cubic_lagrange"),
    "fd8-linear": dict(deriv="fd8", interp="linear"),
}


def _score_single(m0, m1, v, cfg):
    """Post-solve quality metrics (warped image, rel. mismatch, det F)."""
    with obs.span("register.score"):
        m_warped = _metrics.warp_image(m0, v, cfg)
        mis = obs.sync(float, _obj.relative_mismatch(m_warped, m1, m0))
        detf = {k: obs.sync(float, val) for k, val in _metrics.detF_stats(v, cfg).items()}
        return m_warped, mis, detf


def _score_batch(m0, m1, v, cfg):
    """Post-solve metrics of every pair of a batch."""
    scores = [_score_single(m0[b], m1[b], v[b], cfg) for b in range(m0.shape[0])]
    return (torch.stack([s[0] for s in scores]), [s[1] for s in scores],
            [s[2] for s in scores])


@dataclasses.dataclass
class RegistrationResult:
    v: torch.Tensor                # stationary velocity field (3, N1, N2, N3)
    m_warped: torch.Tensor         # m0 transported to t=1
    mismatch_rel: float            # ||m(1)-m1|| / ||m1-m0||
    detF: Dict[str, float]         # min / mean / max of det(grad y)
    iters: int
    matvecs: int
    rel_grad: float
    converged: bool
    wall_time_s: float
    history: list


def make_transport_config(variant: str = "fd8-cubic", nt: int = 4,
                          mixed_precision: bool = False, use_plan: bool = True,
                          measure: object = "ssd",
                          use_fused_matvec: bool = False) -> _tr.TransportConfig:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; choose from {sorted(VARIANTS)}")
    _meas.resolve(measure)  # fail fast on unknown measures
    if use_fused_matvec and not use_plan:
        raise ValueError("use_fused_matvec requires use_plan=True (the fused "
                         "kernel consumes prebuilt interpolation plans)")
    sel = VARIANTS[variant]
    return _tr.TransportConfig(interp=sel["interp"], deriv=sel["deriv"], nt=nt,
                               weight_dtype=torch.bfloat16 if mixed_precision else None,
                               use_plan=use_plan, measure=measure,
                               use_fused_matvec=use_fused_matvec)


def register(
    m0,
    m1,
    variant: str = "fd8-cubic",
    beta: float = 5e-4,
    gamma: float = 1e-4,
    nt: int = 4,
    tol_rel_grad: float = 5e-2,
    max_newton: int = 50,
    continuation: bool = False,
    mixed_precision: bool = False,
    use_plan: bool = True,
    measure: object = "ssd",
    use_fused_matvec: bool = False,
    v0=None,
    gnorm_ref: Optional[float] = None,
    verbose: bool = False,
    device="cuda",
) -> RegistrationResult:
    """Register template ``m0`` to reference ``m1`` (paper eq. (1)).

    ``m0, m1`` (and ``v0``) are numpy arrays or tensors; they are moved to
    ``device`` as float32. Returns the stationary velocity ``v`` and the
    paper's quality metrics. Traced (``repro_torch.obs``), it is the span
    ``register``, the root of the registration's spans.
    """
    with obs.span("register"):
        dev = _device.resolve(device)
        cfg = make_transport_config(variant, nt=nt, mixed_precision=mixed_precision,
                                    use_plan=use_plan, measure=measure,
                                    use_fused_matvec=use_fused_matvec)
        with obs.span("register.h2d"):
            m0 = _device.as_tensor(m0, dev)
            m1 = _device.as_tensor(m1, dev)
            if v0 is not None:
                v0 = _device.as_tensor(v0, dev)
        gn_cfg = _gn.GNConfig(beta=beta, gamma=gamma, tol_rel_grad=tol_rel_grad,
                              max_newton=max_newton, continuation=continuation)
        res = _gn.solve(m0, m1, cfg, gn_cfg, v0=v0, gnorm_ref=gnorm_ref,
                        verbose=verbose)
        m_warped, mis, detf = _score_single(m0, m1, res.v, cfg)
        return RegistrationResult(
            v=res.v,
            m_warped=m_warped,
            mismatch_rel=mis,
            detF=detf,
            iters=res.iters,
            matvecs=res.matvecs,
            rel_grad=res.rel_grad,
            converged=res.converged,
            wall_time_s=res.wall_time_s,
            history=res.history,
        )


@dataclasses.dataclass
class MultiresRegistrationResult:
    v: torch.Tensor
    m_warped: torch.Tensor
    mismatch_rel: float
    detF: Dict[str, float]
    iters: int                      # Newton iterations summed over all levels
    fine_iters: int                 # Newton iterations on the finest grid only
    matvecs: int
    rel_grad: float
    converged: bool
    wall_time_s: float
    levels: List[Tuple[int, int, int]]
    level_results: list             # multires.LevelResult per level
    history: list


def register_multires(
    m0,
    m1,
    variant: str = "fd8-cubic",
    beta: float = 5e-4,
    gamma: float = 1e-4,
    nt: int = 4,
    tol_rel_grad: float = 5e-2,
    max_newton: int = 50,
    continuation: bool = False,
    levels: Optional[Sequence[Tuple[int, int, int]]] = None,
    n_levels: Optional[int] = None,
    min_size: int = 8,
    coarse_tol: Optional[float] = None,
    level_newton: Optional[Sequence[int]] = None,
    coarse_variant: Optional[str] = None,
    presmooth_sigma: float = 0.0,
    mixed_precision: bool = False,
    use_plan: bool = True,
    measure: object = "ssd",
    use_fused_matvec: bool = False,
    v0=None,
    gnorm_ref: Optional[float] = None,
    verbose: bool = False,
    device="cuda",
) -> MultiresRegistrationResult:
    """Coarse-to-fine registration (CLAIRE grid continuation).

    The pyramid is ``levels`` (coarsest first) or a halving schedule; each
    level warm-starts from the spectrally prolonged coarse velocity.
    ``coarse_variant`` selects a cheaper variant on all but the finest level.
    Inputs are moved to ``device`` as float32, as in :func:`register`.
    """
    dev = _device.resolve(device)
    cfg_kw = dict(nt=nt, mixed_precision=mixed_precision, use_plan=use_plan,
                  measure=measure, use_fused_matvec=use_fused_matvec)
    cfg = make_transport_config(variant, **cfg_kw)
    m0 = _device.as_tensor(m0, dev)
    m1 = _device.as_tensor(m1, dev)
    if v0 is not None:
        v0 = _device.as_tensor(v0, dev)
    gn_cfg = _gn.GNConfig(beta=beta, gamma=gamma, tol_rel_grad=tol_rel_grad,
                          max_newton=max_newton,
                          continuation=continuation)  # coarsest level only
    if levels is None:
        levels = _mr.default_level_shapes(m0.shape, n_levels=n_levels,
                                          min_size=min_size)
    level_cfgs = None
    if coarse_variant is not None:
        coarse_cfg = make_transport_config(coarse_variant, **cfg_kw)
        level_cfgs = [coarse_cfg] * (len(levels) - 1) + [cfg]
    res = _mr.solve_multires(m0, m1, cfg, gn_cfg, levels=levels, coarse_tol=coarse_tol,
                             level_newton=level_newton, level_cfgs=level_cfgs,
                             presmooth_sigma=presmooth_sigma, v0=v0,
                             gnorm_ref=gnorm_ref, verbose=verbose)
    m_warped, mis, detf = _score_single(m0, m1, res.v, cfg)
    return MultiresRegistrationResult(
        v=res.v,
        m_warped=m_warped,
        mismatch_rel=mis,
        detF=detf,
        iters=res.iters,
        fine_iters=res.fine_iters,
        matvecs=res.matvecs,
        rel_grad=res.rel_grad,
        converged=res.converged,
        wall_time_s=res.wall_time_s,
        levels=list(res.levels),
        level_results=list(res.level_results),
        history=res.history,
    )


@dataclasses.dataclass
class BatchRegistrationResult:
    v: torch.Tensor                # (B, 3, N1, N2, N3)
    m_warped: torch.Tensor         # (B, N1, N2, N3)
    mismatch_rel: List[float]      # per pair
    detF: List[Dict[str, float]]   # per pair
    iters: List[int]
    matvecs: List[int]
    rel_grad: List[float]
    converged: List[bool]
    wall_time_s: float
    history: list


def _batch_result(m0, m1, res, cfg) -> BatchRegistrationResult:
    m_warped, mis, detf = _score_batch(m0, m1, res.v, cfg)
    return BatchRegistrationResult(
        v=res.v, m_warped=m_warped, mismatch_rel=mis, detF=detf,
        iters=[int(i) for i in res.iters], matvecs=[int(m) for m in res.matvecs],
        rel_grad=[float(r) for r in res.rel_grad],
        converged=[bool(c) for c in res.converged], wall_time_s=res.wall_time_s,
        history=res.history)


def register_batch(
    m0,
    m1,
    variant: str = "fd8-cubic",
    beta: float = 5e-4,
    gamma: float = 1e-4,
    nt: int = 4,
    tol_rel_grad: float = 5e-2,
    max_newton: int = 50,
    mixed_precision: bool = False,
    use_plan: bool = True,
    measure: object = "ssd",
    use_fused_matvec: bool = False,
    v0=None,
    gnorm_ref=None,
    verbose: bool = False,
    donate: bool = False,
    device="cuda",
) -> BatchRegistrationResult:
    """Register a batch of pairs ``m0[b] -> m1[b]``, ``(B, N1, N2, N3)``.

    Per-pair convergence is masked (``gauss_newton.solve_batch``), so each
    pair's result is that of its own :func:`register` call. ``gnorm_ref`` is
    a scalar or per pair; ``donate=True`` runs the donating step (stopping
    test on the device in fp32, velocity updated in place, a ``v0`` on
    ``device`` consumed). Inputs are moved to ``device`` as float32.
    """
    dev = _device.resolve(device)
    cfg = make_transport_config(variant, nt=nt, mixed_precision=mixed_precision,
                                use_plan=use_plan, measure=measure,
                                use_fused_matvec=use_fused_matvec)
    m0 = _device.as_tensor(m0, dev)
    m1 = _device.as_tensor(m1, dev)
    if v0 is not None:
        v0 = _device.as_tensor(v0, dev)
    gn_cfg = _gn.GNConfig(beta=beta, gamma=gamma, tol_rel_grad=tol_rel_grad,
                          max_newton=max_newton)
    res = _gn.solve_batch(m0, m1, cfg, gn_cfg, v0=v0, gnorm_ref=gnorm_ref,
                          verbose=verbose, donate=donate)
    return _batch_result(m0, m1, res, cfg)


def _check_slab_group(group, dev: torch.device) -> None:
    """Raise without an initialised group, or when its backend does not suit
    the device (NCCL for ``cuda``, gloo for ``cpu``)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "register_sharded needs an initialised torch.distributed group on every "
            "rank (repro_torch.distributed.group.init_slab_group)")
    backend = dist.get_backend(group)
    want = "nccl" if dev.type == "cuda" else "gloo"
    if backend != want:
        raise RuntimeError(f"register_sharded on {dev.type} needs a {want} group, "
                           f"got {backend}")


def register_sharded(
    m0,
    m1,
    group=None,
    variant: str = "fd8-cubic",
    beta: float = 5e-4,
    gamma: float = 1e-4,
    nt: int = 4,
    tol_rel_grad: float = 5e-2,
    max_newton: int = 50,
    continuation: bool = False,
    halo: int = 6,
    multires: bool = False,
    levels: Optional[Sequence[Tuple[int, int, int]]] = None,
    n_levels: Optional[int] = None,
    min_size: int = 8,
    coarse_tol: Optional[float] = None,
    level_newton: Optional[Sequence[int]] = None,
    coarse_variant: Optional[str] = None,
    presmooth_sigma: float = 0.0,
    mixed_precision: bool = False,
    use_plan: bool = True,
    measure: object = "ssd",
    use_fused_matvec: bool = False,
    halo_compression: str = "none",
    v0=None,
    gnorm_ref=None,
    verbose: bool = False,
    device="cuda",
):
    """Register with the grid cut into x1 slabs over the ranks of ``group``
    (a ``torch.distributed`` group; None: the default one), or, for a batch,
    over an ensemble x slab layout (``group`` a
    ``repro_torch.distributed.group.EnsembleSlabGroups``).

    Called on every rank with the *global* images; each rank solves on its
    slab (``repro_torch.distributed.claire_dist.solve_slab``): FD8 and SL
    interpolation exchange halos, spectral operators all-gather, inner
    products all-reduce. With ``multires`` (or ``levels``) each level of the
    grid continuation is a slab solve again, restriction and prolongation
    run on the gathered fields. Returns what :func:`register` (or
    :func:`register_multires`) returns, with the gathered velocity and the
    same scores, on every rank.

    ``halo`` is the interpolation halo in voxels and a contract: each SL
    step's footpoint displacement along x1 stays within ``halo - 2``;
    footpoints past it are clamped to the exchanged slab. ``halo_compression
    ="int8"`` sends the halos as absmax int8. The group's backend must suit
    ``device``: NCCL on ``cuda``, gloo on ``cpu``.

    Batched (4D) images take the ensemble x slab mode
    (``claire_dist.solve_ensemble_slab``): the pairs are split over the
    ensemble groups, each pair's grid over a slab group, and every rank
    returns what :func:`register_batch` returns for all pairs. A plain group
    has no ensemble group and raises.
    """
    dev = _device.resolve(device)
    layout = group
    if isinstance(group, _group.EnsembleSlabGroups):
        group = group.slab
    _check_slab_group(group, dev)
    cfg_kw = dict(nt=nt, mixed_precision=mixed_precision, use_plan=use_plan,
                  measure=measure, use_fused_matvec=use_fused_matvec)
    cfg = make_transport_config(variant, **cfg_kw)
    m0 = _device.as_tensor(m0, dev)
    m1 = _device.as_tensor(m1, dev)
    if v0 is not None:
        v0 = _device.as_tensor(v0, dev)
    gn_cfg = _gn.GNConfig(beta=beta, gamma=gamma, tol_rel_grad=tol_rel_grad,
                          max_newton=max_newton, continuation=continuation)

    if m0.ndim == 4:
        if multires or levels is not None:
            raise ValueError("batched sharded registration has no multires mode")
        res = _dist.solve_ensemble_slab(m0, m1, cfg, gn_cfg, groups=layout, halo=halo,
                                        compress=halo_compression, v0=v0,
                                        gnorm_ref=gnorm_ref, verbose=verbose)
        return _batch_result(m0, m1, res, cfg)

    def solve_fn(m0_l, m1_l, cfg_l, gn_l, **kw):
        return _dist.solve_slab(m0_l, m1_l, cfg_l, gn_l, group=group, halo=halo,
                                compress=halo_compression, **kw)

    if not (multires or levels is not None):
        res = solve_fn(m0, m1, cfg, gn_cfg, v0=v0, gnorm_ref=gnorm_ref, verbose=verbose)
        m_warped, mis, detf = _score_single(m0, m1, res.v, cfg)
        return RegistrationResult(
            v=res.v, m_warped=m_warped, mismatch_rel=mis, detF=detf, iters=res.iters,
            matvecs=res.matvecs, rel_grad=res.rel_grad, converged=res.converged,
            wall_time_s=res.wall_time_s, history=res.history)

    if levels is None:
        levels = _mr.default_level_shapes(m0.shape, n_levels=n_levels, min_size=min_size)
    level_cfgs = None
    if coarse_variant is not None:
        coarse_cfg = make_transport_config(coarse_variant, **cfg_kw)
        level_cfgs = [coarse_cfg] * (len(levels) - 1) + [cfg]
    res = _mr.solve_multires(m0, m1, cfg, gn_cfg, levels=levels, coarse_tol=coarse_tol,
                             level_newton=level_newton, level_cfgs=level_cfgs,
                             presmooth_sigma=presmooth_sigma, v0=v0,
                             gnorm_ref=gnorm_ref, verbose=verbose, solve_fn=solve_fn)
    m_warped, mis, detf = _score_single(m0, m1, res.v, cfg)
    return MultiresRegistrationResult(
        v=res.v, m_warped=m_warped, mismatch_rel=mis, detF=detf, iters=res.iters,
        fine_iters=res.fine_iters, matvecs=res.matvecs, rel_grad=res.rel_grad,
        converged=res.converged, wall_time_s=res.wall_time_s, levels=list(res.levels),
        level_results=list(res.level_results), history=res.history)
