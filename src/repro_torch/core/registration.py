"""Public registration API: ``register(m0, m1, ...)`` (port of
``repro.core.registration``, single pair).

Variant tags follow the paper's Table 6:
    fft-cubic    : FFT first derivatives + cubic Lagrange interpolation
    fft-bspline  : FFT first derivatives + cubic B-spline interpolation
    fd8-cubic    : FD8 first derivatives + cubic B-spline interpolation
    fd8-lagrange : FD8 first derivatives + cubic Lagrange interpolation
    fd8-linear   : FD8 first derivatives + trilinear interpolation

The JAX ``backend=`` argument becomes ``device=``: the entry point runs on
the card unless the caller passes ``device="cpu"``, and raises when the card
is asked for and absent. Not ported yet, and raising ``NotImplementedError``:
bf16 weights (``mixed_precision``, ROADMAP A11), ``use_plan=False`` (B4),
NCC/NGF (A12), multires (A13), batches (A14) and slab meshes (A18).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .. import device as _device
from . import gauss_newton as _gn
from . import measures as _meas
from . import metrics as _metrics
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
    m_warped = _metrics.warp_image(m0, v, cfg)
    mis = float(_obj.relative_mismatch(m_warped, m1, m0))
    detf = {k: float(val) for k, val in _metrics.detF_stats(v, cfg).items()}
    return m_warped, mis, detf


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
    _meas.resolve(measure)  # fail fast on unknown or unported measures
    if use_fused_matvec and not use_plan:
        raise ValueError("use_fused_matvec requires use_plan=True (the fused "
                         "kernel consumes prebuilt interpolation plans)")
    if not use_plan:
        raise NotImplementedError("use_plan=False is not ported yet (ROADMAP B4)")
    if mixed_precision:
        raise NotImplementedError(
            "bf16 interpolation weights (mixed_precision) are not ported yet "
            "(ROADMAP A11)")
    sel = VARIANTS[variant]
    return _tr.TransportConfig(interp=sel["interp"], deriv=sel["deriv"], nt=nt,
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
    paper's quality metrics.
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


def register_sharded(*args, **kwargs):
    """Slab-sharded registration over a device mesh (``mesh=``)."""
    raise NotImplementedError(
        "slab-sharded registration (mesh=) is not ported yet (ROADMAP A18)")
