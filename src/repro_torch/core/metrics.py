"""Registration quality metrics: warped image, det(grad y), Dice (port of
``repro.core.metrics``).

The deformation map y (m(x,1) = m0(y(x))) is the nt-fold composition of the
per-step footpoint map X, tracked as the periodic displacement
u_{j+1}(x) = u_j(X(x)) + (X(x) - x); F = I + grad(u) with FD8.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import derivatives as _deriv
from . import grid as _grid
from . import interp as _interp
from . import transport as _tr


def deformation_displacement(v: torch.Tensor, cfg: _tr.TransportConfig) -> torch.Tensor:
    """Displacement field u = y - x in physical units, shape (3, N1,N2,N3)."""
    shape = tuple(v.shape[-3:])
    foot = _tr.footpoints(v, cfg, sign=1.0)
    h = torch.tensor(_grid.spacing(shape), dtype=v.dtype,
                     device=v.device).reshape(3, 1, 1, 1)
    x_idx = _grid.index_coords(shape, dtype=v.dtype, device=v.device)
    step_disp = (foot - x_idx) * h
    # The JAX version rebuilds the same plan inside every step of its scan
    # (whatever ``use_plan`` says); the footpoints do not change, so it is
    # built once here.
    plan = _interp.build_plan(foot, method=cfg.interp, weight_dtype=cfg.weight_dtype,
                              shape=shape)
    u = torch.zeros_like(v)
    for _ in range(cfg.nt):
        u_coef = _interp.prefilter_for(u, cfg.interp)
        u = _interp.apply_plan(plan, u_coef) + step_disp
    return u


def det_deformation_gradient(v: torch.Tensor, cfg: _tr.TransportConfig) -> torch.Tensor:
    """det(F) with F = I + grad(u), pointwise on the grid."""
    u = deformation_displacement(v, cfg)
    # d[j][i] = d u_i / d x_j: one batched FD8 launch per axis.
    d = [_deriv.fd8_partial(u, j) for j in range(3)]
    f00, f01, f02 = 1.0 + d[0][0], d[1][0], d[2][0]
    f10, f11, f12 = d[0][1], 1.0 + d[1][1], d[2][1]
    f20, f21, f22 = d[0][2], d[1][2], 1.0 + d[2][2]
    return (f00 * (f11 * f22 - f12 * f21)
            - f01 * (f10 * f22 - f12 * f20)
            + f02 * (f10 * f21 - f11 * f20))


def detF_stats(v: torch.Tensor, cfg: _tr.TransportConfig) -> Dict[str, torch.Tensor]:
    dets = det_deformation_gradient(v, cfg)
    return dict(min=torch.min(dets), mean=torch.mean(dets), max=torch.max(dets))


def warp_image(m0: torch.Tensor, v: torch.Tensor, cfg: _tr.TransportConfig) -> torch.Tensor:
    """m(x,1) = m0(y(x)) via the SL state solve."""
    return _tr.solve_state(m0, v, cfg)[-1]


def warp_labels(labels: torch.Tensor, v: torch.Tensor,
                cfg: _tr.TransportConfig) -> torch.Tensor:
    """Warp a binary label mask: trilinear plan-free interpolation (K4, fp32
    weights) at y(x) = x + u(x), then a 0.5 threshold."""
    u = deformation_displacement(v, cfg)
    shape = tuple(labels.shape)
    h = torch.tensor(_grid.spacing(shape), dtype=u.dtype,
                     device=u.device).reshape(3, 1, 1, 1)
    q = _grid.index_coords(shape, dtype=u.dtype, device=u.device) + u / h
    warped = _interp.interp_linear(labels.to(torch.float32), q)
    return (warped >= 0.5).to(labels.dtype)


def dice(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dice overlap of two binary masks."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    inter = torch.sum(a * b)
    return 2.0 * inter / torch.clamp(torch.sum(a) + torch.sum(b), min=1.0)
