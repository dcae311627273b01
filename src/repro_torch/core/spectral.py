"""Spectral operators kept from CLAIRE (port of ``repro.core.spectral``):
the H1-div regularization operator A, its inverse (the preconditioner), the
Leray projection, the regularization energy and Gaussian smoothing.

Per wavenumber k:  Ahat(k) = beta*|k|^2 I3 + gamma k k^T, inverted in closed
form by Sherman–Morrison; the k=0 mode is zero for A and the identity for
A^-1. These run on ``torch.fft`` (cuFFT on the card) and need no hand
kernel, as the JAX package left them to XLA. The three components of a
vector field go through one batched ``rfftn`` over the trailing three axes.
"""

from __future__ import annotations

import torch

from . import grid as _grid

_DIMS = (-3, -2, -1)


def _khat(shape, device):
    """(ktilde, |k|^2, |ktilde|^2): ktilde are Nyquist-masked wavenumbers for
    the k k^T couplings, |k|^2 is unmasked for the Laplacian part."""
    k1, k2, k3 = _grid.wavenumbers(shape, rfft=True, device=device)
    m1, m2, m3 = _grid.zero_nyquist_mask(shape, rfft=True, device=device)
    kt = (k1 * m1, k2 * m2, k3 * m3)
    k2sum = k1 * k1 + k2 * k2 + k3 * k3
    kt2sum = kt[0] ** 2 + kt[1] ** 2 + kt[2] ** 2
    return kt, k2sum, kt2sum


def _vec_rfftn(v: torch.Tensor) -> torch.Tensor:
    return torch.fft.rfftn(v, dim=_DIMS)


def _vec_irfftn(vh: torch.Tensor, shape, dtype) -> torch.Tensor:
    return torch.fft.irfftn(vh, s=tuple(shape), dim=_DIMS).to(dtype)


def apply_regop(v: torch.Tensor, beta: float, gamma: float) -> torch.Tensor:
    """A v = beta*(-Lap) v + gamma * k (k . vhat)."""
    shape = tuple(v.shape[-3:])
    ks, k2, _ = _khat(shape, v.device)
    vh = _vec_rfftn(v)
    kdotv = ks[0] * vh[0] + ks[1] * vh[1] + ks[2] * vh[2]
    out = torch.stack([beta * k2 * vh[a] + gamma * ks[a] * kdotv for a in range(3)])
    return _vec_irfftn(out, shape, v.dtype)


def apply_inv_regop(v: torch.Tensor, beta: float, gamma: float,
                    zero_mean_identity: bool = True) -> torch.Tensor:
    """A^-1 v via Sherman–Morrison; the k=0 mode maps by the identity (or to
    zero with ``zero_mean_identity=False``)."""
    shape = tuple(v.shape[-3:])
    ks, k2, kt2 = _khat(shape, v.device)
    vh = _vec_rfftn(v)
    kdotv = ks[0] * vh[0] + ks[1] * vh[1] + ks[2] * vh[2]
    denom_lap = beta * k2
    safe_lap = torch.where(denom_lap > 0, denom_lap, 1.0)
    corr = gamma / torch.where(k2 > 0, beta * k2 + gamma * kt2, 1.0)
    outs = []
    for a in range(3):
        t = (vh[a] - corr * ks[a] * kdotv) / safe_lap
        t = torch.where(denom_lap > 0, t, vh[a] if zero_mean_identity
                        else torch.zeros_like(t))
        outs.append(t)
    return _vec_irfftn(torch.stack(outs), shape, v.dtype)


def leray_project(v: torch.Tensor) -> torch.Tensor:
    """P v = v - grad Lap^-1 div v  <=>  vhat - k (k.vhat) / |k|^2."""
    shape = tuple(v.shape[-3:])
    ks, _, kt2 = _khat(shape, v.device)
    vh = _vec_rfftn(v)
    kdotv = ks[0] * vh[0] + ks[1] * vh[1] + ks[2] * vh[2]
    inv_k2 = torch.where(kt2 > 0, 1.0 / torch.where(kt2 > 0, kt2, 1.0), 0.0)
    out = torch.stack([vh[a] - ks[a] * kdotv * inv_k2 for a in range(3)])
    return _vec_irfftn(out, shape, v.dtype)


def reg_energy(v: torch.Tensor, beta: float, gamma: float) -> torch.Tensor:
    """0.5 * <A v, v>."""
    av = apply_regop(v, beta, gamma)
    return 0.5 * _grid.inner(av, v, v.shape[-3:])


def gauss_smooth(f: torch.Tensor, sigma_vox: float) -> torch.Tensor:
    """Spectral Gaussian smoothing of a field or a stack of fields (unmasked
    wavenumbers); sigma in voxel units of axis 0."""
    shape = tuple(f.shape[-3:])
    k1, k2, k3 = _grid.wavenumbers(shape, rfft=True, device=f.device)
    h = _grid.spacing(shape)
    sig = sigma_vox * h[0]
    filt = torch.exp(-0.5 * (sig ** 2) * (k1 * k1 + k2 * k2 + k3 * k3))
    return torch.fft.irfftn(filt * torch.fft.rfftn(f, dim=_DIMS), s=shape,
                            dim=_DIMS).to(f.dtype)
