"""Periodic grid utilities (port of ``repro.core.grid``).

Omega = (0, 2*pi)^3 with periodic boundary conditions and N = (N1, N2, N3)
equispaced nodes, h_i = 2*pi / N_i. Scalar fields are ``(N1, N2, N3)``,
vector fields ``(3, N1, N2, N3)``, query points ``(3, ...)`` in index units.
The slab-sharded ``shard=`` arguments of the JAX package are not ported
(ROADMAP A18).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

TWO_PI = 2.0 * math.pi


def spacing(shape: Sequence[int]) -> Tuple[float, float, float]:
    """Grid spacing h_i = 2*pi / N_i."""
    return tuple(TWO_PI / float(n) for n in shape)


def cell_volume(shape: Sequence[int]) -> float:
    h = spacing(shape)
    return h[0] * h[1] * h[2]


def coords(shape: Sequence[int], dtype=torch.float32, device=None) -> torch.Tensor:
    """Physical coordinates, shape (3, N1, N2, N3)."""
    h = spacing(shape)
    axes = [torch.arange(n, dtype=dtype, device=device) * h[i]
            for i, n in enumerate(shape)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=0)


def index_coords(shape: Sequence[int], dtype=torch.float32, device=None) -> torch.Tensor:
    """Index-unit coordinates, shape (3, N1, N2, N3)."""
    axes = [torch.arange(n, dtype=dtype, device=device) for n in shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=0)


def inner(a: torch.Tensor, b: torch.Tensor, shape: Sequence[int] | None = None
          ) -> torch.Tensor:
    """Discrete L2 inner product with quadrature weight h1*h2*h3 (fp32 sum
    over all axes; scalar or vector fields)."""
    if shape is None:
        shape = a.shape[-3:]
    return cell_volume(shape) * torch.sum(a * b)


def norm_l2(a: torch.Tensor, shape: Sequence[int] | None = None) -> torch.Tensor:
    return torch.sqrt(inner(a, a, shape))


def wavenumbers(shape: Sequence[int], dtype=torch.float32, rfft: bool = True,
                device=None):
    """Integer wavenumbers (k1, k2, k3), broadcastable to the (r)fft output
    shape; with ``rfft`` the last axis uses rfft frequencies."""
    n1, n2, n3 = shape
    k1 = torch.fft.fftfreq(n1, d=1.0 / n1, device=device).to(dtype).reshape(n1, 1, 1)
    k2 = torch.fft.fftfreq(n2, d=1.0 / n2, device=device).to(dtype).reshape(1, n2, 1)
    if rfft:
        k3 = torch.fft.rfftfreq(n3, d=1.0 / n3, device=device).to(dtype).reshape(
            1, 1, n3 // 2 + 1)
    else:
        k3 = torch.fft.fftfreq(n3, d=1.0 / n3, device=device).to(dtype).reshape(1, 1, n3)
    return k1, k2, k3


def zero_nyquist_mask(shape: Sequence[int], dtype=torch.float32, rfft: bool = True,
                      device=None):
    """Masks that zero the Nyquist modes (odd-order spectral derivatives on
    even grids: the i*k_nyq mode is sign-ambiguous)."""
    ks = wavenumbers(shape, dtype=dtype, rfft=rfft, device=device)
    masks = []
    for n, k in zip(shape, ks):
        nyq = (n % 2 == 0) & (torch.abs(k) == n // 2)
        masks.append(torch.where(nyq, 0.0, 1.0).to(dtype))
    return tuple(masks)
