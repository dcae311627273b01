"""FD8 first derivative on the K1 stencil (port of ``repro.kernels.fd8``).

f'(x_i) ~ (1/h) sum_{k=1..4} c_k (f_{i+k} - f_{i-k}),  h = 2*pi / N_axis.
Leading dimensions are a batch: one launch differentiates a whole stack.
"""

from __future__ import annotations

import math

import torch

from .pencil import stencil_axis

FD8_COEFFS = (4.0 / 5.0, -1.0 / 5.0, 4.0 / 105.0, -1.0 / 280.0)

TWO_PI = 2.0 * math.pi


def fd8_partial(f: torch.Tensor, axis: int) -> torch.Tensor:
    """d f / d x_axis (axis 0..2 of the trailing three dimensions)."""
    h = TWO_PI / f.shape[f.dim() - 3 + axis]
    return stencil_axis(f, axis, FD8_COEFFS, symmetric=False, scale=1.0 / h)


def fd8_grad(f: torch.Tensor) -> torch.Tensor:
    """Gradient of a (stack of) scalar field(s): ``(..., 3, N1, N2, N3)``."""
    return torch.stack([fd8_partial(f, a) for a in range(3)], dim=-4)


def fd8_div(w: torch.Tensor) -> torch.Tensor:
    """Divergence of a vector field ``(3, N1, N2, N3)``."""
    return sum(fd8_partial(w[a].contiguous(), a) for a in range(3))
