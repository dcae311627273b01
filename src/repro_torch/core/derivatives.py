"""First-order differential operators: FD8 and FFT (port of
``repro.core.derivatives``).

FD8 runs on the K1 stencil kernel (``repro_torch.kernels.fd8``), which takes
its plain ``torch.roll`` version for CPU tensors. The JAX ``backend=`` switch
is gone: the device of the tensor decides. The spectral operators use
``torch.fft`` (cuFFT on the card), as the JAX package left them to XLA.
Every operator takes stacks: leading dimensions are a batch.
"""

from __future__ import annotations

import torch

from ..kernels import fd8 as _fd8
from . import grid as _grid

FD8_COEFFS = _fd8.FD8_COEFFS

_DIMS = (-3, -2, -1)

fd8_partial = _fd8.fd8_partial
fd8_grad = _fd8.fd8_grad
fd8_div = _fd8.fd8_div


def _spectral_setup(shape, device):
    ks = _grid.wavenumbers(shape, rfft=True, device=device)
    masks = _grid.zero_nyquist_mask(shape, rfft=True, device=device)
    return ks, masks


def spectral_partial(f: torch.Tensor, axis: int) -> torch.Tensor:
    shape = tuple(f.shape[-3:])
    ks, masks = _spectral_setup(shape, f.device)
    fh = torch.fft.rfftn(f, dim=_DIMS)
    out = torch.fft.irfftn(1j * ks[axis] * masks[axis] * fh, s=shape, dim=_DIMS)
    return out.to(f.dtype)


def spectral_grad(f: torch.Tensor) -> torch.Tensor:
    shape = tuple(f.shape[-3:])
    ks, masks = _spectral_setup(shape, f.device)
    fh = torch.fft.rfftn(f, dim=_DIMS)
    outs = [torch.fft.irfftn(1j * ks[a] * masks[a] * fh, s=shape, dim=_DIMS).to(f.dtype)
            for a in range(3)]
    return torch.stack(outs, dim=-4)


def spectral_div(w: torch.Tensor) -> torch.Tensor:
    shape = tuple(w.shape[-3:])
    ks, masks = _spectral_setup(shape, w.device)
    # complex64 accumulator, as the JAX operator keeps it.
    acc = torch.zeros((shape[0], shape[1], shape[2] // 2 + 1),
                      dtype=torch.complex64, device=w.device)
    for a in range(3):
        acc = acc + 1j * ks[a] * masks[a] * torch.fft.rfftn(w[a], dim=_DIMS)
    return torch.fft.irfftn(acc, s=shape, dim=_DIMS).to(w.dtype)


def grad(f: torch.Tensor, scheme: str = "fd8") -> torch.Tensor:
    if scheme == "fd8":
        return fd8_grad(f)
    if scheme == "fft":
        return spectral_grad(f)
    raise ValueError(f"unknown derivative scheme: {scheme}")


def div(w: torch.Tensor, scheme: str = "fd8") -> torch.Tensor:
    if scheme == "fd8":
        return fd8_div(w)
    if scheme == "fft":
        return spectral_div(w)
    raise ValueError(f"unknown derivative scheme: {scheme}")
