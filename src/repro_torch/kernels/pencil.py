"""1D stencils along one axis of a stack of 3D fields: periodic (kernel K1)
and valid-mode on a halo-extended axis (kernel K5).

Ports of ``repro.kernels.pencil.stencil_pencil`` and
``stencil_pencil_valid``. ``stencil_axis`` and ``stencil_valid`` dispatch on
the device of their input: a CPU tensor takes the plain version beside the
wrapper, a CUDA tensor launches ``csrc/pencil.cu`` (or raises). There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build
from . import counts

MAX_TAPS = 8

_SIGNATURES = {
    "stencil_axis_f32": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p),
    "stencil_valid_f32": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p),
}


def stencil_axis_plain(f: torch.Tensor, axis: int, taps: Sequence[float],
                       symmetric: bool, scale: float = 1.0) -> torch.Tensor:
    """The kernel's arithmetic with ``torch.roll``; ``axis`` counts within the
    trailing three (field) dimensions, leading dimensions are a batch.

    ``symmetric``: taps (c0, c1, ..., cR), out = c0 f + sum c_k (f[+k] + f[-k]);
    otherwise taps (c1, ..., cR), out = sum c_k (f[+k] - f[-k]); times scale.
    """
    d = f.dim() - 3 + axis
    if symmetric:
        acc = taps[0] * f
        for k, c in enumerate(taps[1:], start=1):
            acc = acc + c * (torch.roll(f, -k, d) + torch.roll(f, k, d))
    else:
        acc = torch.zeros_like(f)
        for k, c in enumerate(taps, start=1):
            acc = acc + c * (torch.roll(f, -k, d) - torch.roll(f, k, d))
    return acc * scale


def _check_field(f: torch.Tensor, axis: int, taps: Sequence[float], what: str) -> None:
    if f.dim() < 3:
        raise ValueError(f"expected (..., N1, N2, N3), got {tuple(f.shape)}")
    if axis not in (0, 1, 2):
        raise ValueError(f"axis must be 0, 1 or 2, got {axis}")
    if not 1 <= len(taps) <= MAX_TAPS:
        raise ValueError(f"{what} takes 1..{MAX_TAPS} taps, got {len(taps)}")


def _check_kernel_field(f: torch.Tensor, what: str) -> None:
    """The kernel's own demands on its input (the CUDA and the fake route)."""
    if f.dtype != torch.float32:
        raise TypeError(f"{what} kernel takes float32, got {f.dtype}")
    if not f.is_contiguous():
        raise ValueError(f"{what} kernel needs a contiguous tensor")


def _check_cuda_field(f: torch.Tensor, what: str) -> None:
    if f.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {f.device}")
    _check_kernel_field(f, what)


def stencil_flops(n_out: int, n_taps: int, symmetric: bool) -> float:
    """Operations of one stencil pass: per output point a multiply-add a
    tap pair and the pair's add or subtract (symmetric: 3 n_taps - 1;
    antisymmetric with the scale: 3 n_taps + 1)."""
    return float(n_out) * (3 * n_taps - 1 if symmetric else 3 * n_taps + 1)


def stencil_axis(f: torch.Tensor, axis: int, taps: Sequence[float],
                 symmetric: bool, scale: float = 1.0) -> torch.Tensor:
    """Periodic stencil along ``axis`` (0..2 of the trailing three
    dimensions) of ``f``: ``(N1, N2, N3)`` or a stack ``(..., N1, N2, N3)``."""
    _check_field(f, axis, taps, "stencil_axis")
    name = "stencil_axis:" + ("prefilter" if symmetric else "fd8")
    if counts.is_fake(f):
        _check_kernel_field(f, "stencil_axis")
        counts.fake_launch(name, stencil_flops(f.numel(), len(taps), symmetric),
                           2 * counts.nbytes(f))
        return torch.empty_like(f)
    if f.device.type == "cpu":
        counts.bump("plain:" + name)
        return stencil_axis_plain(f, axis, taps, symmetric, scale)
    _check_cuda_field(f, "stencil_axis")
    n1, n2, n3 = f.shape[-3:]
    batch = f.numel() // max(n1 * n2 * n3, 1)
    out = torch.empty_like(f)
    lib = _build.library("pencil", _SIGNATURES)
    tap_arr = (ctypes.c_float * len(taps))(*[float(t) for t in taps])
    with torch.cuda.device(f.device):
        rc = lib.stencil_axis_f32(
            f.data_ptr(), out.data_ptr(), batch, n1, n2, n3, axis, tap_arr,
            len(taps), int(bool(symmetric)), float(scale),
            torch.cuda.current_stream(f.device).cuda_stream)
    _build.check(rc, "stencil_axis")
    counts.bump(name)
    return out


def stencil_valid_plain(f: torch.Tensor, axis: int, taps: Sequence[float],
                        scale: float = 1.0) -> torch.Tensor:
    """The kernel's arithmetic by slicing: taps (c1, ..., cR) along ``axis``
    (of the trailing three dimensions) of a field with n + 2R rows there,
    out = scale * sum_k c_k (f[i+R+k] - f[i+R-k]) with n rows, no wrap."""
    d = f.dim() - 3 + axis
    r = len(taps)
    n = f.shape[d] - 2 * r
    acc = torch.zeros_like(f.narrow(d, r, n))
    for k, c in enumerate(taps, start=1):
        acc = acc + c * (f.narrow(d, r + k, n) - f.narrow(d, r - k, n))
    return acc * scale


def stencil_valid(f: torch.Tensor, axis: int, taps: Sequence[float],
                  scale: float = 1.0) -> torch.Tensor:
    """Valid-mode antisymmetric stencil (kernel K5) along ``axis`` (0..2 of
    the trailing three dimensions) of a halo-extended field ``(..., N1, N2,
    N3)``: R = ``len(taps)`` rows of halo on each side of that axis are read
    and dropped, so the output is 2R rows shorter there."""
    _check_field(f, axis, taps, "stencil_valid")
    if f.shape[f.dim() - 3 + axis] <= 2 * len(taps):
        raise ValueError(f"axis {axis} of {tuple(f.shape)} is too short for "
                         f"radius {len(taps)}")
    out_shape = list(f.shape)
    out_shape[f.dim() - 3 + axis] -= 2 * len(taps)
    if counts.is_fake(f):
        _check_kernel_field(f, "stencil_valid")
        out = torch.empty(out_shape, dtype=f.dtype, device=f.device)
        counts.fake_launch("stencil_valid:fd8", stencil_flops(out.numel(), len(taps), False),
                           counts.nbytes(f, out))
        return out
    if f.device.type == "cpu":
        counts.bump("plain:stencil_valid:fd8")
        return stencil_valid_plain(f, axis, taps, scale)
    _check_cuda_field(f, "stencil_valid")
    n1, n2, n3 = f.shape[-3:]
    batch = f.numel() // (n1 * n2 * n3)
    out = torch.empty(out_shape, dtype=f.dtype, device=f.device)
    lib = _build.library("pencil", _SIGNATURES)
    tap_arr = (ctypes.c_float * len(taps))(*[float(t) for t in taps])
    with torch.cuda.device(f.device):
        rc = lib.stencil_valid_f32(
            f.data_ptr(), out.data_ptr(), batch, n1, n2, n3, axis, tap_arr,
            len(taps), float(scale), torch.cuda.current_stream(f.device).cuda_stream)
    _build.check(rc, "stencil_valid")
    counts.bump("stencil_valid:fd8")
    return out
