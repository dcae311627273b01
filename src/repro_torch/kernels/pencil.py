"""Periodic 1D stencil along one axis of a stack of 3D fields (kernel K1).

Port of ``repro.kernels.pencil.stencil_pencil``. ``stencil_axis`` dispatches
on the device of its input: a CPU tensor takes the plain ``torch.roll``
version below, a CUDA tensor launches ``csrc/pencil.cu`` (or raises). There
is no fallback from one to the other.
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


def stencil_axis(f: torch.Tensor, axis: int, taps: Sequence[float],
                 symmetric: bool, scale: float = 1.0) -> torch.Tensor:
    """Periodic stencil along ``axis`` (0..2 of the trailing three
    dimensions) of ``f``: ``(N1, N2, N3)`` or a stack ``(..., N1, N2, N3)``."""
    if f.dim() < 3:
        raise ValueError(f"expected (..., N1, N2, N3), got {tuple(f.shape)}")
    if axis not in (0, 1, 2):
        raise ValueError(f"axis must be 0, 1 or 2, got {axis}")
    if not 1 <= len(taps) <= MAX_TAPS:
        raise ValueError(f"stencil_axis takes 1..{MAX_TAPS} taps, got {len(taps)}")
    name = "stencil_axis:" + ("prefilter" if symmetric else "fd8")
    if f.device.type == "cpu":
        counts.bump("plain:" + name)
        return stencil_axis_plain(f, axis, taps, symmetric, scale)
    if f.device.type != "cuda":
        raise ValueError(f"stencil_axis runs on cpu or cuda tensors, got {f.device}")
    if f.dtype != torch.float32:
        raise TypeError(f"stencil_axis kernel takes float32, got {f.dtype}")
    if not f.is_contiguous():
        raise ValueError("stencil_axis kernel needs a contiguous tensor")
    n1, n2, n3 = f.shape[-3:]
    batch = f.numel() // max(n1 * n2 * n3, 1)
    out = torch.empty_like(f)
    lib = _build.library("pencil", _SIGNATURES)
    tap_arr = (ctypes.c_float * len(taps))(*[float(t) for t in taps])
    rc = lib.stencil_axis_f32(
        f.data_ptr(), out.data_ptr(), batch, n1, n2, n3, axis, tap_arr,
        len(taps), int(bool(symmetric)), float(scale),
        torch.cuda.current_stream(f.device).cuda_stream)
    _build.check(rc, "stencil_axis")
    counts.bump(name)
    return out
