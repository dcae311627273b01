"""The Hessian matvec's trajectory contractions: ``traj_source_kernel`` and
``traj_body_force_kernel`` (``csrc/contract.cu``).

They replace no TPU kernel: the JAX package writes both as einsums
(``"c...,tc...->t..."`` for the incremental state's sources, ``"t,t...,tc...->c..."``
for the trapezoid body force) that XLA fuses. Each wrapper dispatches on the
device of the trajectory gradients: a CPU tensor takes the plain PyTorch
version beside it, a CUDA tensor launches the kernel (or raises), a fake
tensor (the dry-run) takes ``counts.fake_launch``. On the card the kernels
equal the plain versions run there, bit for bit (the source's note says how).

Shapes: ``vt`` and ``a`` ``(3, *S)``, the trajectory gradients
``(nt+1, 3, *S)``, each of the ``nt + 1`` adjoint fields ``(*S)``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from . import _build
from . import counts

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "traj_source": (_P, _P, _P, _L, _I, _P),
    "traj_body_force": (ctypes.POINTER(_P), _P, _P, _P, _L, _I, _F, _F, _P),
}

#: nt + 1 at most on the card (``kMaxSlices`` of ``csrc/contract.cu``).
MAX_SLICES = 64
#: operations a point: per slice of the sources (3 products, 2 sums); per
#: slice of the body force (w lam, then a product and a sum per component);
#: the added ``a`` term per component
SOURCE_OPS, BODY_OPS, ADD_OPS = 5, 7, 3


def traj_sources_plain(vt: torch.Tensor, grad_m_traj: torch.Tensor) -> torch.Tensor:
    """Plain version: ``-vt . grad m_t`` for every slice ``t``, ``(nt+1, *S)``."""
    return -torch.sum(vt[None] * grad_m_traj, dim=1)


def traj_body_force_plain(lam: Sequence[torch.Tensor], grad_m_traj: torch.Tensor, dt: float,
                          a: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: ``a + sum_t w_t lam_t grad m_t`` with the trapezoid
    weights ``w_0 = w_nt = dt/2``, ``w_t = dt``, summed in ``t`` order;
    ``(3, *S)``."""
    nt1 = len(lam)
    w = torch.full((nt1,), dt, dtype=grad_m_traj.dtype, device=grad_m_traj.device)
    w[0] = 0.5 * dt
    w[-1] = 0.5 * dt
    acc = torch.zeros(grad_m_traj.shape[1:], dtype=grad_m_traj.dtype,
                      device=grad_m_traj.device)
    for t in range(nt1):
        acc = acc + w[t] * lam[t][None] * grad_m_traj[t]
    return acc if a is None else a + acc


def _check_grad(grad_m_traj: torch.Tensor):
    """The field shape ``S`` of trajectory gradients ``(nt+1, 3, *S)``."""
    if grad_m_traj.dim() < 3 or grad_m_traj.shape[1] != 3 or grad_m_traj.shape[0] < 1:
        raise ValueError(f"expected trajectory gradients (nt+1, 3, ...), got "
                         f"{tuple(grad_m_traj.shape)}")
    return tuple(grad_m_traj.shape[2:])


def _check_field(name: str, t: torch.Tensor, shape, ref: torch.Tensor) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"expected {name} of shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != ref.device:
        raise ValueError(f"{name} on {t.device}, the trajectory gradients on {ref.device}")


def _kernel_inputs(*tensors: torch.Tensor) -> None:
    """The kernels' demands on their inputs."""
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in tensors):
        raise ValueError("the contraction kernels take contiguous float32 tensors")


def _route(grad_m_traj: torch.Tensor, nt1: int) -> str:
    if counts.is_fake(grad_m_traj):
        return "fake"
    if grad_m_traj.device.type == "cpu":
        return "cpu"
    if grad_m_traj.device.type != "cuda":
        raise ValueError(f"the contraction kernels run on cpu or cuda tensors, got "
                         f"{grad_m_traj.device}")
    if nt1 > MAX_SLICES:
        raise ValueError(f"{nt1} time slices exceed the kernels' {MAX_SLICES}")
    return "cuda"


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def traj_sources(vt: torch.Tensor, grad_m_traj: torch.Tensor) -> torch.Tensor:
    """The incremental state's sources ``-vt . grad m_t``, ``(nt+1, *S)``,
    for ``vt`` ``(3, *S)`` and ``grad_m_traj`` ``(nt+1, 3, *S)``."""
    shape = _check_grad(grad_m_traj)
    _check_field("vt", vt, (3,) + shape, grad_m_traj)
    nt1 = grad_m_traj.shape[0]
    route = _route(grad_m_traj, nt1)
    if route == "cpu":
        counts.bump("plain:traj_source")
        return traj_sources_plain(vt, grad_m_traj)
    _kernel_inputs(vt, grad_m_traj)
    out = torch.empty((nt1,) + shape, dtype=torch.float32, device=grad_m_traj.device)
    m = math.prod(shape)
    if route == "fake":
        counts.fake_launch("traj_source", nt1 * m * SOURCE_OPS,
                           counts.nbytes(vt, grad_m_traj, out))
        return out
    lib = _build.library("contract", _SIGNATURES)
    with torch.cuda.device(grad_m_traj.device):
        rc = lib.traj_source(vt.data_ptr(), grad_m_traj.data_ptr(), out.data_ptr(), m, nt1,
                             _stream(grad_m_traj))
    _build.check(rc, "traj_source")
    counts.bump("traj_source")
    return out


def traj_body_force(lam: Sequence[torch.Tensor], grad_m_traj: torch.Tensor, dt: float,
                    a: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``a + int_0^1 lam grad m dt`` by the trapezoid rule over the ``nt + 1``
    slices, ``(3, *S)``: ``lam`` the adjoint fields in time order (separate
    tensors or the slices of a stack), ``grad_m_traj`` ``(nt+1, 3, *S)``,
    ``dt`` the time step, ``a`` ``(3, *S)`` or None."""
    shape = _check_grad(grad_m_traj)
    lam = list(lam)
    nt1 = grad_m_traj.shape[0]
    if len(lam) != nt1:
        raise ValueError(f"{len(lam)} adjoint fields for {nt1} gradient slices")
    for t in lam:
        _check_field("each adjoint field", t, shape, grad_m_traj)
    if a is not None:
        _check_field("a", a, (3,) + shape, grad_m_traj)
    route = _route(grad_m_traj, nt1)
    if route == "cpu":
        counts.bump("plain:traj_body_force")
        return traj_body_force_plain(lam, grad_m_traj, dt, a)
    extra = () if a is None else (a,)
    _kernel_inputs(grad_m_traj, *lam, *extra)
    out = torch.empty((3,) + shape, dtype=torch.float32, device=grad_m_traj.device)
    m = math.prod(shape)
    if route == "fake":
        counts.fake_launch("traj_body_force", m * (nt1 * BODY_OPS + len(extra) * ADD_OPS),
                           counts.nbytes(grad_m_traj, out, *lam, *extra))
        return out
    lib = _build.library("contract", _SIGNATURES)
    ptrs = (_P * nt1)(*[t.data_ptr() for t in lam])
    with torch.cuda.device(grad_m_traj.device):
        rc = lib.traj_body_force(ptrs, grad_m_traj.data_ptr(),
                                 None if a is None else a.data_ptr(), out.data_ptr(), m, nt1,
                                 0.5 * dt, dt, _stream(grad_m_traj))
    _build.check(rc, "traj_body_force")
    counts.bump("traj_body_force")
    return out
