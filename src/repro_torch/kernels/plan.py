"""The interpolation plan build: ``build_plan_kernel`` (``csrc/plan.cu``).

It replaces no TPU kernel: the JAX package's ``build_plan``
(``src/repro/core/interp.py:265``) is jnp that XLA fuses. The wrapper
dispatches on the device of the queries: a CPU tensor takes the plain
PyTorch version beside it, a CUDA tensor launches the kernel (or raises), a
fake tensor (the dry-run) takes ``counts.fake_launch``.

A plan is ``idx``: three int32 tensors ``(S, *out_shape)`` of per-axis flat
index contributions (periodic wrap or clamp and row strides baked in) and
``weights``: three ``(S, *out_shape)`` tensors, float32 or, with
``weight_dtype=torch.bfloat16``, bfloat16. On the card the kernel's plan is
the plain version's run there, bit for bit (the source's note says how).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from . import counts
from .interp3d import (_INT_MAX, BASES, QUERY_WEIGHT_OPS, _plain_suffix, _weight_route,
                       plan_weights)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"build_plan": (_P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _I, _I, _P)}


def build_plan_plain(q: torch.Tensor, method: str, weight_dtype, shape, wrap):
    """Plain version: ``(idx, weights)`` of the plan for ``q`` ``(3, *out)``
    on a field of ``shape``, each a tuple of three ``(S, *out)`` tensors."""
    support, base_offset = BASES[method].support, BASES[method].offset
    n1, n2, n3 = shape
    qf = torch.floor(q)
    t = q - qf
    # Footpoints are negative near the low edge: floor, then floor-mod.
    base = qf.to(torch.int32) + base_offset
    tap = torch.arange(support, dtype=torch.int32, device=q.device).reshape(
        (support,) + (1,) * (q.dim() - 1))

    def _tap_idx(b, n, do_wrap):
        i = b[None] + tap
        return torch.remainder(i, n) if do_wrap else torch.clamp(i, 0, n - 1)

    idx = (_tap_idx(base[0], n1, wrap[0]) * (n2 * n3),
           _tap_idx(base[1], n2, wrap[1]) * n3,
           _tap_idx(base[2], n3, wrap[2]))
    w = tuple(torch.stack(plan_weights(method, t[a], weight_dtype), dim=0)
              for a in range(3))
    return idx, w


def _check_args(q: torch.Tensor, method: str, shape) -> None:
    """What every route demands."""
    if method not in BASES:
        raise ValueError(f"unknown interpolation method: {method}")
    if q.dim() < 2 or q.shape[0] != 3:
        raise ValueError(f"expected query points (3, ...), got {tuple(q.shape)}")
    if len(shape) != 3 or min(shape) <= 0:
        raise ValueError(f"expected a field shape (N1, N2, N3), got {shape}")
    if math.prod(shape) > _INT_MAX:
        raise ValueError(f"field of {math.prod(shape)} points exceeds the plan's int32 "
                         "indices")


def _kernel_key(q: torch.Tensor, method: str, weight_dtype) -> str:
    """The kernel's demands on its inputs; its count key."""
    if q.dtype != torch.float32 or not q.is_contiguous():
        raise ValueError("build_plan kernel takes contiguous float32 query points")
    _, key_suffix = _weight_route(torch.float32 if weight_dtype is None else weight_dtype)
    return f"build_plan:{method}{key_suffix}"


def _empty_plan(q: torch.Tensor, support: int, weight_dtype):
    """The plan's six tensors, views of one index and one weight buffer."""
    shape = (3, support) + tuple(q.shape[1:])
    idx = torch.empty(shape, dtype=torch.int32, device=q.device)
    w = torch.empty(shape, dtype=weight_dtype or torch.float32, device=q.device)
    return idx, w


def build_plan(q: torch.Tensor, method: str, weight_dtype=None, shape=None,
               wrap=(True, True, True)):
    """``(idx, weights)`` of the plan for query points ``q`` ``(3, *out)``
    (index units) on a field of ``shape`` (default ``q.shape[1:]``): per axis
    a periodic wrap or, where ``wrap`` is False, a clamp into the field;
    ``weight_dtype`` None (fp32) or ``torch.bfloat16`` for the weights."""
    shape = tuple(int(n) for n in (shape if shape is not None else q.shape[1:]))
    _check_args(q, method, shape)
    support = BASES[method].support
    if counts.is_fake(q):
        key = _kernel_key(q, method, weight_dtype)
        idx, w = _empty_plan(q, support, weight_dtype)
        counts.fake_launch(key, q[0].numel() * QUERY_WEIGHT_OPS[method],
                           counts.nbytes(q, idx, w))
        return tuple(idx.unbind(0)), tuple(w.unbind(0))
    if q.device.type == "cpu":
        counts.bump(f"plain:build_plan:{method}{_plain_suffix(weight_dtype)}")
        return build_plan_plain(q, method, weight_dtype, shape, wrap)
    if q.device.type != "cuda":
        raise ValueError(f"build_plan runs on cpu or cuda tensors, got {q.device}")
    key = _kernel_key(q, method, weight_dtype)
    idx, w = _empty_plan(q, support, weight_dtype)
    lib = _build.library("plan", _SIGNATURES)
    with torch.cuda.device(q.device):
        rc = lib.build_plan(q.data_ptr(), idx.data_ptr(), w.data_ptr(), q[0].numel(),
                            *shape, BASES[method].selector,
                            int(w.dtype == torch.bfloat16),
                            sum(1 << a for a in range(3) if wrap[a]),
                            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "build_plan")
    counts.bump(key)
    return tuple(idx.unbind(0)), tuple(w.unbind(0))
